"""The model axis (W's 2N columns split over ranks) on every solver path of
the port: the CUDA kernel backend (its plain version on these CPU tensors),
the BPTT unroll and the direct adjoint, against the unsharded port step and
against the reference's sharded step (``tcgan_tpu.parallel`` on a 4 x 2
mesh of the 8-device virtual CPU mesh), on the reference's TINY shapes
(N=8, 2 stimuli, B=8, n_critic 2; ``tests/test_parallel.py:68-103``) and
the same replayed noise.

The port's sharded steps run on 4 gloo ranks as a 2 x 2 (batch x model)
mesh, spawned once for the module; a rank runs ``launch.sharded_step`` or a
function of ``torch_model_axis_ranks`` (torch only), never jax.

Paths: BPTT in float64 (seqlen 200, checkpoint chunk 100); the direct
adjoint in float64; the kernel in float32 at atol 1e-4, as the reference
runs its Pallas kernel (in float64 the reference's ``while_loop`` refuses
the kernel's float32 rates).

Tolerances:

- against the unsharded port step, the 2 x 2 test's of
  ``tests/test_torch_parallel.py``: d_loss (and the moment loss) rtol
  1e-6, generator parameters rtol 1e-6 (atol 1e-7), g_loss rtol 3e-2
  (``tests/test_parallel.py:90-103``); and the generator's first Adam
  moments (0.1 x the raw gradient, which the parameters after Adam's first
  step, about -lr * sign(g), cannot show), max |d mu| / max |mu| per
  parameter, as ``chip_smoke.py`` measures them: 1e-8 in float64, 1e-6 in
  float32 (MU_RTOL; a moment's small entries are sums that cancel, so
  an entrywise rtol would read the roundoff of its large ones);
- against the reference's sharded step: rtol 1e-4 on the losses and the
  parameters (``tests/test_parallel.py:57-65``), and 1e-4 of max |mu| on
  the first moments;
- the differentiable model-axis drive against unsharded autograd, float64:
  1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_model_axis_ranks as rank_fns
from tcgan_tpu import parallel as jpar
from tcgan_tpu.models import generator as jgen
from tcgan_tpu.models import wgan as jwgan
from tcgan_tpu.ops import ssn as jssn
from tcgan_torch import parallel as tpar
from tcgan_torch.models import generator as tgen
from tcgan_torch.models import moments as tmom
from tcgan_torch.models import wgan as twgan
from tcgan_torch.ops import euler, stimulus, weights
from tcgan_torch.ops import ssn as tssn
from tcgan_torch.parallel import launch
from test_torch_wgan import _adam_state, _close, _port_state, _replay_noise

F64 = torch.float64
SSN = dict(N=8, k=0.005, n=2.0, dt=0.001, max_iter=1000, atol=1e-5)
GEN = dict(bandwidths=(0.25, 1.0), contrasts=(5.0,), sample_sites=1)
WGAN = dict(critic_layers=(16,), batch_size=8, n_critic=2, n_critic0=2)
# path: (generator fields, SSN fields, dtype name); "pallas" is the port's
# "cuda" backend under the reference's name
PATHS = {
    "bptt": (dict(solver="bptt", bptt_checkpoint_chunk=100),
             dict(seqlen=200), "float64"),
    "direct": (dict(grad_method="direct"), {}, "float64"),
    "kernel": ({}, dict(backend="pallas", atol=1e-4), "float32"),
}
RANKS = 4
# the first moments against the unsharded port step, by dtype
MU_RTOL = {"float64": 1e-8, "float32": 1e-6}
# the drive's unit test: Euler steps, checkpoint chunk
DRIVE_STEPS, DRIVE_CHUNK = 20, 10


def _configs(name):
    gen_kw, ssn_kw, dt = PATHS[name]
    jg = jgen.GeneratorConfig(ssn=jssn.SSNConfig(**{**SSN, **ssn_kw}),
                              dtype=getattr(jnp, dt), **GEN, **gen_kw)
    tg = tgen.GeneratorConfig(ssn=tssn.SSNConfig(**{**SSN, **ssn_kw}),
                              dtype=getattr(torch, dt), **GEN, **gen_kw)
    return jwgan.WGANConfig(gen=jg, **WGAN), twgan.WGANConfig(gen=tg, **WGAN)


def _drive_problem():
    """W (3, 16, 16), a 2-row battery, random r0 and loss weights, f64."""
    cfg = tssn.SSNConfig(**SSN)
    gen = torch.Generator().manual_seed(5)
    gcfg = tgen.GeneratorConfig(ssn=cfg, dtype=F64, **GEN)
    x = cfg.site_pos(dtype=F64)
    J, D, S = tgen.param_values(gcfg, tgen.init_params(gcfg))
    W = weights.build_weight(J, D, S, torch.randn((3, 16, 16), generator=gen,
                                                  dtype=F64), x)
    I_ext = stimulus.stimulus_battery(GEN["bandwidths"], GEN["contrasts"], x,
                                      cfg.smoothness)
    r0 = torch.rand((3, 2, 16), generator=gen, dtype=F64)
    weight = torch.randn((3, 2, 16), generator=gen, dtype=F64)
    return cfg, W, I_ext, r0, weight


@pytest.fixture(scope="module")
def run():
    """The reference's 4 x 2 sharded step and the unsharded port step of
    each path, the unsharded moment-matching BPTT step and unroll
    gradient, and from one spawn of 4 ranks their 2 x 2 sharded twins."""
    key = jax.random.PRNGKey(3)
    mesh = jpar.make_mesh(n_batch=4, n_model=2)
    jstep = jpar.make_sharded_gan_step(jwgan.train_step_impl, mesh)
    out, calls = {}, []
    for name in PATHS:
        jcfg, tcfg = _configs(name)
        dt = PATHS[name][2]
        jstate = jwgan.init_state(jcfg)
        real = np.random.default_rng(1).normal(
            1.0, 0.1, (2, tcfg.critic_batch, tcfg.gen.tc_dim)).astype(dt)
        with jax.set_mesh(mesh):
            jsh = jstep(dataclasses.replace(jcfg, gen=dataclasses.replace(
                jcfg.gen, mesh_axis=jpar.BATCH_AXIS,
                model_axis=jpar.MODEL_AXIS)), 2, jstate, jnp.asarray(real),
                key)
            jax.block_until_ready(jsh)
        noise = _replay_noise(jcfg, 2, 0, key, dtype=getattr(jnp, dt))
        state = _port_state(jstate, tcfg, dtype=getattr(torch, dt))
        real = torch.from_numpy(real)
        out[name] = dict(jax=jsh, ref=twgan.train_step_impl(
            tcfg, 2, state, real, noise=noise))
        scfg = dataclasses.replace(
            tcfg, gen=tpar.with_mesh_axes(tcfg.gen, model=True))
        fn = rank_fns.counted_step if name == "kernel" \
            else launch.sharded_step
        calls.append((fn, ("gan", 2, 2, scfg, 2, state, real),
                      dict(noise=noise)))

    mg = tgen.GeneratorConfig(ssn=tssn.SSNConfig(**SSN, seqlen=200),
                              dtype=F64, solver="bptt",
                              bptt_checkpoint_chunk=100, **GEN)
    mcfg = tmom.MomentMatchingConfig(gen=mg, batch_size=8, lr=1e-2)
    mstate = tmom.init_state(mcfg)
    moments = (torch.ones(mg.tc_dim, dtype=F64),
               torch.eye(mg.tc_dim, dtype=F64))
    z = np.random.default_rng(2).standard_normal((8, 16, 16))
    out["mm"] = dict(ref=tmom.train_step_impl(mcfg, mstate, *moments, z=z))
    calls.append((launch.sharded_step, ("mm", 2, 2, dataclasses.replace(
        mcfg, gen=tpar.with_mesh_axes(mg, model=True)), mstate, *moments),
        dict(z=z)))

    cfg, W, I_ext, r0, weight = problem = _drive_problem()
    W, r0 = W.clone().requires_grad_(True), r0.clone().requires_grad_(True)
    res = euler.solve_dynamics(cfg, W, I_ext, r0=r0, seqlen=DRIVE_STEPS)
    out["drive"] = dict(ref=(res.r.detach(), *torch.autograd.grad(
        (weight * res.r).sum(), (r0, W))))
    calls.append((rank_fns.drive_grads, (*problem, DRIVE_STEPS, DRIVE_CHUNK),
                  {}))

    ranks = launch.spawn(launch.call_each, RANKS, (calls,), timeout=240,
                         deadline=360)
    for i, name in enumerate(list(PATHS) + ["mm", "drive"]):
        out[name]["ranks"] = [r[i] for r in ranks]
    return out


def _same_on_every_rank(results):
    """Rank 0's result, after checking every rank holds its parameters."""
    first = results[0]
    for r in results[1:]:
        for k, v in first[0].gen_params.items():
            np.testing.assert_array_equal(r[0].gen_params[k], v)
    return first


def _close_mu(mu, ref_mu, rtol):
    """Each parameter's first moment within ``rtol`` of its largest entry."""
    for k in ("J", "D", "S"):
        got, want = np.asarray(mu[k], np.float64), np.asarray(ref_mu[k],
                                                              np.float64)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= rtol, f"mu {k}: max |d mu| / max |mu| = {err:.3e}"


@pytest.mark.parametrize("path", sorted(PATHS))
def test_model_axis_step_matches_unsharded(run, path):
    """A 2 x 2 (batch x model) WGAN step on each path against the
    unsharded port step on the same noise, with the collectives of the
    path: the drive's all-reduce and the gather of r's cotangent (BPTT),
    one gather of W's columns per backward (direct), or, on the kernel,
    the circuits split over the model group: one row gather of each
    forward's outputs over it, no lockstep solve and no column gather."""
    state, m, counts = _same_on_every_rank(run[path]["ranks"])[:3]
    ref_state, ref_m = run[path]["ref"]
    assert state.step == 1
    _close(m.d_loss, ref_m.d_loss, 1e-6, what="d_loss")
    _close(m.g_loss, ref_m.g_loss, 3e-2, what="g_loss")
    for k in ("J", "D", "S"):
        _close(state.gen_params[k], ref_state.gen_params[k], 1e-6,
               atol=1e-7, what=k)
    _close_mu(state.gen_opt.mu, ref_state.gen_opt.mu,
              MU_RTOL[PATHS[path][2]])
    assert counts["gather_rows"] == 3 and counts["reduce_grad"] == 1
    if path == "bptt":
        assert counts["model_psum"] > 0 and counts["model_gather"] > 0
        assert "model_gather_W" not in counts
    elif path == "direct":
        assert counts["model_gather_W"] == 1 and "model_gather" not in counts
    else:
        assert counts["model_gather_rows"] == 3 and counts["adjoint_max"] > 0
        assert counts.keys() == {"gather_rows", "model_gather_rows",
                                 "reduce_grad", "adjoint_max"}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_model_axis_step_matches_jax_sharded_step(run, path):
    """The port's 2 x 2 step against the reference's 4 x 2 sharded step."""
    state, m = run[path]["ranks"][0][:2]
    jstate, jm = run[path]["jax"]
    for name in ("d_loss", "g_loss"):
        _close(getattr(m, name), getattr(jm, name), 1e-4, what=name)
    for k in ("J", "D", "S"):
        _close(state.gen_params[k], jstate.gen_params[k], 1e-4, atol=1e-6,
               what=k)
    _close_mu(state.gen_opt.mu, _adam_state(jstate.gen_opt)[1].mu, 1e-4)
    assert state.step == int(jstate.step) == 1


def test_model_axis_bptt_moment_matching_matches_unsharded(run):
    state, m, counts = _same_on_every_rank(run["mm"]["ranks"])
    ref_state, ref_m = run["mm"]["ref"]
    assert np.isfinite(m.loss) and state.step == 1
    _close(m.loss, ref_m.loss, 1e-6, what="loss")
    for k in ("J", "D", "S"):
        _close(state.gen_params[k], ref_state.gen_params[k], 1e-6,
               atol=1e-7, what=k)
    _close_mu(state.opt.mu, ref_state.opt.mu, MU_RTOL["float64"])
    assert counts["model_psum"] > 0 and counts["model_gather"] > 0


def test_model_drive_gradient_matches_unsharded_autograd(run):
    """The differentiable model-axis drive through a checkpointed unroll:
    rates, r0's gradient and each rank's columns of W's gradient equal
    unsharded autograd's; one all-reduce per Euler step forward and again
    in the recompute, one more for the final-state diagnostics, and one
    gather of r's cotangent per step in the backward."""
    r, g_r0, g_w = run["drive"]["ref"]
    n_cols = g_w.shape[-1] // 2
    for rates, got_r0, got_w, start, counts in run["drive"]["ranks"]:
        _close(rates, r, 1e-12, atol=1e-12, what="rates")
        _close(got_r0, g_r0, 1e-12, atol=1e-12, what="grad r0")
        _close(got_w, g_w[..., start:start + n_cols], 1e-12, atol=1e-12,
               what="grad W")
        assert counts == {"model_psum": 2 * DRIVE_STEPS + 1,
                          "model_gather": DRIVE_STEPS}


def test_kernel_under_model_axis_solves_each_ranks_share(run):
    """On the kernel backend each of the 4 ranks solves its model rank's
    half of its batch rank's 4 circuits: 2 circuits in each of the n_critic
    + 1 forward solves."""
    for result in run["kernel"]["ranks"]:
        assert result[3] == [WGAN["batch_size"] // RANKS] * 3
