"""Port parity for ``tcgan_torch.parallel`` (``torch.distributed`` ranks)
against the unsharded port step and against ``tcgan_tpu.parallel`` on the
8-device virtual CPU mesh, in f64 on the reference's TINY shapes (N=8,
max_iter 1000, 2 stimuli; ``tests/test_parallel.py``).

The sharded steps run on 4 gloo ranks, spawned once for the module
(``parallel.launch.spawn``: a fresh process per rank, one intra-op thread,
a ``file://`` rendezvous, a timeout on every collective and on the run);
what a rank runs is ``launch.sharded_step``, so no rank imports a test
module or jax.

Tolerances (the reference's, f64):

- a sharded WGAN step against the unsharded port step and against the
  reference's sharded step: rtol 1e-4 on the losses, the generator
  parameters and the first Adam moments (``tests/test_parallel.py:57``).
  The implicit adjoint's stop test takes its max over every rank's
  circuits, so the ranks stop where the unsharded batch does and the
  gradients agree to roundoff: the first Adam moments are held to rtol
  1e-8;
- the 2 x 2 (batch x model) step: d_loss and the parameters to rtol 1e-6
  (atol 1e-7), g_loss to 3e-2 (``tests/test_parallel.py:90-103``);
- members over ranks against the unsharded ensemble step: rtol 1e-10
  (``tests/test_ensemble.py:121-155``): members share nothing, so nothing
  changes but where each runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu import parallel as jpar
from tcgan_tpu.models import generator as jgen
from tcgan_tpu.models import wgan as jwgan
from tcgan_tpu.ops import ssn as jssn
from tcgan_torch import parallel as tpar
from tcgan_torch.entry import dryrun_multichip
from tcgan_torch.models import ensemble as tens
from tcgan_torch.models import generator as tgen
from tcgan_torch.models import moments as tmom
from tcgan_torch.models import wgan as twgan
from tcgan_torch.ops import ssn as tssn
from tcgan_torch.parallel import launch
from tcgan_torch.parallel import mesh as tmesh
from test_torch_wgan import _close, _port_state, _replay_noise

F64 = torch.float64
SSN = dict(N=8, k=0.005, n=2.0, dt=0.001, max_iter=1000, atol=1e-5)
GEN = dict(bandwidths=(0.25, 1.0), contrasts=(5.0,), sample_sites=1,
           solver="ift")
WGAN = dict(critic_layers=(16,), batch_size=8, n_critic=2, n_critic0=2)
TGEN = tgen.GeneratorConfig(ssn=tssn.SSNConfig(**SSN), dtype=F64, **GEN)
K = 8  # ensemble members, 2 per rank
RANKS = 4


def _t(x):
    return torch.tensor(np.array(x, copy=True), dtype=F64)


@pytest.fixture(scope="module")
def run():
    """The inputs, the unsharded port results, the reference's sharded
    step and, from one spawn of 4 ranks, the sharded port results."""
    jg = jgen.GeneratorConfig(ssn=jssn.SSNConfig(**SSN), dtype=jnp.float64,
                              **GEN)
    jcfg = jwgan.WGANConfig(gen=jg, **WGAN)
    tcfg = twgan.WGANConfig(gen=TGEN, **WGAN)
    jstate = jwgan.init_state(jcfg)
    key = jax.random.PRNGKey(3)
    real = np.random.default_rng(1).normal(
        1.0, 0.1, (2, tcfg.critic_batch, TGEN.tc_dim))
    noise = _replay_noise(jcfg, 2, 0, key)
    state = _port_state(jstate, tcfg)

    mesh = jpar.make_mesh(n_batch=8, n_model=1)
    step = jpar.make_sharded_gan_step(jwgan.train_step_impl, mesh)
    with jax.set_mesh(mesh):
        jax_state, jax_m = step(
            dataclasses.replace(jcfg, gen=dataclasses.replace(
                jg, mesh_axis=jpar.BATCH_AXIS)),
            2, jstate, jnp.asarray(real), key)
        jax.block_until_ready(jax_m)
    ref = twgan.train_step_impl(tcfg, 2, state, _t(real), noise=noise)

    mcfg = tmom.MomentMatchingConfig(gen=TGEN, batch_size=16, lr=1e-2)
    mstate = tmom.init_state(mcfg)
    moments = (torch.ones(TGEN.tc_dim, dtype=F64),
               torch.eye(TGEN.tc_dim, dtype=F64))
    z = np.random.default_rng(2).standard_normal((16, 16, 16))
    mm_ref = tmom.train_step_impl(mcfg, mstate, *moments, z=z)

    ecfg = twgan.WGANConfig(gen=TGEN, critic_layers=(8,), batch_size=2,
                            n_critic=2, n_critic0=2)
    gen = torch.Generator().manual_seed(0)
    states = tens.init_ensemble(ecfg, K, generator=gen, start_jitter=0.05)
    ereal = 1.0 + 0.1 * torch.randn((K, 2, ecfg.critic_batch, TGEN.tc_dim),
                                    generator=gen, dtype=F64)
    enoise = twgan.draw_step_noise(ecfg, 2, ereal.transpose(0, 1), gen)
    ens_ref = tens.ensemble_train_step(ecfg, 2, states, ereal, noise=enoise)

    def cfg(model=False):
        return dataclasses.replace(
            tcfg, gen=tpar.with_mesh_axes(TGEN, model=model))

    sharded = launch.sharded_step
    calls = [
        (sharded, ("gan", 4, 1, cfg(), 2, state, _t(real)),
         dict(noise=noise)),
        (sharded, ("gan", 2, 2, cfg(model=True), 2, state, _t(real)),
         dict(noise=noise)),
        (sharded, ("mm", 4, 1, dataclasses.replace(
            mcfg, gen=tpar.with_mesh_axes(TGEN)), mstate, *moments),
         dict(z=z)),
        (sharded, ("ensemble", 4, 1, ecfg, 2, states, ereal),
         dict(noise=enoise)),
    ]
    ranks = launch.spawn(launch.call_each, RANKS, (calls,), timeout=240,
                         deadline=360)
    return dict(ref=ref, jax=(jax_state, jax_m), mm_ref=mm_ref,
                ens_ref=ens_ref, ranks=ranks)


def _same_on_every_rank(ranks, i):
    """Result ``i`` of rank 0, after checking every rank holds the same."""
    first = ranks[0][i]
    for r in ranks[1:]:
        for k, v in first[0].gen_params.items():
            np.testing.assert_array_equal(r[i][0].gen_params[k], v)
    return first


def test_sharded_wgan_step_matches_unsharded(run):
    state, m, counts = _same_on_every_rank(run["ranks"], 0)
    ref_state, ref_m = run["ref"]
    for name in ("d_loss", "g_loss", "wasserstein", "gp", "rate_penalty",
                 "frac_converged", "mean_iters", "d_accuracy"):
        _close(getattr(m, name), getattr(ref_m, name), 1e-4, what=name)
    for k in ("J", "D", "S"):
        _close(state.gen_params[k], ref_state.gen_params[k], 1e-4,
               atol=1e-6, what=k)
        # the batch's stop test gives the unsharded gradient to f64
        # roundoff; a per-rank stop test misses this by orders of magnitude
        _close(state.gen_opt.mu[k], ref_state.gen_opt.mu[k], 1e-8,
               atol=1e-16, what=f"mu {k}")
    for k, v in ref_state.critic_params.items():
        _close(state.critic_params[k], v, 1e-4, atol=1e-8, what=k)
    # n_critic + 1 generator batches gathered, one gradient all-reduce,
    # and the adjoint's stop test over the batch: one all-reduce per
    # check-stride chunk, the chunk replayed up to the batch's stop
    assert counts["gather_rows"] == 3 and counts["reduce_grad"] == 1
    assert counts.keys() == {"gather_rows", "reduce_grad", "adjoint_max"}


def test_generator_gradient_not_scaled_by_ranks(run):
    """The first Adam moment is (1 - beta1) times the raw gradient (no
    clip): the sharded one equals the unsharded one, not 4 times it (the
    fault a sum over ranks in the gather's backward would make)."""
    state = run["ranks"][0][0][0]
    ref_state = run["ref"][0]
    for k in ("J", "D", "S"):
        ratio = state.gen_opt.mu[k] / ref_state.gen_opt.mu[k].numpy()
        np.testing.assert_allclose(ratio, 1.0, rtol=1e-4, err_msg=k)


def test_sharded_step_matches_jax_sharded_step(run):
    """The port's step on 4 ranks against the reference's
    ``make_sharded_gan_step`` on the 8-device mesh, same replayed noise."""
    state, m, _ = run["ranks"][0][0]
    jstate, jm = run["jax"]
    for name in ("d_loss", "g_loss"):
        _close(getattr(m, name), getattr(jm, name), 1e-4, what=name)
    for k in ("J", "D", "S"):
        _close(state.gen_params[k], jstate.gen_params[k], 1e-4, atol=1e-6,
               what=k)
    assert state.step == int(jstate.step) == 1


def test_sharded_with_model_axis_matches_single_device(run):
    """2 x 2 mesh: W's columns split over the model axis; the collectives
    of the sharded contraction are there (the twin of the reference's
    ``test_model_axis_contraction_actually_shards``)."""
    state, m, counts = _same_on_every_rank(run["ranks"], 1)
    ref_state, ref_m = run["ref"]
    assert state.step == 1
    _close(m.d_loss, ref_m.d_loss, 1e-6, what="d_loss")
    _close(m.g_loss, ref_m.g_loss, 3e-2, what="g_loss")
    for k in ("J", "D", "S"):
        _close(state.gen_params[k], ref_state.gen_params[k], 1e-6,
               atol=1e-7, what=k)
    assert counts["model_psum"] > 0 and counts["model_gather"] > 0
    assert counts["gather_rows"] == 3 and counts["reduce_grad"] == 1


def test_sharded_mm_step_runs(run):
    state, m, counts = _same_on_every_rank(run["ranks"], 2)
    ref_state, ref_m = run["mm_ref"]
    assert np.isfinite(m.loss) and state.step == 1
    _close(m.loss, ref_m.loss, 1e-4, what="loss")
    for k in ("J", "D", "S"):
        _close(state.gen_params[k], ref_state.gen_params[k], 1e-4,
               atol=1e-6, what=k)
    assert counts["gather_rows"] == 1 and counts["reduce_grad"] == 1


def test_sharded_ensemble_matches_unsharded(run):
    """Members over ranks (2 each), gathered back, against the unsharded
    ensemble step: no collective but the gather."""
    states, m, counts = _same_on_every_rank(run["ranks"], 3)
    ref_states, ref_m = run["ens_ref"]
    _close(m.d_loss, ref_m.d_loss, 1e-10, what="d_loss")
    for field in ("gen_params", "critic_params"):
        for k, v in getattr(ref_states, field).items():
            _close(getattr(states, field)[k], v, 1e-10, atol=1e-14,
                   what=f"{field} {k}")
    assert counts == {"gather_members": 1}


@pytest.mark.parametrize("groups,stride", [(0, 64), (1, 64), (1, 7)])
def test_chunked_stop_rule_equals_the_per_iteration_rule(groups, stride):
    """The adjoint under a split runs each check chunk past the stop and
    replays it to the batch's stop (one collective a chunk): on one rank
    (the max over ranks is the identity) it equals the plain loop, for
    one stop rule and per member, whatever the stride."""
    import types

    from tcgan_torch.ops import fixed_point as tfp
    from tcgan_torch.ops import ift as tift
    from tcgan_torch.ops import stimulus

    cfg = dataclasses.replace(TGEN.ssn, check_every=8)
    x = cfg.site_pos(dtype=F64)
    z = torch.randn((2, 3, 16, 16), generator=torch.Generator().manual_seed(4),
                    dtype=F64)
    J, D, S = tgen.param_values(TGEN, tgen.init_params(TGEN))
    W = torch.stack([tgen.weights.build_weight(J, D, S, z[0], x),
                     1.6 * tgen.weights.build_weight(J, D, S, z[1], x)])
    I = stimulus.stimulus_battery(GEN["bandwidths"], GEN["contrasts"], x,
                                  cfg.smoothness)
    res = tfp.solve_fixed_point(cfg, W, I, check_every=8)
    g = torch.randn(res.r.shape, dtype=F64,
                    generator=torch.Generator().manual_seed(1))
    one_rank = types.SimpleNamespace(model=None, max=lambda x: x)

    def bwd(split):
        tift.adjoint_iterations = 0
        out = tift._bwd(cfg, "iterative", 20000, 1e-4,
                        (W, I, res.r, res.converged), g, stride, groups,
                        split)[0]
        return out, tift.adjoint_iterations

    (plain, n_plain), (chunked, n_chunked) = bwd(None), bwd(one_rank)
    np.testing.assert_array_equal(chunked.numpy(), plain.numpy())
    assert n_chunked == n_plain


def test_check_replicated_catches_a_drifted_rank(monkeypatch):
    """A checkpoint's state must be equal on every rank: a second rank
    whose copy of one value drifted by 1e-12 is caught (the max over the
    ranks of x and of -x, one all-reduce, simulated here)."""
    state = {"w": torch.arange(4.0), "count": torch.ones(2, dtype=torch.int32)}
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tmesh.dist, "get_world_size", lambda: 2)
    drift = {"d": 0.0}

    def all_reduce(x, op=None):
        other = x.clone()
        other[0, 3] += drift["d"]
        other[1, 3] -= drift["d"]
        torch.maximum(x, other, out=x)

    monkeypatch.setattr(tmesh.dist, "all_reduce", all_reduce)
    tmesh.check_replicated(state, "state")
    drift["d"] = 1e-12
    with pytest.raises(RuntimeError, match="state: 1 of 6 values differ"):
        tmesh.check_replicated(state, "state")


def test_make_mesh_shapes_and_validation():
    """The reference's shapes (``tests/test_parallel.py:29-34``) and
    divisibility checks (``:178-185``) over 8 ranks; a mesh must also use
    every rank, and a batch that the batch axis does not divide raises."""
    assert tmesh.mesh_shape(8) == (8, 1)
    assert tmesh.mesh_shape(8, n_batch=4, n_model=2) == (4, 2)
    for kw in (dict(n_model=3), dict(n_model=16), dict(n_batch=16),
               dict(n_model=0), dict(n_batch=2, n_model=2)):
        with pytest.raises(ValueError):
            tmesh.mesh_shape(8, **kw)
    assert tmesh.row_slice(8, 4, 3) == slice(6, 8)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.row_slice(6, 4, 0)
    with pytest.raises(RuntimeError, match="process group"):
        tpar.make_mesh()


def test_dryrun_multichip_twin(capsys):
    """``tcgan_torch.entry.dryrun_multichip(4, device="cpu")``: 4 gloo
    ranks on the CPU, a 2 x 2 mesh, one anchored, drift-latched WGAN-GP
    step (the reference's tiny config), the reference's OK line."""
    out = dryrun_multichip(4, device="cpu")
    assert out["mesh"] == {"batch": 2, "model": 2} and out["step"] == 1
    # 2 critic batches + the generator's + 2 anchor updates gathered; the
    # generator's and each anchor update's gradient reduced
    assert out["collectives"]["gather_rows"] == 5
    assert out["collectives"]["reduce_grad"] == 3
    assert "dryrun_multichip OK: mesh={'batch': 2, 'model': 2}" in \
        capsys.readouterr().out
