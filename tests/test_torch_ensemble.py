"""Port parity for the multi-start ensemble: ``tcgan_torch.models.ensemble``
against ``tcgan_tpu.models.ensemble`` (the reference vmaps a single fit's
step over the members), in f64 on tiny shapes (N=6, 2 stimuli, K=3), and
the two repairs the member axis needs:

- ``fixed_point.solve_any`` folds a member-stacked W (K, B, 2N, 2N) into ONE
  kernel launch and never takes the lockstep solve on the cuda backend;
- the iterative adjoint's stop rule runs per member (``group_axes``), as
  ``lax.while_loop`` under ``vmap`` does: a member that has converged is
  frozen while the others go on.

Each member's noise is replayed from its member key as
``tests/test_torch_wgan.py::_replay_noise`` does. Tolerances as in the
whole-step tests there (rtol 1e-6, atol 1e-12); the first Adam moment mu,
which carries the raw gradient, is held per member at rtol 1e-9, which the
global stop rule misses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tcgan_tpu.models import ensemble as jens
from tcgan_tpu.ops import weights as jweights
from tcgan_torch.models import ensemble as tens
from tcgan_torch.models import generator as tgen
from tcgan_torch.models import moments as tmom
from tcgan_torch.models import wgan as twgan
from tcgan_torch.ops import fixed_point as tfp
from tcgan_torch.ops import ift as tift
from tcgan_torch.ops import ssn as tssn
from tcgan_torch.ops import stimulus as tstim
from tcgan_torch.ops import weights as tweights
from tcgan_torch.ops.cuda import ssn_solve
from tests.test_torch_wgan import (F64, SSN, _cfgs, _close, _real,
                                   _replay_noise, _t)

K = 3


def _stack_noise(noises):
    return twgan.StepNoise(
        critic_z=[np.stack(z) for z in zip(*(n.critic_z for n in noises))],
        gp_eps=[np.stack(e) for e in zip(*(n.gp_eps for n in noises))],
        gen_z=np.stack([n.gen_z for n in noises]))


def _compare_members(tstate, jstate, fields, rtol=1e-6, what=""):
    for name in fields:
        tp, jp = getattr(tstate, name), getattr(jstate, name)
        assert (tp is None) == (jp is None), name
        for k in (tp or {}):
            _close(tp[k], jp[k], rtol, what=f"{what} {name} {k}")


def _adam_members(jopt):
    """(apply_if_finite state, ScaleByAdamState) of a member-stacked optax
    state tree."""
    found = []

    def visit(x):
        if isinstance(x, optax.ScaleByAdamState):
            found.append(x)
        elif isinstance(x, tuple):
            for y in x:
                visit(y)

    visit(jopt.inner_state)
    return jopt, found[0]


def _compare_opt_members(topt, jopt, rtol, mu_rtol, what=""):
    outer, adam = _adam_members(jopt)
    np.testing.assert_array_equal(topt.count.numpy(), np.asarray(adam.count))
    np.testing.assert_array_equal(topt.notfinite_count.numpy(),
                                  np.asarray(outer.notfinite_count))
    np.testing.assert_array_equal(topt.last_finite.numpy(),
                                  np.asarray(outer.last_finite))
    for k in topt.mu:
        _close(topt.mu[k], adam.mu[k], mu_rtol, atol=0,
               what=f"{what} mu {k}")
        _close(topt.nu[k], adam.nu[k], rtol, what=f"{what} nu {k}")


def _wgan_case(model_name, **kw):
    jcfg, tcfg = _cfgs(**kw)
    if model_name == "cwgan":
        from tcgan_tpu.models import cwgan as jc
        from tcgan_torch.models import cwgan as tc

        fields = {f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg)}
        jcfg = jc.CWGANConfig(**fields)
        tfields = {f.name: getattr(tcfg, f.name)
                   for f in dataclasses.fields(tcfg)}
        tcfg = tc.CWGANConfig(**tfields)
        return jcfg, tcfg, jc, tc
    from tcgan_tpu.models import wgan as jw

    return jcfg, tcfg, jw, twgan


@pytest.mark.parametrize("model_name,kw", [
    ("wgan", {}),
    ("wgan", dict(ema_decay=0.9, reject_unconverged=True)),
    ("cwgan", {}),
])
def test_ensemble_step_matches_vmapped_reference(model_name, kw):
    jcfg, tcfg, jmodel, tmodel = _wgan_case(model_name, **kw)
    jstates = jens.init_ensemble(jcfg, K, jax.random.PRNGKey(0),
                                 start_jitter=0.3, model=jmodel)
    host = jax.tree.map(np.asarray, jstates)
    tstates = tens.init_ensemble(tcfg, K, model=tmodel)
    tstates = tens.states_from_numpy(
        tstates, gen_params=host.gen_params,
        critic_params=host.critic_params,
        **({"ema_params": host.ema_params} if kw.get("ema_decay") else {}))
    n_critic = jcfg.n_critic
    rng = np.random.default_rng(11)
    real = rng.normal(1.0, 0.1, (K, n_critic, tcfg.critic_batch,
                                 tcfg.critic_cfg.in_dim))
    keys = jax.random.split(jax.random.PRNGKey(9), K)
    step = jax.jit(jens.make_ensemble_step_impl(jmodel.train_step_impl),
                   static_argnames=("cfg", "n_critic"))
    jnew, jm = step(jcfg, n_critic, jstates, jnp.asarray(real), keys)
    noise = _stack_noise([_replay_noise(jcfg, n_critic, 0, k) for k in keys])
    ssn_solve.launches = 0
    tnew, tm = tens.ensemble_train_step(tcfg, n_critic, tstates, _t(real),
                                        model=tmodel, noise=noise)
    assert tnew.step == 1
    _compare_members(tnew, jnew, ("gen_params", "critic_params",
                                  "ema_params"), what=model_name)
    _compare_opt_members(tnew.gen_opt, jnew.gen_opt, 1e-6, 1e-9, "gen_opt")
    _compare_opt_members(tnew.critic_opt, jnew.critic_opt, 1e-6, 1e-6,
                         "critic_opt")
    for name, jv in jm._asdict().items():
        tv = getattr(tm, name)
        assert (tv is None) == (jv is None), name
        if tv is not None:
            assert tuple(tv.shape) == np.shape(jv), name
            _close(tv, jv, 1e-6, what=f"metric {name}")
    assert tm.frac_converged.shape == (K,)


def test_members_need_different_adjoint_iterations():
    """The jittered members of the step above take different numbers of
    adjoint iterations, so the per-member stop rule is what the rtol 1e-9
    comparison of mu tests."""
    _, tcfg = _cfgs()
    states = tens.init_ensemble(tcfg, K, start_jitter=0.3)
    z = torch.randn((K, tcfg.batch_size, 12, 12), dtype=F64,
                    generator=torch.Generator().manual_seed(0))
    counts = []
    for m in range(K):
        leaves = {k: v[m].clone().requires_grad_() for k, v in
                  states.gen_params.items()}
        out = tgen.sample_tuning_curves(tcfg.gen, leaves, tcfg.batch_size,
                                        z=z[m])
        tift.adjoint_iterations = 0
        torch.autograd.grad(out.tc.mean(), list(leaves.values()))
        counts.append(tift.adjoint_iterations)
    assert len(set(counts)) == K, counts


@pytest.mark.parametrize("per_member_data", [False, True])
@pytest.mark.parametrize("fixed_z", [False, True])
def test_mm_ensemble_step_matches_vmapped_reference(per_member_data,
                                                     fixed_z):
    from tests.test_torch_moments_fit import _cfgs as mm_cfgs

    jcfg, tcfg = mm_cfgs(moment_ema=0.9, fixed_z=fixed_z, clip_grad=1.0)
    jstates = jens.init_mm_ensemble(jcfg, K, jax.random.PRNGKey(0),
                                    start_jitter=0.3)
    host = jax.tree.map(np.asarray, jstates)
    N, B = jcfg.gen.ssn.N, jcfg.batch_size
    zset = lambda k: np.array(jweights.sample_z(  # noqa: E731
        k, (B,), N, dtype=jnp.float64))
    tstates = tens.init_mm_ensemble(tcfg, K)
    tstates = tens.states_from_numpy(
        tstates, gen_params=host.gen_params,
        **({"fixed_z": np.stack([zset(k) for k in jstates.z_key])}
           if fixed_z else {}))
    d = tcfg.gen.tc_dim
    rng = np.random.default_rng(5)
    lead = (K,) if per_member_data else ()
    dm = rng.uniform(0.5, 1.5, lead + (d,))
    ds = dm[..., :, None] * dm[..., None, :] + 0.1 * np.eye(d)
    keys = jax.random.split(jax.random.PRNGKey(3), K)
    step = jax.jit(jens.make_mm_ensemble_step_impl(
        per_member_data=per_member_data), static_argnames=("cfg",))
    jnew, jm = step(jcfg, jstates, jnp.asarray(dm), jnp.asarray(ds), keys)
    z = None if fixed_z else np.stack(
        [zset(jax.random.fold_in(k, 0)) for k in keys])
    tnew, tm = tmom.train_step_impl(tcfg, tstates, _t(dm), _t(ds), z=z)
    _compare_members(tnew, jnew, ("gen_params",), what="mm")
    for name in ("ema_mean", "ema_second", "ema_count"):
        _close(getattr(tnew, name), getattr(jnew, name), 1e-6, what=name)
    for name, jv in jm._asdict().items():
        assert tuple(getattr(tm, name).shape) == (K,)
        _close(getattr(tm, name), jv, 1e-6, what=f"metric {name}")


def test_single_member_is_the_single_step():
    """K=1 through the member axis equals the single-fit step: the member
    axis adds members, not semantics. To roundoff (rtol 1e-12, the
    tolerance of the reference's own K=1 test): the member axis runs the
    critic's matmuls and reductions batched, which round the last bit
    differently. The solver's outputs and the flags are bit-equal."""
    _, tcfg = _cfgs(ema_decay=0.9, reject_unconverged=True)
    state = twgan.init_state(tcfg)
    real = _t(_real(tcfg, tcfg.n_critic))
    noise = _replay_noise(_cfgs()[0], tcfg.n_critic, 0,
                          jax.random.PRNGKey(4))
    one, m1 = twgan.train_step_impl(tcfg, tcfg.n_critic, state, real,
                                    noise=noise)
    stacked = tens.stack_states([state])
    new, mk = tens.ensemble_train_step(
        tcfg, tcfg.n_critic, stacked, real[None], noise=_stack_noise([noise]))
    for field in ("gen_params", "critic_params", "ema_params"):
        for k, v in getattr(one, field).items():
            _close(getattr(new, field)[k][0], v, 1e-12, atol=1e-15,
                   what=f"{field} {k}")
    for k, v in one.gen_opt.mu.items():
        _close(new.gen_opt.mu[k][0], v, 1e-12, atol=1e-15, what=f"mu {k}")
    for name, v in m1._asdict().items():
        if v is not None:
            _close(getattr(mk, name)[0], v, 1e-12, atol=1e-15, what=name)
    for name in ("frac_converged", "frac_diverged", "mean_iters"):
        assert torch.equal(getattr(mk, name)[0], getattr(m1, name)), name


def test_init_ensemble_jitter_and_member_state():
    _, tcfg = _cfgs(ema_decay=0.9)
    base = tgen.init_params(tcfg.gen)
    states = tens.init_ensemble(tcfg, K, gen_init=base, start_jitter=0.1)
    assert states.step == 0 and states.gen_opt.count.shape == (K,)
    for k, v in base.items():
        assert torch.equal(states.gen_params[k][0], v)
        assert torch.equal(states.ema_params[k][0], v)
        assert not torch.allclose(states.gen_params[k][1], v)
        assert not torch.allclose(states.gen_params[k][2],
                                  states.gen_params[k][1])
    assert not torch.equal(states.critic_params["w0"][0],
                           states.critic_params["w0"][1])
    one = tens.member_state(states, 2)
    assert one.gen_params["J"].shape == (2, 2) and one.step == 0
    assert torch.equal(one.critic_params["w0"], states.critic_params["w0"][2])
    mcfg = tmom.MomentMatchingConfig(gen=tcfg.gen, batch_size=4,
                                     fixed_z=True, moment_ema=0.9)
    mm = tens.init_mm_ensemble(mcfg, K, start_jitter=0.1)
    assert mm.fixed_z.shape == (K, 4, 12, 12)
    assert not torch.equal(mm.fixed_z[0], mm.fixed_z[1])
    assert mm.ema_mean.shape == (K, mcfg.gen.tc_dim)
    with pytest.raises(ValueError, match="shape"):
        tens.states_from_numpy(states, gen_params={
            k: np.zeros((2, 2)) for k in base})
    with pytest.raises(NotImplementedError, match="single-fit"):
        acfg = dataclasses.replace(tcfg, moment_anchor=1e-3)
        st = tens.stack_states([twgan.init_state(
            acfg, data_moments=(np.zeros(2), np.eye(2)))])
        twgan.train_step_impl(acfg, 1, st, torch.zeros((1, 1, 4, 2),
                                                       dtype=F64),
                              generator=torch.Generator())


def test_ensemble_summary_matches_reference():
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    jstates = jens.init_ensemble(jcfg, K, jax.random.PRNGKey(2),
                                 start_jitter=0.2)
    true = {"J": np.full((2, 2), 0.02), "D": np.full((2, 2), 0.05),
            "S": np.full((2, 2), 0.2)}
    jsum = jens.ensemble_summary(jcfg, jstates, true)
    host = {k: np.asarray(v) for k, v in jstates.gen_params.items()}
    assert tens.ensemble_summary(tcfg.gen, host, true) == jsum


# -- repair: one kernel launch for a member-stacked W ----------------------


def _battery_problem(lead=(K,), B=2, seed=0):
    cfg = tssn.SSNConfig(**SSN)
    x = cfg.site_pos(dtype=F64)
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(lead + (B, 12, 12), dtype=F64, generator=g)
    J = torch.tensor([[0.02, 0.016], [0.02, 0.012]], dtype=F64)
    D = torch.tensor([[0.05, 0.04], [0.05, 0.04]], dtype=F64)
    S = torch.tensor([[0.25, 0.1], [0.25, 0.1]], dtype=F64)
    jit = 1.0 + 0.3 * torch.rand(lead + (1, 2, 2), dtype=F64, generator=g)
    W = tweights.build_weight(J * jit, D, S, z, x)
    I = tstim.stimulus_battery((0.25, 1.0), (5.0,), x, cfg.smoothness)
    return cfg, W, I


def test_solve_any_folds_members_into_one_launch(monkeypatch):
    cfg, W, I = _battery_problem()
    cfg = dataclasses.replace(cfg, backend="cuda")
    calls = []
    real = ssn_solve.solve_fixed_point_cuda

    def recorder(c, Wf, If, check_every, accel):
        calls.append(tuple(Wf.shape))
        return real(c, Wf, If, check_every, accel)

    monkeypatch.setattr(ssn_solve, "solve_fixed_point_cuda", recorder)
    res = tfp.solve_any(cfg, W, I)
    assert calls == [(K * 2, 12, 12)]
    assert res.r.shape == (K, 2, 2, 12) and res.iters.shape == (K, 2, 2)
    for m in range(K):
        solo = real(cfg, W[m], I, cfg.check_every, False)
        for a, b in zip(res, solo):
            assert torch.equal(a[m], b)
    with pytest.raises(ValueError, match="shared battery"):
        tfp.solve_any(cfg, W, I.expand(K, -1, -1))
    assert len(calls) == 1


# -- repair: the adjoint's stop rule per member ----------------------------


def test_adjoint_stop_rule_per_group():
    """Two members whose adjoints need different iteration counts: with the
    member axis as a group each equals its own solo backward to roundoff;
    the global rule iterates the fast member on and misses it."""
    cfg, W, I = _battery_problem(lead=(2,), B=3, seed=3)
    W = torch.stack([W[0], 1.6 * W[1]])  # member 1 nearer criticality
    res = tfp.solve_fixed_point(cfg, W, I, check_every=cfg.check_every)
    assert bool(res.converged.all())
    g = torch.randn(res.r.shape, dtype=F64,
                    generator=torch.Generator().manual_seed(1))
    atol = 1e-4

    def bwd(Wm, rm, cm, gm, groups=0):
        tift.adjoint_iterations = 0
        out = tift._bwd(cfg, "iterative", 20000, atol, (Wm, I, rm, cm), gm,
                        group_axes=groups)[0]
        return out, tift.adjoint_iterations

    solo = [bwd(W[m], res.r[m], res.converged[m], g[m]) for m in range(2)]
    assert solo[0][1] != solo[1][1]
    grouped, n_grouped = bwd(W, res.r, res.converged, g, groups=1)
    glob, _ = bwd(W, res.r, res.converged, g)
    assert n_grouped == max(n for _, n in solo)
    for m in range(2):
        np.testing.assert_allclose(grouped[m].numpy(), solo[m][0].numpy(),
                                   rtol=1e-12, atol=1e-15)
    fast = int(np.argmin([n for _, n in solo]))
    assert not np.allclose(glob[fast].numpy(), solo[fast][0].numpy(),
                           rtol=1e-9, atol=0)
    # zero group axes: the global rule, unchanged
    np.testing.assert_array_equal(
        glob.numpy(), tift._bwd(cfg, "iterative", 20000, atol,
                                (W, I, res.r, res.converged), g)[0].numpy())


def test_batched_cotangents_equal_their_solo_backwards():
    """``vjp_W_batched``: one adjoint solve for a chunk of cotangents, each
    equal to its own backward."""
    cfg, W, I = _battery_problem(lead=(), B=3, seed=4)
    res = tfp.solve_fixed_point(cfg, W, I, check_every=cfg.check_every)
    g = torch.randn((4,) + tuple(res.r.shape), dtype=F64,
                    generator=torch.Generator().manual_seed(2))
    g[1] *= 1e-3  # converges in fewer iterations than the others
    bars = tift.vjp_W_batched(cfg, W, I, res, g, bwd_atol=1e-5)
    for c in range(4):
        solo = tift._bwd(cfg, "iterative", 20000, 1e-5,
                         (W, I, res.r, res.converged), g[c])[0]
        np.testing.assert_allclose(bars[c].numpy(), solo.numpy(),
                                   rtol=1e-12, atol=1e-15)
