"""Port parity for the WGAN-GP step: ``tcgan_torch.models.{moments,wgan}``
against ``tcgan_tpu.models.{moments,wgan}`` on the same NumPy inputs, in
f64 on tiny shapes (N=6, 2 stimuli, critic (16, 16)).

The JAX step draws its noise from a key; the tests replay the key splits of
``train_step_impl`` (and of ``apply_anchor_update``) with ``jax.random``
and hand the same arrays to the port as a ``StepNoise``.

Tolerances (f64):

- moments, losses and their gradients with the forward solve only: rtol
  1e-10;
- the optimizer alone: rtol 1e-12 (same arithmetic, same order);
- a whole step: rtol 1e-6 on parameters, optimizer moments and metrics,
  atol 1e-12. The generator gradient comes through the iterative adjoint,
  whose global stop test may land one iteration apart (see
  ``tests/test_torch_ift.py``); Adam's normalized first step takes that
  difference down to roundoff, the moments keep it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tcgan_tpu.models import generator as jgen
from tcgan_tpu.models import moments as jmom
from tcgan_tpu.models import wgan as jwgan
from tcgan_tpu.ops import ssn as jssn
from tcgan_tpu.ops import weights as jweights
from tcgan_torch.models import critic as tcritic
from tcgan_torch.models import generator as tgen
from tcgan_torch.models import moments as tmom
from tcgan_torch.models import wgan as twgan
from tcgan_torch.ops import ssn as tssn

SSN = dict(N=6, k=0.005, n=2.0, dt=0.001, max_iter=3000, atol=1e-5,
           check_every=8)
GEN = dict(bandwidths=(0.25, 1.0), contrasts=(5.0,), sample_sites=1)
WGAN = dict(critic_layers=(16, 16), batch_size=4, n_critic=2, n_critic0=2,
            clip_grad=1.0)
F64 = torch.float64


def _cfgs(**kw):
    jg = jgen.GeneratorConfig(ssn=jssn.SSNConfig(**SSN), dtype=jnp.float64,
                              **GEN)
    tg = tgen.GeneratorConfig(ssn=tssn.SSNConfig(**SSN), dtype=F64, **GEN)
    kw = {**WGAN, **kw}
    return jwgan.WGANConfig(gen=jg, **kw), twgan.WGANConfig(gen=tg, **kw)


def _t(x, dtype=F64):
    return torch.tensor(np.array(x, copy=True), dtype=dtype)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, rtol, atol=1e-12, what=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg=what)


def _real(cfg, n, seed=1):
    return np.random.default_rng(seed).normal(
        1.0, 0.1, (n, cfg.critic_batch, cfg.gen.tc_dim))


def test_moment_helpers_match_jax():
    rng = np.random.default_rng(3)
    tc = rng.normal(size=(6, 4))
    w = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 0.5])
    for weights in (None, w):
        jm = jmom.data_moments(jnp.asarray(tc), None if weights is None
                               else jnp.asarray(weights))
        tm = tmom.data_moments(_t(tc), None if weights is None
                               else _t(weights))
        for a, b in zip(tm, jm):
            _close(a, b, 1e-12)
    conv = rng.uniform(size=(5, 3)) > 0.3
    for c in (conv, np.zeros_like(conv) | (np.arange(3) > 0)):
        _close(tmom.survivor_chain(torch.tensor(c), F64),
               jmom.survivor_chain(jnp.asarray(c), jnp.float64), 0)
    jc, tc_ = _cfgs(moment_anchor=1e-3, anchor_ema_late=0.9,
                    anchor_ema_switch_step=3)
    for step in (0, 2, 3, 9):
        assert tmom.effective_gamma(tc_, step, base=0.99, late=0.9,
                                    switch=3) == float(jmom.effective_gamma(
                                        jc, jnp.asarray(step), base=0.99,
                                        late=0.9, switch=3))


@pytest.mark.parametrize("reject", [False, True])
def test_losses_and_gradients_match_jax(monkeypatch, reject):
    jcfg, tcfg = _cfgs(reject_unconverged=reject)
    jstate = jwgan.init_state(jcfg)
    cp_np = {k: np.asarray(v) for k, v in jstate.critic_params.items()}
    gp_np = {k: np.asarray(v) for k, v in jstate.gen_params.items()}
    rng = np.random.default_rng(4)
    real = _real(tcfg, 1)[0]
    fake = rng.normal(1.0, 0.2, real.shape)
    eps = rng.uniform(size=(real.shape[0], 1))
    fake_w = np.array([1.0, 0.0, 1.0, 1.0]) if reject else None

    # the reference draws eps and z from keys: inject the same arrays
    z = rng.standard_normal((4, 12, 12))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None: jnp.asarray(eps))
    monkeypatch.setattr(jgen.weights, "sample_z",
                        lambda key, shape, N, dtype=None: jnp.asarray(z))

    def jloss(cp):
        return jwgan.critic_loss_fn(
            jcfg, cp, jnp.asarray(real), jnp.asarray(fake),
            jax.random.PRNGKey(0),
            fake_w=None if fake_w is None else jnp.asarray(fake_w))

    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(
        jstate.critic_params)
    leaves = {k: _t(v).requires_grad_() for k, v in cp_np.items()}
    tl, taux = twgan.critic_loss_fn(
        tcfg, leaves, _t(real), _t(fake), _t(eps),
        fake_w=None if fake_w is None else _t(fake_w))
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    _close(tl, jl, 1e-10)
    for a, b in zip(taux, jaux):
        _close(a, b, 1e-10)
    for k in cp_np:
        _close(tg[k], jg[k], 1e-10, what=k)

    # generator loss through the forward solve and the IFT backward
    (jgl, jst), jgg = jax.value_and_grad(
        lambda p: jwgan.gen_loss_fn(jcfg, p, jstate.critic_params,
                                    jax.random.PRNGKey(1)),
        has_aux=True)(jstate.gen_params)
    gl = {k: _t(v).requires_grad_() for k, v in gp_np.items()}
    tgl, tst = twgan.gen_loss_fn(
        tcfg, gl, {k: _t(v) for k, v in cp_np.items()}, z=z)
    tgg = dict(zip(gl, torch.autograd.grad(tgl, list(gl.values()))))
    _close(tgl, jgl, 1e-10)
    for a, b in zip(tst, jst):
        _close(a, b, 1e-6)
    for k in gp_np:
        _close(tgg[k], jgg[k], 1e-6, what=k)


def _adam_state(jopt):
    """(apply_if_finite state, ScaleByAdamState, schedule counts) of an
    optax state tree."""
    found, counts = [], []

    def visit(x):
        if isinstance(x, optax.ScaleByAdamState):
            found.append(x)
        elif isinstance(x, optax.ScaleByScheduleState):
            counts.append(int(x.count))
        elif isinstance(x, tuple):
            for y in x:
                visit(y)

    visit(jopt.inner_state)
    return jopt, found[0], counts


def _compare_opt(topt, jopt, rtol, what=""):
    outer, adam, sched_counts = _adam_state(jopt)
    assert int(topt.count) == int(adam.count), what
    assert all(c == int(topt.count) for c in sched_counts), what
    assert int(topt.notfinite_count) == int(outer.notfinite_count), what
    assert int(topt.total_notfinite) == int(outer.total_notfinite), what
    assert bool(topt.last_finite) == bool(outer.last_finite), what
    for k in topt.mu:
        _close(topt.mu[k], adam.mu[k], rtol, what=f"{what} mu {k}")
        _close(topt.nu[k], adam.nu[k], rtol, what=f"{what} nu {k}")


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_adam_matches_optax_over_steps(clip):
    """Decay with a floor and a switch step, a clip, and one non-finite
    gradient: the skipped step leaves the schedule's count where it was, so
    the lr follows applied updates."""
    jcfg, tcfg = _cfgs(lr_gen=1e-2, lr_decay_steps=2, lr_decay_rate=0.5,
                       gen_lr_floor=3e-3, gen_lr_switch_step=5,
                       clip_grad=clip)
    jtx, _ = jwgan.make_optimizers(jcfg)
    ttx, _ = twgan.make_optimizers(tcfg)
    rng = np.random.default_rng(5)
    params = {"D": rng.normal(size=(2, 2)), "J": rng.normal(size=(2, 2)),
              "S": rng.normal(size=(2, 2))}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    jo, to = jtx.init(jp), ttx.init(tp)
    for i in range(8):
        g = {k: rng.normal(size=(2, 2)) * (3.0 if i % 2 else 0.2)
             for k in params}
        if i == 3:
            g["J"][0, 1] = np.nan
        ju, jo = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jo,
                            jp)
        tu, to = ttx.update({k: _t(v) for k, v in g.items()}, to)
        jp = optax.apply_updates(jp, ju)
        tp = twgan.apply_updates(tp, tu)
        for k in params:
            _close(tu[k], ju[k], 1e-12, what=f"step {i} update {k}")
            _close(tp[k], jp[k], 1e-12, what=f"step {i} param {k}")
        _compare_opt(to, jo, 1e-12, what=f"step {i}")
    assert int(to.count) == 7 and int(to.total_notfinite) == 1
    # the schedule itself: decay, floor, switch
    sched_j, sched_t = jwgan.gen_lr_schedule(jcfg), twgan.gen_lr_schedule(tcfg)
    for c in range(8):
        assert float(sched_t(torch.tensor(c, dtype=torch.int32))) == \
            float(sched_j(jnp.asarray(c, jnp.int32)))


def _replay_noise(jcfg, n_critic, step, key, anchor_updates=0,
                  dtype=jnp.float64):
    """The noise ``jwgan.train_step_impl`` draws from ``key`` at ``step``
    (in ``dtype``: the generator's and the real batches' dtype there)."""
    N, B = jcfg.gen.ssn.N, jcfg.batch_size
    key_c, key_g = jax.random.split(jax.random.fold_in(key, step))
    critic_z, gp_eps = [], []
    for k in jax.random.split(key_c, n_critic):
        k_z, k_gp = jax.random.split(k)
        critic_z.append(np.array(jweights.sample_z(k_z, (B,), N,
                                                     dtype=dtype)))
        gp_eps.append(np.array(jax.random.uniform(
            k_gp, (jcfg.critic_batch, 1), dtype=dtype)))
    gen_z = np.array(jweights.sample_z(key_g, (B,), N, dtype=dtype))
    anchor_z = None
    if anchor_updates:
        keys = jax.random.split(jax.random.fold_in(key_g, 1), anchor_updates)
        anchor_z = [np.array(jweights.sample_z(k, (B,), N, dtype=dtype))
                    for k in keys]
    return twgan.StepNoise(critic_z, gp_eps, gen_z, anchor_z)


def _port_state(jstate, tcfg, data_moments=None, dtype=F64):
    """The port's state holding the reference state's parameters."""
    gen_init = tgen.params_from_numpy(
        {k: np.asarray(v) for k, v in jstate.gen_params.items()}, dtype=dtype)
    state = twgan.init_state(tcfg, gen_init=gen_init,
                             data_moments=data_moments)
    cp = tcritic.params_from_numpy(
        {k: np.asarray(v) for k, v in jstate.critic_params.items()},
        dtype=dtype)
    return state._replace(critic_params=cp)


STEP_CASES = {
    "plain": dict(),
    "ema_decay": dict(ema_decay=0.9, lr_decay_steps=3),
    "anchor_k2": dict(moment_anchor=1e-2, moment_ema=0.9, anchor_updates=2,
                      anchor_beta1=0.8),
    "endgame": dict(moment_anchor=1e-2, gen_lr_switch_residual=1e9,
                    gen_lr_floor=2e-5, anchor_ema_late=0.5,
                    anchor_ema_switch_step=1),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    kw = STEP_CASES[case]
    jcfg, tcfg = _cfgs(**kw)
    anchor = kw.get("moment_anchor", 0) > 0
    dmom = None
    if anchor:
        tc = np.random.default_rng(6).normal(0.5, 0.1, (32, 2))
        dmom = tuple(np.asarray(m) for m in jmom.data_moments(
            jnp.asarray(tc)))
    jstate = jwgan.init_state(jcfg, data_moments=dmom)
    tstate = _port_state(jstate, tcfg, dmom)
    if case == "endgame":  # latched from the start: this step is cooled
        jstate = jstate._replace(endgame=jnp.asarray(True))
        tstate = tstate._replace(endgame=torch.tensor(True))
    n_steps = 2 if anchor else 1
    for step in range(n_steps):
        n_critic = jcfg.n_critic
        real = _real(jcfg, n_critic, seed=10 + step)
        key = jax.random.PRNGKey(20 + step)
        noise = _replay_noise(jcfg, n_critic, step, key,
                              jcfg.anchor_updates if anchor else 0)
        jstate, jm = jwgan.train_step(jcfg, n_critic, jstate,
                                      jnp.asarray(real), key)
        tstate, tm = twgan.train_step_impl(tcfg, n_critic, tstate, _t(real),
                                           noise=noise)
        assert tstate.step == int(jstate.step) == step + 1
        for name in ("gen_params", "critic_params", "ema_params"):
            tp, jp = getattr(tstate, name), getattr(jstate, name)
            assert (tp is None) == (jp is None), name
            for k in (tp or {}):
                _close(tp[k], jp[k], 1e-6, what=f"{case} {name} {k}")
        _compare_opt(tstate.gen_opt, jstate.gen_opt, 1e-6, "gen_opt")
        _compare_opt(tstate.critic_opt, jstate.critic_opt, 1e-6,
                     "critic_opt")
        if anchor:
            _compare_opt(tstate.anchor_opt, jstate.anchor_opt, 1e-6,
                         "anchor_opt")
            for name in ("mom_ema_mean", "mom_ema_second", "mom_ema_count"):
                _close(getattr(tstate, name), getattr(jstate, name), 1e-6,
                       what=name)
        assert (tstate.endgame is None) == (jstate.endgame is None)
        if tstate.endgame is not None:
            assert bool(tstate.endgame) == bool(jstate.endgame)
        for name, jv in jm._asdict().items():
            tv = getattr(tm, name)
            assert (tv is None) == (jv is None), name
            if tv is not None:
                _close(tv, jv, 1e-6, what=f"{case} metric {name}")
        assert float(tm.frac_converged) == 1.0


def test_init_state_checks_and_unported_latches():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="moment_anchor"):
        twgan.init_state(dataclasses.replace(tcfg, moment_anchor=1e-3))
    with pytest.raises(ValueError, match="requires moment_anchor"):
        twgan.init_state(dataclasses.replace(tcfg, gen_lr_switch_residual=1))
    # the latches (ported): the reference's config errors, and fresh latch
    # state equal to the reference's
    jcfg, _ = _cfgs()
    dmom = (np.zeros(2), np.zeros((2, 2)))
    for field in ("anchor_ema_switch_drift", "anchor_ema_switch_vel"):
        kw = dict(moment_anchor=1e-3, **{field: 0.5})
        for mod, cfg in ((jwgan, jcfg), (twgan, tcfg)):
            with pytest.raises(ValueError, match="requires anchor_ema_late"):
                mod.init_state(dataclasses.replace(cfg, **kw),
                               data_moments=dmom)
        kw["anchor_ema_late"] = 0.9
        jst = jwgan.init_state(dataclasses.replace(jcfg, **kw),
                               data_moments=dmom)
        tst = twgan.init_state(dataclasses.replace(tcfg, **kw),
                               data_moments=dmom)
        assert bool(tst.gamma_late) == bool(jst.gamma_late) is False
        for name in ("drift_dir", "drift_mag"):
            assert sorted(getattr(tst, name)) == sorted(getattr(jst, name))
            for k, v in getattr(tst, name).items():
                _close(v, getattr(jst, name)[k], 0)
    both = dict(moment_anchor=1e-3, anchor_ema_late=0.9,
                anchor_ema_switch_drift=0.5, anchor_ema_switch_vel=1.0)
    for mod, cfg in ((jwgan, jcfg), (twgan, tcfg)):
        with pytest.raises(ValueError, match="pick one"):
            mod.init_state(dataclasses.replace(cfg, **both),
                           data_moments=dmom)
    assert twgan.init_state(tcfg).gamma_late is None
    state = twgan.init_state(tcfg)
    with pytest.raises(ValueError, match="noise"):
        twgan.train_step_impl(tcfg, 1, state,
                              torch.zeros((1, 4, 2), dtype=F64))
    # the field sets of the state, metrics and config match the reference
    assert twgan.TrainState._fields == jwgan.TrainState._fields
    assert twgan.StepMetrics._fields == jwgan.StepMetrics._fields
    assert [f.name for f in dataclasses.fields(twgan.WGANConfig)] == \
        [f.name for f in dataclasses.fields(jwgan.WGANConfig)]


def test_train_step_draws_from_generator():
    """Without injected noise the step draws from the torch.Generator:
    the same seed gives the same step."""
    _, tcfg = _cfgs()
    real = _t(_real(tcfg, 2))
    outs = []
    for _ in range(2):
        state = twgan.init_state(tcfg)
        state, m = twgan.train_step(
            tcfg, 2, state, real, generator=torch.Generator().manual_seed(7))
        outs.append((state, m))
    for k in outs[0][0].gen_params:
        assert torch.equal(outs[0][0].gen_params[k], outs[1][0].gen_params[k])
    m = outs[0][1]
    assert torch.isfinite(m.d_loss) and m.d_loss_iters.shape == (2,)
