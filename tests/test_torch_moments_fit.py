"""Port parity for the moment-matching fit: ``tcgan_torch.models.moments``
against ``tcgan_tpu.models.moments`` on the same NumPy inputs, in f64 on
tiny shapes (N=6, 2 stimuli, batch 4).

The reference draws each step's z from ``fold_in(key, step)``, or under
``fixed_z`` from the state's ``z_key``; the tests draw the same arrays with
``jax.random`` and hand them to the port (``z=``, or the state's
``fixed_z``).

Tolerances (f64):

- the survivor mask and the moment loss: rtol 1e-12;
- the optimizer alone: rtol 1e-12;
- whole steps: rtol 1e-6 on the ``ift`` path (the iterative adjoint's
  global stop test may land one iteration apart; see
  ``tests/test_torch_wgan.py``) and 1e-8 on the ``bptt`` path, on
  parameters, Adam's count and moments, the EMA buffers and the metrics.
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
from tcgan_tpu.ops import ssn as jssn
from tcgan_tpu.ops import weights as jweights
from tcgan_torch.models import generator as tgen
from tcgan_torch.models import moments as tmom
from tcgan_torch.ops import ssn as tssn
from tcgan_torch.train.checkpoint import CheckpointManager
from test_torch_wgan import _close, _t

SSN = dict(N=6, k=0.005, n=2.0, dt=0.001, max_iter=3000, atol=1e-5,
           check_every=8, seqlen=150)
GEN = dict(bandwidths=(0.25, 1.0), contrasts=(5.0,), sample_sites=1)
MM = dict(batch_size=4, lr=1e-2)
F64 = torch.float64


def _cfgs(solver="ift", ssn=None, **kw):
    ssn = {**SSN, **(ssn or {})}
    jg = jgen.GeneratorConfig(ssn=jssn.SSNConfig(**ssn), dtype=jnp.float64,
                              solver=solver, **GEN)
    tg = tgen.GeneratorConfig(ssn=tssn.SSNConfig(**ssn), dtype=F64,
                              solver=solver, **GEN)
    kw = {**MM, **kw}
    return (jmom.MomentMatchingConfig(gen=jg, **kw),
            tmom.MomentMatchingConfig(gen=tg, **kw))


def _adam(jopt):
    """The ScaleByAdamState inside an optax state tree."""
    if isinstance(jopt, optax.ScaleByAdamState):
        return jopt
    if isinstance(jopt, tuple):
        for x in jopt:
            found = _adam(x)
            if found is not None:
                return found
    return None


def _compare_state(tstate, jstate, rtol, what):
    assert tstate.step == int(jstate.step), what
    for k in tstate.gen_params:
        _close(tstate.gen_params[k], jstate.gen_params[k], rtol,
               what=f"{what} {k}")
    adam = _adam(jstate.opt)
    assert int(tstate.opt.count) == int(adam.count), what
    for k in tstate.opt.mu:
        _close(tstate.opt.mu[k], adam.mu[k], rtol, what=f"{what} mu {k}")
        _close(tstate.opt.nu[k], adam.nu[k], rtol, what=f"{what} nu {k}")
    for name in ("ema_mean", "ema_second", "ema_count"):
        tv, jv = getattr(tstate, name), getattr(jstate, name)
        assert (tv is None) == (jv is None), name
        if tv is not None:
            _close(tv, jv, rtol, what=f"{what} {name}")


def test_config_state_and_helpers_match_jax():
    with pytest.raises(ValueError, match="requires moment_ema"):
        tmom.MomentMatchingConfig(moment_ema_late=0.9)
    assert [f.name for f in dataclasses.fields(tmom.MomentMatchingConfig)] \
        == [f.name for f in dataclasses.fields(jmom.MomentMatchingConfig)]
    # the port keeps the fixed z-set where the reference keeps its key
    assert tmom.MMState._fields[:-1] == jmom.MMState._fields[:-1]
    assert tmom.MMMetrics._fields == jmom.MMMetrics._fields
    rng = np.random.default_rng(0)
    tc = rng.normal(1.0, 0.3, (4, 2))
    dm, ds = jmom.data_moments(jnp.asarray(rng.normal(1.0, 0.3, (16, 2))))
    for sites, toi in ((1, False), (2, False), (2, True)):
        jcfg, tcfg = _cfgs()
        jcfg = dataclasses.replace(jcfg, gen=dataclasses.replace(
            jcfg.gen, sample_sites=sites, track_offset_identity=toi))
        tcfg = dataclasses.replace(tcfg, gen=dataclasses.replace(
            tcfg.gen, sample_sites=sites, track_offset_identity=toi))
        for conv in (np.array([[1, 1], [1, 0]], bool),
                     np.array([[0, 1], [1, 0]], bool)):  # soft fallback
            class Out:
                converged = None
            jo, to = Out(), Out()
            jo.converged, to.converged = jnp.asarray(conv), torch.tensor(conv)
            jw, tw = jmom.sample_mask(jcfg, jo), tmom.sample_mask(tcfg, to)
            assert tw.dtype == torch.float32
            _close(tw, jw, 0)
    w = np.array([1.0, 0.0, 0.5, 1.0])
    jl, jaux = jmom.moment_loss(jcfg, jnp.asarray(tc), dm, ds,
                                weights=jnp.asarray(w))
    tl, taux = tmom.moment_loss(tcfg, _t(tc), _t(dm), _t(ds), weights=_t(w))
    _close(tl, jl, 1e-12)
    for a, b in zip(taux, jaux):
        _close(a, b, 1e-12)


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_optimizer_matches_optax(clip):
    jcfg, tcfg = _cfgs(clip_grad=clip)
    jtx, ttx = jmom.make_optimizer(jcfg), tmom.make_optimizer(tcfg)
    rng = np.random.default_rng(1)
    params = {k: rng.normal(size=(2, 2)) for k in ("D", "J", "S")}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    jo, to = jtx.init(jp), ttx.init(tp)
    for i in range(4):
        g = {k: rng.normal(size=(2, 2)) * (3.0 if i % 2 else 0.2)
             for k in params}
        ju, jo = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jo,
                            jp)
        tu, to = ttx.update({k: _t(v) for k, v in g.items()}, to)
        for k in params:
            _close(tu[k], ju[k], 1e-12, what=f"step {i} {k}")
    assert int(to.count) == int(_adam(jo).count) == 4


def _replay_z(jcfg, jstate, key, step):
    k = jstate.z_key if jcfg.fixed_z else jax.random.fold_in(key, step)
    return np.array(jweights.sample_z(k, (jcfg.batch_size,), jcfg.gen.ssn.N,
                                      dtype=jnp.float64))


STEP_CASES = {
    "ift": ("ift", {}, dict(clip_grad=1.0), 1e-6),
    "ift_ema_late_fixed_z": ("ift", {}, dict(
        moment_ema=0.9, moment_ema_late=0.5, moment_ema_switch_step=1,
        fixed_z=True), 1e-6),
    # no row converges within 16 iterations: no survivors, the EMA holds
    "ift_zero_survivors_ema": ("ift", dict(max_iter=16), dict(
        moment_ema=0.9), 1e-6),
    "bptt": ("bptt", {}, dict(survivor_mask=False), 1e-8),
    "bptt_ema_fixed_z": ("bptt", {}, dict(moment_ema=0.9, fixed_z=True),
                         1e-8),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case, tmp_path):
    solver, ssn, kw, rtol = STEP_CASES[case]
    jcfg, tcfg = _cfgs(solver, ssn, **kw)
    rng = np.random.default_rng(7)
    dm, ds = (np.asarray(m) for m in jmom.data_moments(
        jnp.asarray(rng.normal(0.5, 0.1, (32, 2)))))
    jstate = jmom.init_state(jcfg)
    gen_init = tgen.params_from_numpy(
        {k: np.asarray(v) for k, v in jstate.gen_params.items()}, dtype=F64)
    fixed = _replay_z(jcfg, jstate, None, 0) if jcfg.fixed_z else None
    tstate = tmom.init_state(tcfg, gen_init=gen_init, fixed_z=fixed)
    for step in range(2):
        key = jax.random.PRNGKey(50 + step)
        z = _replay_z(jcfg, jstate, key, step)
        jstate, jm = jmom.train_step(jcfg, jstate, jnp.asarray(dm),
                                     jnp.asarray(ds), key)
        tstate, tm = tmom.train_step_impl(
            tcfg, tstate, _t(dm), _t(ds),
            z=None if tcfg.fixed_z else z)
        _compare_state(tstate, jstate, rtol, f"{case} step {step}")
        for name, jv in jm._asdict().items():
            _close(getattr(tm, name), jv, rtol, what=f"{case} {name}")
    if case == "ift_zero_survivors_ema":
        assert float(tm.frac_converged) == 0
        assert float(tstate.ema_count) == 0  # held: no batch blended in
        assert not tstate.ema_mean.any()
    # the checkpoint round trip keeps the whole state, the z-set included
    ckpt = CheckpointManager(tmp_path / "ckpt")
    ckpt.save(tstate.step, tstate)
    back = ckpt.restore(tmom.init_state(tcfg, gen_init=gen_init,
                                        fixed_z=None if fixed is None
                                        else np.zeros_like(fixed)))
    assert back.step == tstate.step == 2
    _assert_same(back, tstate)


def _assert_same(a, b):
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        assert a._fields == b._fields
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_fixed_z_drawn_from_the_seed():
    _, tcfg = _cfgs(fixed_z=True, seed=3)
    a, b = tmom.init_state(tcfg), tmom.init_state(tcfg)
    assert a.fixed_z.shape == (4, 12, 12) and torch.equal(a.fixed_z,
                                                          b.fixed_z)
    c = tmom.init_state(dataclasses.replace(tcfg, seed=4))
    assert not torch.equal(a.fixed_z, c.fixed_z)
    assert tmom.init_state(dataclasses.replace(tcfg, fixed_z=False)
                           ).fixed_z is None
    with pytest.raises(ValueError, match="z= or generator="):
        tmom.train_step_impl(dataclasses.replace(tcfg, fixed_z=False), a,
                             torch.zeros(2, dtype=F64),
                             torch.zeros((2, 2), dtype=F64))
