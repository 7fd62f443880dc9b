"""Port parity for the latched late anchor gamma of the WGAN step
(``anchor_ema_switch_vel`` / ``anchor_ema_switch_drift``):
``tcgan_torch.models.wgan`` against ``tcgan_tpu.models.wgan`` over several
whole steps on replayed noise, in f64 on tiny shapes (N=6, 2 stimuli, batch
4, critic (16, 16)).

Each step is compared as in ``tests/test_torch_wgan.py`` (rtol 1e-6 on
parameters, optimizer moments, anchor EMAs and metrics: the generator
gradient comes through the iterative adjoint, whose global stop test may
land one iteration apart), plus the latch state: ``drift_dir`` and
``drift_mag`` at rtol 1e-6, the ``gamma_late`` latch equal at every step,
and the detector's statistic (the ``drift_ratio`` metric) at rtol 1e-6.
The velocity case fires at its arming step, as the reference does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.models import moments as jmom
from tcgan_tpu.models import wgan as jwgan
from tcgan_torch.models import wgan as twgan
from test_torch_wgan import (_cfgs, _close, _compare_opt, _port_state, _real,
                             _replay_noise, _t)

ANCHOR = dict(moment_anchor=1e-2, moment_ema=0.9, anchor_ema_late=0.5,
              anchor_drift_ema=0.9)
CASES = {
    # a threshold no statistic reaches from below: fires as soon as armed
    "vel_fires_at_arming": dict(anchor_ema_switch_vel=1e9,
                                anchor_ema_switch_step=2),
    "vel_raw_space": dict(anchor_ema_switch_vel=50.0),
    "drift_ratio": dict(anchor_ema_switch_drift=0.9),
}
N_STEPS = 3


def _data_moments():
    tc = np.random.default_rng(6).normal(0.5, 0.1, (32, 2))
    return tuple(np.asarray(m) for m in jmom.data_moments(jnp.asarray(tc)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_latched_steps_match_jax(case):
    kw = {**ANCHOR, **CASES[case]}
    jcfg, tcfg = _cfgs(**kw)
    if case == "vel_raw_space":
        jcfg = dataclasses.replace(jcfg, gen=dataclasses.replace(
            jcfg.gen, param_space="raw"))
        tcfg = dataclasses.replace(tcfg, gen=dataclasses.replace(
            tcfg.gen, param_space="raw"))
    dmom = _data_moments()
    jstate = jwgan.init_state(jcfg, data_moments=dmom)
    tstate = _port_state(jstate, tcfg, dmom)
    latched = []
    for step in range(N_STEPS):
        real = _real(jcfg, jcfg.n_critic, seed=30 + step)
        key = jax.random.PRNGKey(40 + step)
        noise = _replay_noise(jcfg, jcfg.n_critic, step, key,
                              jcfg.anchor_updates)
        jstate, jm = jwgan.train_step(jcfg, jcfg.n_critic, jstate,
                                      jnp.asarray(real), key)
        tstate, tm = twgan.train_step_impl(tcfg, jcfg.n_critic, tstate,
                                           _t(real), noise=noise)
        what = f"{case} step {step}"
        for k in tstate.gen_params:
            _close(tstate.gen_params[k], jstate.gen_params[k], 1e-6,
                   what=f"{what} gen {k}")
            _close(tstate.drift_dir[k], jstate.drift_dir[k], 1e-6,
                   what=f"{what} drift_dir {k}")
            _close(tstate.drift_mag[k], jstate.drift_mag[k], 1e-6,
                   what=f"{what} drift_mag {k}")
        _compare_opt(tstate.gen_opt, jstate.gen_opt, 1e-6, "gen_opt")
        _compare_opt(tstate.anchor_opt, jstate.anchor_opt, 1e-6,
                     "anchor_opt")
        for name in ("mom_ema_mean", "mom_ema_second", "mom_ema_count"):
            _close(getattr(tstate, name), getattr(jstate, name), 1e-6,
                   what=f"{what} {name}")
        assert tstate.gamma_late.dtype == torch.bool
        assert tstate.gamma_late.device == tstate.gen_params["J"].device
        assert bool(tstate.gamma_late) == bool(jstate.gamma_late), what
        latched.append(bool(tstate.gamma_late))
        for name, jv in jm._asdict().items():
            tv = getattr(tm, name)
            assert (tv is None) == (jv is None), name
            if tv is not None:
                _close(tv, jv, 1e-6, what=f"{what} metric {name}")
    if case == "vel_fires_at_arming":
        # armed at step 1 ((step + 1) >= 2): latched there, not before
        assert latched == [False, True, True]


def test_anchor_gamma_follows_the_latch():
    jcfg, tcfg = _cfgs(**ANCHOR, anchor_ema_switch_vel=1.0,
                       anchor_ema_switch_step=5)
    dmom = _data_moments()
    jstate = jwgan.init_state(jcfg, data_moments=dmom)
    tstate = _port_state(jstate, tcfg, dmom)
    for latch in (False, True):
        g_t = twgan.anchor_gamma(tcfg, tstate._replace(
            gamma_late=torch.tensor(latch)))
        g_j = jwgan.anchor_gamma(jcfg, jstate._replace(
            gamma_late=jnp.asarray(latch)))
        assert float(g_t) == float(g_j) == (0.5 if latch else 0.9)
    # off: the step switch, a host float
    _, plain = _cfgs(**ANCHOR, anchor_ema_switch_step=1)
    assert twgan.anchor_gamma(plain, tstate._replace(step=3)) == 0.5
