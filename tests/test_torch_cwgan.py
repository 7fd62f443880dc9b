"""Port parity for the conditional WGAN: ``tcgan_torch.models.cwgan`` against
``tcgan_tpu.models.cwgan`` on the same NumPy inputs, in f64 on tiny shapes
(N=6, 2 bandwidths x 2 contrasts, batch 3, critic (16, 16)).

Tolerances (f64):

- tagging, row weights: exact (rtol 0);
- the critic loss, its aux values and its gradient: rtol 1e-10;
- one whole ``train_step_impl`` on replayed noise (see
  ``tests/test_torch_wgan.py``): rtol 1e-6 on the ``ift`` path (the
  iterative adjoint's global stop test may land one iteration apart) and
  1e-8 on the ``bptt`` path (an exact unrolled gradient on both sides), on
  parameters, optimizer moments, anchor EMAs and metrics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.models import cwgan as jcw
from tcgan_tpu.models import generator as jgen
from tcgan_tpu.models import moments as jmom
from tcgan_tpu.ops import ssn as jssn
from tcgan_torch.models import cwgan as tcw
from tcgan_torch.models import generator as tgen
from tcgan_torch.ops import ssn as tssn
from test_torch_wgan import (_close, _compare_opt, _port_state, _replay_noise,
                             _t)

SSN = dict(N=6, k=0.005, n=2.0, dt=0.001, max_iter=3000, atol=1e-5,
           check_every=8, seqlen=150)
GEN = dict(bandwidths=(0.25, 1.0), contrasts=(5.0, 10.0), sample_sites=1)
CW = dict(critic_layers=(16, 16), batch_size=3, n_critic=2, n_critic0=2,
          clip_grad=1.0)
F64 = torch.float64
S_TOTAL = 4  # conditions


def _cfgs(solver="ift", **kw):
    jg = jgen.GeneratorConfig(ssn=jssn.SSNConfig(**SSN), dtype=jnp.float64,
                              solver=solver, **GEN)
    tg = tgen.GeneratorConfig(ssn=tssn.SSNConfig(**SSN), dtype=F64,
                              solver=solver, **GEN)
    kw = {**CW, **kw}
    return jcw.CWGANConfig(gen=jg, **kw), tcw.CWGANConfig(gen=tg, **kw)


def _tagged_real(jcfg, n, seed):
    """(n, B*S, P + 2) condition-tagged real rows."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(1.0, 0.1, (n * jcfg.batch_size, S_TOTAL, 1))
    tagged = np.asarray(jcw.tag_with_conditions(jcfg, jnp.asarray(raw)))
    return tagged.reshape(n, jcfg.critic_batch, -1)


def test_config_tagging_and_row_weights_match_jax():
    scale = tuple(np.linspace(0.5, 2.0, S_TOTAL + 2))
    jcfg, tcfg = _cfgs(cond_input_scale=scale,
                       cond_weight=(0.5, 1.5, 0.5, 1.5),
                       reject_unconverged=True)
    assert [f.name for f in dataclasses.fields(tcw.CWGANConfig)] == \
        [f.name for f in dataclasses.fields(jcw.CWGANConfig)]
    assert tcfg.critic_batch == jcfg.critic_batch == 3 * S_TOTAL
    assert tcfg.critic_cfg.in_dim == jcfg.critic_cfg.in_dim == 3
    assert tcfg.critic_cfg.input_scale is None
    raw = np.random.default_rng(0).normal(size=(3, S_TOTAL, 1))
    for cfg_pair in ((jcfg, tcfg), _cfgs()):
        _close(tcw.tag_with_conditions(cfg_pair[1], _t(raw)),
               jcw.tag_with_conditions(cfg_pair[0], jnp.asarray(raw)), 0)
    _close(tcw.cond_row_weights(tcfg, 12, F64),
           jcw.cond_row_weights(jcfg, 12, jnp.float64), 0)
    assert tcw.cond_row_weights(_cfgs()[1], 12) is None

    class Out:  # the generator output's converged flags only
        def __init__(self, conv):
            self.converged = conv

    some = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 0, 0]], bool)
    none = np.array([[1, 0, 1, 1], [0, 1, 1, 1], [0, 0, 0, 0]], bool)
    for conv in (some, none):  # per circuit, then the per-solve fallback
        _close(tcw.fake_row_weights(tcfg, Out(torch.tensor(conv))),
               jcw.fake_row_weights(jcfg, Out(jnp.asarray(conv))), 0)
    assert tcw.fake_row_weights(_cfgs()[1], Out(torch.tensor(some))) is None


@pytest.mark.parametrize("weighted", [False, True])
def test_critic_loss_matches_jax(monkeypatch, weighted):
    kw = dict(cond_weight=(0.5, 1.5, 0.5, 1.5)) if weighted else {}
    jcfg, tcfg = _cfgs(**kw)
    jstate = jcw.init_state(jcfg)
    cp_np = {k: np.asarray(v) for k, v in jstate.critic_params.items()}
    rng = np.random.default_rng(4)
    real = _tagged_real(jcfg, 1, 1)[0]
    fake = real + rng.normal(0.0, 0.2, real.shape)
    eps = rng.uniform(size=(real.shape[0], 1))
    fake_w = (np.repeat([1.0, 0.0, 1.0], S_TOTAL) if weighted else None)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None: jnp.asarray(eps))
    (jl, jaux), jg = jax.value_and_grad(
        lambda cp: jcw.critic_loss_fn(
            jcfg, cp, jnp.asarray(real), jnp.asarray(fake),
            jax.random.PRNGKey(0),
            fake_w=None if fake_w is None else jnp.asarray(fake_w)),
        has_aux=True)(jstate.critic_params)
    leaves = {k: _t(v).requires_grad_() for k, v in cp_np.items()}
    tl, taux = tcw.critic_loss_fn(
        tcfg, leaves, _t(real), _t(fake), _t(eps),
        fake_w=None if fake_w is None else _t(fake_w))
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    _close(tl, jl, 1e-10)
    for a, b in zip(taux, jaux):
        _close(a, b, 1e-10)
    for k in cp_np:
        _close(tg[k], jg[k], 1e-10, what=k)


STEP_CASES = {
    "ift": ("ift", dict(), 1e-6),
    # per-condition scale and weights, rejection and the moment anchor on
    # the joint per-circuit vector
    "ift_weighted_anchor": ("ift", dict(
        cond_input_scale=tuple(np.linspace(0.5, 2.0, S_TOTAL + 2)),
        cond_weight=(0.5, 1.5, 0.5, 1.5), reject_unconverged=True,
        moment_anchor=1e-2, moment_ema=0.9), 1e-6),
    "bptt": ("bptt", dict(reject_unconverged=True), 1e-8),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    solver, kw, rtol = STEP_CASES[case]
    jcfg, tcfg = _cfgs(solver, **kw)
    dmom = None
    if jcfg.moment_anchor > 0:
        tc = np.random.default_rng(6).normal(0.5, 0.1, (32, S_TOTAL))
        dmom = tuple(np.asarray(m) for m in jmom.data_moments(
            jnp.asarray(tc)))
    jstate = jcw.init_state(jcfg, data_moments=dmom)
    tstate = _port_state(jstate, tcfg, dmom)
    n_critic = jcfg.n_critic
    real = _tagged_real(jcfg, n_critic, 10)
    key = jax.random.PRNGKey(20)
    noise = _replay_noise(jcfg, n_critic, 0, key,
                          jcfg.anchor_updates if dmom else 0)
    assert noise.gp_eps[0].shape == (jcfg.critic_batch, 1)
    jstate, jm = jcw.train_step(jcfg, n_critic, jstate, jnp.asarray(real),
                                key)
    tstate, tm = tcw.train_step_impl(tcfg, n_critic, tstate, _t(real),
                                     noise=noise)
    assert tstate.step == int(jstate.step) == 1
    for name in ("gen_params", "critic_params"):
        tp, jp = getattr(tstate, name), getattr(jstate, name)
        for k in tp:
            _close(tp[k], jp[k], rtol, what=f"{case} {name} {k}")
    _compare_opt(tstate.gen_opt, jstate.gen_opt, rtol, "gen_opt")
    _compare_opt(tstate.critic_opt, jstate.critic_opt, rtol, "critic_opt")
    if dmom:
        _compare_opt(tstate.anchor_opt, jstate.anchor_opt, rtol, "anchor_opt")
        for name in ("mom_ema_mean", "mom_ema_second", "mom_ema_count"):
            _close(getattr(tstate, name), getattr(jstate, name), rtol,
                   what=name)
    for name, jv in jm._asdict().items():
        tv = getattr(tm, name)
        assert (tv is None) == (jv is None), name
        if tv is not None:
            _close(tv, jv, rtol, what=f"{case} metric {name}")
    if solver == "bptt":
        # 150 steps leave some rows above atol and no circuit fully
        # converged: the rejection runs on its per-solve fallback
        assert 0 < float(tm.frac_converged) < 1
        assert float(tm.circuit_yield) == 0
    else:
        assert float(tm.frac_converged) == 1


def test_train_step_draws_from_generator():
    _, tcfg = _cfgs()
    real = _t(_tagged_real(_cfgs()[0], 2, 3))
    outs = []
    for _ in range(2):
        state = tcw.init_state(tcfg)
        outs.append(tcw.train_step(tcfg, 2, state, real,
                                   generator=torch.Generator().manual_seed(7)))
    for k in outs[0][0].gen_params:
        assert torch.equal(outs[0][0].gen_params[k],
                           outs[1][0].gen_params[k])
    assert torch.isfinite(outs[0][1].d_loss)
