"""Port parity for the unrolled Euler solver (the BPTT path):
``tcgan_torch.ops.euler.solve_dynamics`` against
``tcgan_tpu.ops.euler.solve_dynamics`` on the same NumPy inputs (N=6, 2N=12,
3 stimuli, 4 circuits, one of them driven to divergence, seqlen <= 200).

Tolerances:

- float64 forward: r_T at rtol 1e-10 (atol 1e-12), converged / diverged
  flags and iters equal, the diverging circuit flagged on first exceedance;
- float64 BPTT gradients of a scalar loss with respect to W and I (and,
  through the generator, to log J, D, S) against ``jax.grad``: rtol 1e-8;
- chunked (``checkpoint_chunk``) against unchunked in torch: 1e-12;
- float32 forward and gradients: rtol 1e-5 (atol 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.models import generator as jgen
from tcgan_tpu.ops import euler as jeuler
from tcgan_tpu.ops import ssn as jssn
from tcgan_torch.models import generator as tgen
from tcgan_torch.ops import euler as teuler
from tcgan_torch.ops import ssn as tssn

SSN = dict(N=6, k=0.01, n=2.2, dt=0.001, atol=1e-3, rate_stop_at=200.0)
SEQLEN = 150


def _problem(seed=0):
    """W (4, 12, 12) with circuit 3 all-excitatory and strong (it runs
    away), I (3, 12), and a loss weight for r_T."""
    rng = np.random.default_rng(seed)
    n2 = 2 * SSN["N"]
    sign = np.r_[np.ones(SSN["N"]), -np.ones(SSN["N"])]
    W = np.abs(rng.normal(0.06, 0.03, (4, n2, n2))) * sign
    W[3] = np.abs(W[3]) * 4.0
    I = rng.uniform(2.0, 12.0, (3, n2))
    g = rng.normal(size=(4, 3, n2))
    return W, I, g


def _jax(W, I, g, dtype, **kw):
    cfg = jssn.SSNConfig(**SSN)

    def loss(W, I):
        res = jeuler.solve_dynamics(cfg, W, I, seqlen=SEQLEN, **kw)
        return jnp.sum(res.r * g), res

    (val, res), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(W, dtype), jnp.asarray(I, dtype))
    return res, grads


def _torch(W, I, g, dtype, **kw):
    cfg = tssn.SSNConfig(**SSN)
    Wt = torch.tensor(W, dtype=dtype, requires_grad=True)
    It = torch.tensor(I, dtype=dtype, requires_grad=True)
    res = teuler.solve_dynamics(cfg, Wt, It, seqlen=SEQLEN, **kw)
    grads = torch.autograd.grad((res.r * torch.tensor(g, dtype=dtype)).sum(),
                                [Wt, It])
    return res, grads


def _check(tres, jres, rtol, atol):
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(tres.diverged.numpy(),
                                  np.asarray(jres.diverged))
    np.testing.assert_array_equal(tres.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_allclose(tres.r.detach().numpy(), np.asarray(jres.r),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("chunk", [None, 50])
def test_forward_and_bptt_gradient_match_jax_f64(chunk):
    W, I, g = _problem()
    jres, jgrads = _jax(W, I, g, jnp.float64, checkpoint_chunk=chunk)
    tres, tgrads = _torch(W, I, g, torch.float64, checkpoint_chunk=chunk)
    _check(tres, jres, 1e-10, 1e-12)
    # circuit 3 runs away: flagged diverged on every row and clipped; the
    # others stay finite and below the ceiling
    assert tres.diverged[3].all() and not tres.diverged[:3].any()
    assert float(tres.r[3].detach().max()) == 10 * SSN["rate_stop_at"]
    assert tres.converged[:3].any() and not tres.converged[3].any()
    assert (tres.iters == SEQLEN).all() and tres.iters.dtype == torch.int32
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-8,
                                   atol=1e-12)


def test_first_exceedance_flags_a_transient():
    """Rows started above rate_stop_at decay below it and stay flagged (the
    flag is OR'd over steps, not read from the final state)."""
    W, I, _ = _problem()
    cfg = dataclasses.replace(tssn.SSNConfig(**SSN), rate_stop_at=3.0)
    jcfg = jssn.SSNConfig(**{**SSN, "rate_stop_at": 3.0})
    W = W[:3]
    r0 = np.full((3, 12), 5.0)
    res = teuler.solve_dynamics(cfg, torch.tensor(W), torch.tensor(I),
                                r0=torch.tensor(r0), seqlen=SEQLEN)
    jres = jeuler.solve_dynamics(jcfg, jnp.asarray(W), jnp.asarray(I),
                                 r0=jnp.asarray(r0), seqlen=SEQLEN)
    _check(res, jres, 1e-10, 1e-12)
    assert res.diverged.all() and not res.converged.any()
    assert float(res.r.max()) < 3.0


def test_chunked_equals_unchunked_in_torch():
    W, I, g = _problem(1)
    a, ga = _torch(W, I, g, torch.float64)
    b, gb = _torch(W, I, g, torch.float64, checkpoint_chunk=30)
    np.testing.assert_allclose(b.r.detach().numpy(), a.r.detach().numpy(),
                               rtol=1e-12, atol=0)
    assert torch.equal(a.diverged, b.diverged)
    for x, y in zip(gb, ga):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12,
                                   atol=1e-15)
    with pytest.raises(ValueError, match="must divide"):
        _torch(W, I, g, torch.float64, checkpoint_chunk=40)
    # no graph: the chunks are not checkpointed, same result
    with torch.no_grad():
        c = teuler.solve_dynamics(tssn.SSNConfig(**SSN), torch.tensor(W),
                                  torch.tensor(I), seqlen=SEQLEN,
                                  checkpoint_chunk=30)
    assert torch.equal(c.r, a.r.detach())


def test_float32_matches_jax():
    W, I, g = _problem(2)
    jres, jgrads = _jax(W, I, g, jnp.float32)
    tres, tgrads = _torch(W, I, g, torch.float32)
    assert tres.r.dtype == torch.float32
    _check(tres, jres, 1e-5, 1e-6)
    for t, j in zip(tgrads, jgrads):
        scale = float(np.abs(np.asarray(j)).max())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6 * scale)


def test_trajectory_and_initial_state_match_jax():
    W, I, _ = _problem(3)
    r0 = np.random.default_rng(4).uniform(0.0, 2.0, (3, 12))
    jres, jtraj = jeuler.solve_dynamics(
        jssn.SSNConfig(**SSN), jnp.asarray(W), jnp.asarray(I),
        r0=jnp.asarray(r0), seqlen=40, return_trajectory=True)
    tres, traj = teuler.solve_dynamics(
        tssn.SSNConfig(**SSN), torch.tensor(W), torch.tensor(I),
        r0=torch.tensor(r0), seqlen=40, return_trajectory=True)
    assert traj.shape == (40, 4, 3, 12) == jtraj.shape
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=1e-10,
                               atol=1e-12)
    assert torch.equal(traj[-1], tres.r)


def test_generator_bptt_gradient_matches_jax(monkeypatch):
    """d(mean tuning curve)/d(log J, D, S) through the generator's bptt
    branch, with remat chunks, against jax.grad (float64, rtol 1e-8)."""
    ssn = dict(N=6, max_iter=1500, atol=1e-5, dt=0.001, seqlen=SEQLEN)
    gen = dict(bandwidths=(0.25, 1.0), contrasts=(5.0,), solver="bptt",
               bptt_checkpoint_chunk=50)
    jcfg = jgen.GeneratorConfig(ssn=jssn.SSNConfig(**ssn), dtype=jnp.float64,
                                **gen)
    tcfg = tgen.GeneratorConfig(ssn=tssn.SSNConfig(**ssn),
                                dtype=torch.float64, **gen)
    J = ((0.02, 0.016), (0.02, 0.012))
    D = ((0.05, 0.04), (0.05, 0.04))
    S = ((0.25, 0.1), (0.25, 0.1))
    z = np.random.default_rng(5).standard_normal((3, 12, 12))
    monkeypatch.setattr(jgen.weights, "sample_z",
                        lambda key, shape, N, dtype=None: jnp.asarray(z))
    jp = jgen.init_params(jcfg, J, D, S)

    def jloss(p):
        out = jgen.sample_tuning_curves(jcfg, p, jax.random.PRNGKey(0), 3)
        return jnp.mean(out.tc), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: v.requires_grad_() for k, v in tgen.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()},
        dtype=torch.float64).items()}
    out = tgen.sample_tuning_curves(tcfg, tp, 3, z=z)
    tg = torch.autograd.grad(out.tc.mean(), list(tp.values()))
    np.testing.assert_allclose(out.tc.detach().numpy(), np.asarray(jout.tc),
                               rtol=1e-10)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(jout.converged))
    for k, t in zip(tp, tg):
        np.testing.assert_allclose(t.numpy(), np.asarray(jg[k]), rtol=1e-8,
                                   atol=1e-14, err_msg=k)
