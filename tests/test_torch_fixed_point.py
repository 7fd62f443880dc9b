"""Port parity: the lockstep fixed-point solver of ``tcgan_torch`` against
``tcgan_tpu.ops.fixed_point.solve_fixed_point`` in f64 on identical NumPy
inputs. Tolerance rtol 1e-10 (the same iteration, differing only in matmul
summation order), flags and iteration counts equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.ops import fixed_point as jfp
from tcgan_tpu.ops import ssn as jssn
from tcgan_tpu.ops import stimulus as jstim
from tcgan_tpu.ops import weights as jw
from tcgan_torch.ops import fixed_point as tfp
from tcgan_torch.ops import ssn as tssn

BASE = dict(N=8, k=0.01, n=2.2, dt=0.001, max_iter=4000, atol=1e-6)


def _problem(B=5, seed=11):
    """NumPy W (B, 2N, 2N) and battery I (2, 2N), as in
    tests/test_pallas_solver.py::_problem."""
    N = BASE["N"]
    z = np.random.default_rng(seed).standard_normal((B, 2 * N, 2 * N))
    x = np.linspace(-0.5, 0.5, N)
    W = jw.build_weight(np.array([[0.025, 0.02], [0.025, 0.015]]),
                        np.array([[0.1, 0.08], [0.1, 0.08]]),
                        np.array([[0.25, 0.1], [0.25, 0.1]]), z, x)
    I = jstim.stimulus_battery((0.25, 1.0), (5.0,), jnp.asarray(x), 0.03125)
    return np.asarray(W), np.asarray(I)


def _divergent_problem():
    """Hard divergers, shaped like tests/test_pallas_solver.py:41-51."""
    n2 = 8
    W = 5.0 * np.abs(np.random.default_rng(0).standard_normal((2, n2, n2)))
    return W, 30.0 * np.ones((1, n2))


CASES = {
    "plain": (dict(), dict(check_every=1)),
    "check8": (dict(), dict(check_every=8)),
    "feedforward": (dict(init="feedforward"), dict(check_every=4)),
    "anderson": (dict(accel="anderson"), dict(check_every=8)),
    "expo": (dict(stepper="expo", dt=0.004, max_iter=2000),
             dict(check_every=1)),
    "tanh": (dict(io_type="asym_tanh", rate_soft_bound=0.15,
                  rate_hard_bound=0.8, rate_stop_at=50.0),
             dict(check_every=2)),
    "linear": (dict(io_type="asym_linear", rate_soft_bound=0.15,
                    rate_stop_at=50.0), dict(check_every=2)),
    "diverge": (dict(N=4, k=0.05, n=2.0, max_iter=2000, rate_stop_at=100.0),
                dict(check_every=32)),
    "shared_W": (dict(), dict(check_every=4)),
    "r0": (dict(), dict(check_every=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lockstep_matches_jax_f64(case):
    cfg_kw, kw = CASES[case]
    kw = dict(kw)
    W, I = _divergent_problem() if case == "diverge" else _problem()
    if case == "shared_W":  # one W for all circuits, per-circuit inputs
        W, I = W[0], np.stack([I * (1.0 + 0.1 * b) for b in range(3)])
    r0_np = None
    if case == "r0":
        r0_np = np.random.default_rng(5).uniform(0.0, 0.5, I.shape)
    jcfg = jssn.SSNConfig(**{**BASE, **cfg_kw})
    tcfg = tssn.SSNConfig(**{**BASE, **cfg_kw})
    ref = jfp.solve_fixed_point(
        jcfg, jnp.asarray(W), jnp.asarray(I),
        r0=None if r0_np is None else jnp.asarray(r0_np), **kw)
    out = tfp.solve_fixed_point(
        tcfg, torch.tensor(W), torch.tensor(I),
        r0=None if r0_np is None else torch.tensor(r0_np), **kw)
    assert out.r.dtype == torch.float64
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.diverged.numpy(),
                                  np.asarray(ref.diverged))
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(out.r.numpy(), np.asarray(ref.r), rtol=1e-10)
    if case == "diverge":
        assert out.diverged.all() and torch.isfinite(out.r).all()
    else:
        assert out.converged.all()


def test_max_iter_clamp_and_unresolved():
    """A budget too small to converge leaves rows unresolved with iters ==
    max_iter, also when check_every does not divide max_iter."""
    W, I = _problem(B=2)
    cfg = tssn.SSNConfig(**{**BASE, "max_iter": 50})
    out = tfp.solve_fixed_point(cfg, torch.tensor(W), torch.tensor(I),
                                check_every=16)
    ref = jfp.solve_fixed_point(jssn.SSNConfig(**{**BASE, "max_iter": 50}),
                                jnp.asarray(W), jnp.asarray(I),
                                check_every=16)
    assert not (out.converged | out.diverged).any()
    assert (out.iters == 50).all()
    np.testing.assert_allclose(out.r.numpy(), np.asarray(ref.r), rtol=1e-10)


def test_solve_any_torch_backend_is_lockstep():
    W, I = _problem(B=3)
    cfg = dataclasses.replace(tssn.SSNConfig(**BASE), check_every=4)
    a = tfp.solve_any(cfg, torch.tensor(W), torch.tensor(I))
    b = tfp.solve_fixed_point(cfg, torch.tensor(W), torch.tensor(I),
                              check_every=4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
