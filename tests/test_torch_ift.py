"""Port parity for the implicit gradients: ``tcgan_torch.ops.ift`` against
``tcgan_tpu.ops.ift`` on the same NumPy inputs.

Tolerances:

- f64, lockstep forward (``xla`` against ``torch``): the ``direct`` and
  ``jfb`` gradients to rtol 1e-9; ``iterative`` to rtol 1e-7, because the
  global stop test may land one adjoint iteration apart when the two
  matmuls round differently (one iteration moves lam by at most
  ``bwd_atol`` = 1e-10 times the step gain);
- the check stride of the adjoint's stop test does not change the result
  (bit for bit);
- finite differences of the port's own loss: rtol 2e-3, as in
  ``tests/test_ift.py``;
- f32, the JAX Pallas kernel in interpret mode against the port's ``cuda``
  backend on CPU tensors (its plain fp32 version): rtol 2e-3 of the
  largest gradient entry, the forward rates agreeing to rtol 1e-4.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.ops import ift as jift
from tcgan_tpu.ops import ssn as jssn
from tcgan_tpu.ops import stimulus as jstim
from tcgan_tpu.ops import weights as jweights
from tcgan_torch.ops import ift as tift
from tcgan_torch.ops import ssn as tssn
from tcgan_torch.ops import stimulus as tstim
from tcgan_torch.ops import weights as tweights
from tcgan_torch.utils import profiling

SSN = dict(N=6, k=0.01, n=2.2, dt=0.001, max_iter=40000, atol=1e-9,
           check_every=8)
J0 = np.array([[0.08, 0.06], [0.09, 0.05]])
D0 = np.array([[0.2, 0.15], [0.2, 0.15]])
S0 = np.array([[0.25, 0.1], [0.25, 0.1]])
BW, CT = (0.25, 1.0), (5.0,)
BWD_ATOL = 1e-10


def _z(B=2, N=6, seed=3):
    return np.random.default_rng(seed).standard_normal((B, 2 * N, 2 * N))


def _jax_grads(cfg, z, grad_method, dtype=jnp.float64):
    x = cfg.site_pos(dtype=dtype)
    I = jstim.stimulus_battery(BW, CT, x, cfg.smoothness).astype(dtype)
    zj = jnp.asarray(z, dtype)

    def loss(params):
        W = jweights.build_weight(*params, zj, x)
        res = jift.solve_fixed_point_implicit(cfg, W, I,
                                              grad_method=grad_method,
                                              bwd_atol=BWD_ATOL)
        return (jnp.sum(res.r[..., cfg.N // 2] ** 2)
                + 0.1 * jnp.mean(res.r)), res.r

    params = tuple(jnp.asarray(p, dtype) for p in (J0, D0, S0))
    (_, r), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(r), [np.asarray(g) for g in grads]


def _torch_loss(cfg, z, grad_method, params, dtype=torch.float64,
                check_stride=tift.DEFAULT_CHECK_STRIDE):
    x = cfg.site_pos(dtype=dtype)
    I = tstim.stimulus_battery(BW, CT, x, cfg.smoothness).to(dtype)
    W = tweights.build_weight(*params, torch.tensor(z, dtype=dtype), x)
    res = tift.solve_fixed_point_implicit(
        cfg, W, I, grad_method=grad_method, bwd_atol=BWD_ATOL,
        check_stride=check_stride)
    loss = torch.sum(res.r[..., cfg.N // 2] ** 2) + 0.1 * torch.mean(res.r)
    return loss, res


def _torch_grads(cfg, z, grad_method, dtype=torch.float64, **kw):
    params = [torch.tensor(p, dtype=dtype, requires_grad=True)
              for p in (J0, D0, S0)]
    loss, res = _torch_loss(cfg, z, grad_method, params, dtype, **kw)
    loss.backward()
    return res.r.detach().numpy(), [p.grad.numpy() for p in params]


@pytest.mark.parametrize("grad_method,rtol", [("iterative", 1e-7),
                                              ("direct", 1e-9),
                                              ("jfb", 1e-9)])
def test_grad_methods_match_jax_f64(grad_method, rtol):
    z = _z()
    r_j, g_j = _jax_grads(jssn.SSNConfig(**SSN), z, grad_method)
    r_t, g_t = _torch_grads(tssn.SSNConfig(**SSN), z, grad_method)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-10)
    for a, b in zip(g_t, g_j):
        assert np.all(np.isfinite(a)) and np.abs(a).max() > 0
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


def _profiled_grads(cfg, z, **kw):
    """The gradients, and the stop test's host syncs the record counted
    under a profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _, g = _torch_grads(cfg, z, "iterative", **kw)
    return g, profiling.counters()["host_syncs.ift.stop_test"]


def test_adjoint_stride_does_not_change_result_and_counts():
    z = _z()
    cfg = tssn.SSNConfig(**SSN)
    tift.adjoint_iterations = 0
    g1, syncs1 = _profiled_grads(cfg, z, check_stride=1)
    iters1 = tift.adjoint_iterations
    tift.adjoint_iterations = 0
    g7, syncs7 = _profiled_grads(cfg, z, check_stride=7)
    assert tift.adjoint_iterations == iters1 > 0
    # stride 1 syncs once per iteration; stride 7 once per 7
    assert syncs1 == iters1
    assert syncs7 == -(-iters1 // 7)
    for a, b in zip(g1, g7):
        np.testing.assert_array_equal(a, b)


def test_ift_matches_finite_differences():
    z = _z()
    cfg = tssn.SSNConfig(**SSN)
    _, grads = _torch_grads(cfg, z, "iterative")
    eps = 1e-6
    for which, (a, b) in [(0, (0, 0)), (0, (1, 1)), (1, (0, 1)), (2, (1, 0))]:
        vals = []
        for sign in (1, -1):
            p = [torch.tensor(v, dtype=torch.float64) for v in (J0, D0, S0)]
            p[which][a, b] += sign * eps
            with torch.no_grad():
                vals.append(float(_torch_loss(cfg, z, "iterative", p)[0]))
        fd = (vals[0] - vals[1]) / (2 * eps)
        np.testing.assert_allclose(grads[which][a, b], fd, rtol=2e-3,
                                   atol=1e-7)


def test_size1_broadcast_cotangent_matches_jax():
    """I_ext (1, S, 2N) against W (B, 2N, 2N): the I_ext gradient keeps the
    size-1 axis and equals the sum over the batch, as in the reference."""
    z = _z()
    jcfg, tcfg = jssn.SSNConfig(**SSN), tssn.SSNConfig(**SSN)
    x = jcfg.site_pos(dtype=jnp.float64)
    W = jweights.build_weight(*(jnp.asarray(p) for p in (J0, D0, S0)),
                              jnp.asarray(z), x)
    I = jstim.stimulus_battery(BW, CT, x, jcfg.smoothness)[None]

    def jloss(I_in):
        res = jift.solve_fixed_point_implicit(jcfg, W, I_in,
                                              bwd_atol=BWD_ATOL)
        return jnp.sum(res.r ** 2)

    g_j = np.asarray(jax.grad(jloss)(I))
    Wt = torch.tensor(np.asarray(W))
    It = torch.tensor(np.asarray(I), requires_grad=True)
    res = tift.solve_fixed_point_implicit(tcfg, Wt, It, bwd_atol=BWD_ATOL)
    torch.sum(res.r ** 2).backward()
    assert It.grad.shape == It.shape == (1, 2, 12)
    np.testing.assert_allclose(It.grad.numpy(), g_j, rtol=1e-7)
    bar = torch.arange(24.0).reshape(2, 1, 12).expand(2, 3, 12)
    np.testing.assert_array_equal(
        tift._unbroadcast(bar, (1, 3, 12)).numpy(),
        np.asarray(jift._unbroadcast(jnp.asarray(bar.numpy()), (1, 3, 12))))


def test_diverged_samples_do_not_poison_gradient():
    cfg = tssn.SSNConfig(N=6, k=0.05, n=2.0, dt=0.001, max_iter=5000,
                         atol=1e-7, rate_stop_at=100.0, check_every=8)
    x = cfg.site_pos(dtype=torch.float64)
    z = torch.tensor(_z(B=3, seed=5))
    z[0, :, :cfg.N] = 200.0  # sample 0: huge E columns, I columns cut to 0
    z[0, :, cfg.N:] = -200.0
    I = tstim.stimulus_battery((1.0,), (5.0,), x, cfg.smoothness)
    J = torch.tensor(J0, requires_grad=True)
    W = tweights.build_weight(J, torch.tensor(D0), torch.tensor(S0), z, x)
    res = tift.solve_fixed_point_implicit(cfg, W, I)
    assert bool(res.diverged[0, 0]) and bool(res.converged[1:].all())
    torch.mean(res.r).backward()
    assert torch.isfinite(J.grad).all() and J.grad.abs().max() > 0


@pytest.mark.parametrize("grad_method", ["direct", "iterative", "jfb"])
def test_excluded_sample_nan_cannot_poison_backward(grad_method):
    """An excluded sample carrying NaN rates and an infinite cotangent is
    inert in every method; the port's backward equals the reference's."""
    z = _z()
    jcfg, tcfg = jssn.SSNConfig(**SSN), tssn.SSNConfig(**SSN)
    x = jcfg.site_pos(dtype=jnp.float64)
    W = jweights.build_weight(*(jnp.asarray(p) for p in (J0, D0, S0)),
                              jnp.asarray(z), x)
    I = jstim.stimulus_battery(BW, CT, x, jcfg.smoothness)
    res = jift.solve_fixed_point_implicit(jcfg, W, I)
    assert bool(res.converged.all())
    r_star = res.r.at[0].set(jnp.nan)
    converged = res.converged.at[0].set(False)
    g = jnp.ones_like(res.r).at[0].set(jnp.inf)
    jW, jI = jift._bwd(jcfg, grad_method, 2000, 1e-10,
                       (W, I, r_star, converged), SimpleNamespace(r=g))
    tW, tI = tift._bwd(
        tcfg, grad_method, 2000, 1e-10,
        tuple(torch.tensor(np.asarray(a)) for a in (W, I, r_star,
                                                    converged)),
        torch.tensor(np.asarray(g)))
    assert torch.isfinite(tW).all() and torch.isfinite(tI).all()
    assert float(tW[1].abs().max()) > 0
    np.testing.assert_allclose(tW.numpy(), np.asarray(jW), rtol=1e-7)
    np.testing.assert_allclose(tI.numpy(), np.asarray(jI), rtol=1e-7)


def test_kernel_backends_f32_match_jax_pallas():
    """f32: the JAX Pallas kernel (interpret mode, single phase) against
    the port's cuda backend on CPU tensors, i.e. its plain fp32 version."""
    z = _z()
    f32 = dict(SSN, max_iter=20000, atol=1e-6, check_every=8)
    jcfg = jssn.SSNConfig(**f32, backend="pallas", pallas_two_phase=False,
                          pallas_block_b=2)
    tcfg = tssn.SSNConfig(**f32, backend="cuda", pallas_two_phase=False)
    r_j, g_j = _jax_grads(jcfg, z, "iterative", dtype=jnp.float32)
    r_t, g_t = _torch_grads(tcfg, z, "iterative", dtype=torch.float32)
    assert r_t.dtype == np.float32
    np.testing.assert_allclose(r_t, r_j, rtol=1e-4, atol=1e-5)
    for a, b in zip(g_t, g_j):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2e-3 * np.abs(b).max())


def test_invalid_arguments_raise():
    cfg = tssn.SSNConfig(**SSN)
    W, I = torch.zeros((1, 12, 12)), torch.zeros((2, 12))
    with pytest.raises(ValueError, match="grad_method"):
        tift.solve_fixed_point_implicit(cfg, W, I, grad_method="exact")
    with pytest.raises(ValueError, match="check_stride"):
        tift._bwd(cfg, "iterative", 10, 1e-6,
                  (W, I, torch.zeros((1, 2, 12)),
                   torch.ones((1, 2), dtype=torch.bool)),
                  torch.ones((1, 2, 12)), check_stride=0)


# -- the cuda backend's iterative adjoint off the card ---------------------


def _saved(cfg, z, dtype=torch.float64):
    """The residuals of one solve and a cotangent: ((W, I, r, conv), g)."""
    x = cfg.site_pos(dtype=dtype)
    I = tstim.stimulus_battery(BW, CT, x, cfg.smoothness).to(dtype)
    W = tweights.build_weight(*(torch.tensor(p, dtype=dtype)
                                for p in (J0, D0, S0)),
                              torch.tensor(z, dtype=dtype), x)
    res = tift.solve_fixed_point_implicit(cfg, W, I, bwd_atol=BWD_ATOL)
    g = torch.randn(res.r.shape, dtype=dtype,
                    generator=torch.Generator().manual_seed(4))
    return (W, I, res.r, res.converged), g


def test_cuda_backend_on_cpu_tensors_runs_the_plain_loop():
    """CPU tensors take the plain loop whatever the backend: the same
    result and count as the ``torch`` backend's, every iteration eager, no
    kernel launch."""
    from tcgan_torch.ops.cuda import ift_adjoint

    cfg = tssn.SSNConfig(**SSN)
    saved, g = _saved(cfg, _z())
    out, counts = {}, {}
    for backend in ("torch", "cuda"):
        c = tssn.SSNConfig(**SSN, backend=backend)
        tift.adjoint_iterations = 0
        n0 = ift_adjoint.launches
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out[backend] = tift._bwd(c, "iterative", 20000, BWD_ATOL, saved,
                                     g, check_stride=16)
        counts[backend] = (tift.adjoint_iterations, profiling.counters())
        assert ift_adjoint.launches == n0
    for a, b in zip(out["torch"], out["cuda"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    n, rec = counts["cuda"]
    assert n == counts["torch"][0] > 0
    assert "ift.adjoint_kernel_launches" not in rec
    assert rec["ift.adjoint_eager_iterations"] == 16 * -(-n // 16)
    assert rec["host_syncs.ift.stop_test"] == -(-n // 16)


@pytest.mark.parametrize("entry", ["solve", "iterate"])
def test_adjoint_kernel_refuses_cpu_tensors(entry):
    """The kernel's entry points raise on CPU tensors before any launch or
    build, and run no plain loop in their place."""
    from tcgan_torch.ops.cuda import ift_adjoint

    cfg = tssn.SSNConfig(**SSN, backend="cuda")
    (W, I, r, conv), g = _saved(cfg, _z())
    phi = cfg.io_deriv()(tssn.recurrent_drive(W, r.to(W.dtype), I))
    alpha = cfg.step_gain(dtype=W.dtype)
    n0, lib = ift_adjoint.launches, ift_adjoint._library.cache_info()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="CUDA"):
            if entry == "solve":
                ift_adjoint.solve(W, phi, g, alpha, BWD_ATOL, 100)
            else:
                ift_adjoint.iterate(W, phi, g, alpha, g,
                                    torch.full((), 5), 5)
        assert profiling.counters() == {}
    assert ift_adjoint.launches == n0
    assert ift_adjoint._library.cache_info() == lib


class _OneRank:
    """A split of one rank: its max over ranks is the value itself."""

    model = None

    def max(self, x):
        return x


@pytest.mark.parametrize("stride", [1, 7, 64])
def test_chunk_over_ranks_plain_equals_unsplit(stride):
    """``_chunk_over_ranks`` on the plain loop, at a split of one rank,
    gives the unsplit loop's result and count bit for bit, per group (two
    members, one nearer criticality)."""
    cfg = tssn.SSNConfig(**SSN)
    z = _z()
    saved, g = _saved(cfg, z)
    W, I, r, conv = saved
    W2 = torch.stack([W, 1.3 * W])
    res = tift.solve_fixed_point_implicit(cfg, W2, I)
    saved2 = (W2, I, res.r, res.converged)
    g2 = torch.stack([g, g])
    out, n = [], []
    for split in (None, _OneRank()):
        tift.adjoint_iterations = 0
        out.append(tift._adjoint(cfg, "iterative", 20000, BWD_ATOL, saved2,
                                 g2, stride, 1, split=split))
        n.append(tift.adjoint_iterations)
    assert n[0] == n[1] > 0
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
