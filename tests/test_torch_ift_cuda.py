"""Implicit gradients through the SSN solver kernel and the adjoint kernel
on a CUDA device.

The gradient of the mean probe rate with respect to the log-space
(J, D, S), with the kernel forward against the plain forward (the lockstep
solve), as ``chip_smoke.py`` phase 5 does at 256 circuits; then the
adjoint kernel (``tcgan_torch.ops.cuda.ift_adjoint``, the ``cuda``
backend's iterative adjoint) against the plain loop (the ``torch``
backend's) on the same CUDA inputs, at the fit's shape, per ensemble
member, per cotangent, with W in device memory (at 2N=600, at 2N=102
past one wave of co-resident blocks, and at the paper's 2N=402 with the
fit's 256 circuits), in float64 and bfloat16, at the
iteration cap, with a non-finite sample and with excluded rows. Every test
carries the ``cuda`` marker and skips where no CUDA device is visible; the
file imports no jax:

    python -m pytest tests/test_torch_ift_cuda.py -m cuda -q

Tolerances: forward flags equal; gradients to 1e-2 of the largest entry
(the forward rates agree to rtol 1e-4, which the adjoint can amplify near
criticality; 2e-7 was measured at 256 circuits on an H100). Kernel against
plain loop in fp32: lam, W_bar and I_bar to ``ADJ_RTOL`` of the largest
entry, because only the mat-vec's summation order differs (FFMA chains
against cuBLAS's fp32 tiles) and the damped iteration carries that
rounding, ~1e-7 of lam an iteration, into a fixed point it contracts
toward; iterations per group equal. Kernel against kernel (chunked
against unsplit): bit for bit.
"""

import dataclasses

import pytest
import torch

from tcgan_torch.models import generator as gen_lib
from tcgan_torch.ops import fixed_point, ift, weights
from tcgan_torch.ops.cuda import ift_adjoint
from tcgan_torch.ops.ssn import SSNConfig, recurrent_drive
from tcgan_torch.utils import profiling

TRUE = (((0.045, 0.04), (0.05, 0.035)), ((0.1, 0.08), (0.1, 0.08)),
        ((0.25, 0.1), (0.25, 0.1)))
GEN = dict(bandwidths=(0.0, 0.0625, 0.125, 0.1875, 0.25, 0.5, 0.75, 1.0),
           contrasts=(5.0, 10.0))
ADJ_RTOL = 1e-4
BWD_ATOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _grads(device, backend, B=16):
    cfg = gen_lib.GeneratorConfig(
        ssn=SSNConfig(N=51, max_iter=10000, atol=1e-5, check_every=32,
                      backend=backend), **GEN)
    params = {k: v.requires_grad_(True) for k, v in
              gen_lib.init_params(cfg, *TRUE, device=device).items()}
    z = weights.sample_z(torch.Generator(device).manual_seed(0), (B,), 51,
                         device=device)
    out = gen_lib.sample_tuning_curves(cfg, params, B, z=z)
    g = torch.autograd.grad(out.tc.mean(), list(params.values()))
    torch.cuda.synchronize()
    return out, torch.cat([t.reshape(-1) for t in g])


@pytest.mark.cuda
def test_kernel_forward_gradients_match_plain_forward(cuda_device):
    ift.adjoint_iterations = 0
    # the stop test's syncs are counted while a profiler runs
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out_k, g_k = _grads(cuda_device, "cuda")
    iters = ift.adjoint_iterations
    syncs = profiling.counters()["host_syncs.ift.stop_test"]
    out_p, g_p = _grads(cuda_device, "torch")
    assert out_k.rates.dtype == torch.float32
    assert torch.equal(out_k.converged, out_p.converged)
    assert out_k.converged.all()
    assert torch.isfinite(g_k).all() and g_k.abs().max() > 0
    assert float((g_k - g_p).abs().max()) <= 1e-2 * float(g_p.abs().max())
    # the adjoint kernel: one read of its iteration count a backward
    assert iters > 0 and syncs == 1


@pytest.mark.cuda
def test_adjoint_stride_does_not_change_gradient_on_card(cuda_device):
    cfg = SSNConfig(N=51, max_iter=10000, atol=1e-5, check_every=32,
                    backend="cuda")
    gcfg = gen_lib.GeneratorConfig(ssn=cfg, **GEN)
    z = weights.sample_z(torch.Generator(cuda_device).manual_seed(1), (8,),
                         51, device=cuda_device)
    with torch.no_grad():
        J, D, S = gen_lib.param_values(
            gcfg, gen_lib.init_params(gcfg, *TRUE, device=cuda_device))
        W = weights.build_weight(J, D, S, z, cfg.site_pos(device=cuda_device))
        I = gcfg.stimulus_battery(cuda_device)
    res = ift.solve_fixed_point_implicit(cfg, W, I)
    g = torch.randn(res.r.shape, generator=torch.Generator(
        cuda_device).manual_seed(2), device=cuda_device) * 1e-3
    saved = (W, I, res.r, res.converged)
    for c in (cfg, dataclasses.replace(cfg, backend="torch")):
        a = ift._bwd(c, "iterative", 20000, 1e-6, saved, g, check_stride=1)
        b = ift._bwd(c, "iterative", 20000, 1e-6, saved, g,
                     check_stride=100)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# -- the adjoint kernel against the plain loop -----------------------------


def _fixed_point(device, B, N=51, lead=(), factors=None, seed=0):
    """The SSN fixed point of ``lead + (B,)`` circuits at the round-2
    truth (J and D scaled by 51 / N), member m's W scaled by
    ``factors[m]``: (cfg with the cuda backend, W, I, rates, converged)."""
    cfg = SSNConfig(N=N, max_iter=10000, atol=1e-5, check_every=32,
                    backend="cuda")
    gcfg = gen_lib.GeneratorConfig(ssn=cfg, **GEN)
    J0, D0, S0 = (torch.tensor(p) for p in TRUE)
    z = weights.sample_z(torch.Generator(device).manual_seed(seed),
                         lead + (B,), N, device=device)
    with torch.no_grad():
        J, D, S = gen_lib.param_values(gcfg, gen_lib.init_params(
            gcfg, (J0 * 51 / N).tolist(), (D0 * 51 / N).tolist(),
            S0.tolist(), device=device))
        W = weights.build_weight(J, D, S, z, cfg.site_pos(device=device))
        if factors is not None:
            W = W * torch.tensor(factors, device=device).reshape(
                (-1,) + (1,) * (W.ndim - 1))
        I = gcfg.stimulus_battery(device)
        res = fixed_point.solve_any(cfg, W, I)
    return cfg, W, I, res.r, res.converged


def _cotangent(device, shape, seed=2):
    return torch.randn(shape, generator=torch.Generator(device).manual_seed(
        seed), device=device) * 1e-3


def _adjoint(cfg, backend, saved, g, group_axes=0, max_iter=20000,
             atol=BWD_ATOL):
    """(W_bar, phi * lam, I_bar, iterations) of one adjoint."""
    ift.adjoint_iterations = 0
    W_bar, philam = ift._adjoint(dataclasses.replace(cfg, backend=backend),
                                 "iterative", max_iter, atol, saved, g,
                                 ift.DEFAULT_CHECK_STRIDE, group_axes)
    torch.cuda.synchronize()
    I_bar = ift._unbroadcast(philam, saved[1].shape)
    return W_bar, philam, I_bar, ift.adjoint_iterations


def _assert_close(a, b, rtol=ADJ_RTOL):
    assert torch.isfinite(b).all()
    err = float((a - b).abs().max())
    assert err <= rtol * float(b.abs().max()), (err, float(b.abs().max()))


def _assert_match(kernel, plain):
    for a, b in zip(kernel[:3], plain[:3]):
        _assert_close(a, b)
    assert kernel[3] == plain[3] > 0


@pytest.mark.cuda
def test_adjoint_kernel_matches_plain_loop_at_fit_shape(cuda_device):
    """B=256 circuits of S=16 rows at 2N=102, one group: the fit's
    adjoint, W in shared memory."""
    cfg, W, I, r, conv = _fixed_point(cuda_device, 256)
    saved = (W, I, r, conv)
    g = _cotangent(cuda_device, r.shape)
    assert ift_adjoint.query(256, 16, 102, device=cuda_device).w_shared
    _assert_match(_adjoint(cfg, "cuda", saved, g),
                  _adjoint(cfg, "torch", saved, g))


def _members(device, factors, exact: bool):
    """Members of 16 circuits, member m's W scaled by ``factors[m]``: the
    kernel's count per member against the plain loop's solo count for that
    member (equal, or within one), and its lam against that solo loop's."""
    cfg, W, I, r, conv = _fixed_point(device, 16, lead=(len(factors),),
                                      factors=factors)
    g = _cotangent(device, r.shape)
    k = _adjoint(cfg, "cuda", (W, I, r, conv), g, group_axes=1)
    ok = conv[..., None]
    _, iters, _ = ift_adjoint.solve(
        W, torch.where(ok, cfg.io_deriv()(recurrent_drive(W, r, I)), 0.0),
        torch.where(ok, g, 0.0), cfg.step_gain(device=W.device), BWD_ATOL,
        20000, group_axes=1)
    solo = [_adjoint(cfg, "torch", (W[m], I, r[m], conv[m]), g[m])
            for m in range(len(factors))]
    n_solo = [n for *_, n in solo]
    assert len(set(n_solo)) > 1
    if exact:
        assert iters.tolist() == n_solo
    else:
        assert all(abs(a - b) <= 1 for a, b in zip(iters.tolist(), n_solo))
    assert k[3] == max(iters.tolist())
    for m in range(len(factors)):
        _assert_close(k[0][m], solo[m][0])
        _assert_close(k[1][m], solo[m][1])
    return n_solo


@pytest.mark.cuda
def test_adjoint_kernel_stops_each_ensemble_member_on_its_own(cuda_device):
    """8 members whose adjoints stop at different iterations (the plain
    loop's residual falls by 1% or more an iteration): the same count per
    member as each member's solo plain loop."""
    n = _members(cuda_device, [0.6 + 0.06 * m for m in range(8)], exact=True)
    assert max(n) < 1000


@pytest.mark.cuda
def test_adjoint_kernel_near_critical_members_within_one_iteration(
        cuda_device):
    """Members near criticality, whose residual falls by ~0.3% an
    iteration over 1,000-3,000 iterations: the mat-vec's rounding (another
    summation order, ~1e-4 of the residual at the stop) can move the
    crossing of bwd_atol by one iteration; lam stays within tolerance."""
    n = _members(cuda_device, [1.15, 1.22, 1.29], exact=False)
    assert max(n) > 1000


@pytest.mark.cuda
def test_adjoint_kernel_per_cotangent_groups(cuda_device):
    """``vjp_W_batched``: one launch for 4 cotangents, each its own group,
    each equal to its own plain backward."""
    cfg, W, I, r, conv = _fixed_point(cuda_device, 32)
    res = fixed_point.FixedPointResult(r, conv, ~conv, None)
    g = _cotangent(cuda_device, (4,) + tuple(r.shape))
    g[1] *= 1e-3  # converges in fewer iterations than the others
    n0 = ift_adjoint.launches
    bars = ift.vjp_W_batched(cfg, W, I, res, g)
    assert ift_adjoint.launches == n0 + 1
    for c in range(4):
        solo = _adjoint(cfg, "torch", (W, I, r, conv), g[c])
        _assert_close(bars[c], solo[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["2N=600", "2N=102 past one wave"])
def test_adjoint_kernel_with_w_in_device_memory(cuda_device, shape):
    """W read from device memory, against the plain loop: at 2N=600, where
    a circuit's W does not fit a block's shared memory, and at the fit's
    2N=102 with more circuits (5 an SM) than the co-resident blocks of the
    shared-memory path hold."""
    if shape == "2N=600":
        N, B = 300, 4
    else:
        N = 51
        B = 5 * torch.cuda.get_device_properties(
            cuda_device).multi_processor_count
    cfg, W, I, r, conv = _fixed_point(cuda_device, B, N=N)
    assert not ift_adjoint.query(B, I.shape[0], 2 * N,
                                 device=cuda_device).w_shared
    assert conv.any()
    g = _cotangent(cuda_device, r.shape)
    _assert_match(_adjoint(cfg, "cuda", (W, I, r, conv), g),
                  _adjoint(cfg, "torch", (W, I, r, conv), g))


@pytest.mark.cuda
def test_adjoint_kernel_at_the_paper_width_and_fit_batch(cuda_device):
    """The round-2 fit's adjoint at the paper's width: C=256 circuits of
    S=16 rows at 2N=402, one group. A circuit's W (646 KB) passes a
    block's shared memory, so the plan reads W from device memory and the
    occupancy-sized cooperative grid walks the 256 circuits; against the
    plain loop, iterations equal. Under a profiler the launch counts as
    one that reads W from device memory, beside the adjoint's rows and
    circuits at 2N=402."""
    cfg, W, I, r, conv = _fixed_point(cuda_device, 256, N=201)
    plan = ift_adjoint.query(256, 16, 402, device=cuda_device)
    assert not plan.w_shared
    assert plan.grid * plan.circuits_per_block >= 256
    assert float(conv.float().mean()) > 0.5
    g = _cotangent(cuda_device, r.shape)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        k = _adjoint(cfg, "cuda", (W, I, r, conv), g)
    counts = profiling.counters()
    assert counts["ift.adjoint_kernel_launches"] == 1
    assert counts["ift.adjoint_w_device_launches"] == 1
    assert counts["ift.adjoint_rows.402"] == 256 * 16
    assert counts["ift.adjoint_circuits.402"] == 256
    _assert_match(k, _adjoint(cfg, "torch", (W, I, r, conv), g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_adjoint_kernel_in_w_dtype(cuda_device, dtype):
    """The backward runs in W's dtype: float64 in float64, against the
    plain loop in float64 (1e-10 of the largest entry: only the summation
    order differs), iterations equal; bfloat16 in float32, as the solver
    kernel runs it, its result bfloat16 and within bfloat16's rounding
    (2e-2 of the largest entry) of the float32 adjoint."""
    cfg, W, I, r, conv = _fixed_point(cuda_device, 16)
    g = _cotangent(cuda_device, r.shape)
    saved = (W.to(dtype), I.to(dtype), r, conv)
    k = _adjoint(cfg, "cuda", saved, g.to(dtype))
    assert k[0].dtype == k[1].dtype == dtype and k[3] > 0
    if dtype == torch.float64:
        p = _adjoint(cfg, "torch", saved, g.to(dtype))
        for a, b in zip(k[:3], p[:3]):
            _assert_close(a, b, rtol=1e-10)
        assert k[3] == p[3]
    else:
        ref = _adjoint(cfg, "cuda", (W, I, r, conv), g)
        for a, b in zip(k[:3], ref[:3]):
            _assert_close(a.float(), b, rtol=2e-2)


@pytest.mark.cuda
def test_adjoint_kernel_stops_at_max_iter(cuda_device):
    """A cap below the stop rule's count: both run exactly the cap."""
    cfg, W, I, r, conv = _fixed_point(cuda_device, 16)
    g = _cotangent(cuda_device, r.shape)
    saved = (W, I, r, conv)
    k = _adjoint(cfg, "cuda", saved, g, max_iter=50)
    p = _adjoint(cfg, "torch", saved, g, max_iter=50)
    assert k[3] == p[3] == 50
    _assert_match(k, p)


@pytest.mark.cuda
def test_adjoint_kernel_non_finite_sample_stops_its_group(cuda_device):
    """A trusted sample whose cotangent is NaN: its lam turns NaN on the
    first iteration, which stops its member there, as in the plain loop;
    the other member runs on unharmed."""
    cfg, W, I, r, conv = _fixed_point(cuda_device, 8, lead=(2,))
    g = _cotangent(cuda_device, r.shape)
    assert conv[0, 3, 5]
    g[0, 3, 5, 7] = float("nan")
    saved = (W, I, r, conv)
    k = _adjoint(cfg, "cuda", saved, g, group_axes=1)
    solo = [_adjoint(cfg, "torch", (W[m], I, r[m], conv[m]), g[m])
            for m in range(2)]
    assert solo[0][3] == 1 and solo[1][3] > 1
    assert k[3] == solo[1][3]
    assert torch.equal(k[1][0].isnan(), solo[0][1].isnan())
    assert k[1][0].isnan().any()
    _assert_close(k[1][1], solo[1][1])
    _assert_close(k[0][1], solo[1][0])


@pytest.mark.cuda
def test_adjoint_kernel_excluded_rows_are_inert(cuda_device):
    """Rows flagged unconverged, their rates NaN: zero adjoint there, the
    rest the plain loop's."""
    cfg, W, I, r, conv = _fixed_point(cuda_device, 32)
    conv = conv.clone()
    conv[::3, ::2] = False
    r = torch.where(conv[..., None], r, float("nan"))
    g = _cotangent(cuda_device, r.shape)
    k = _adjoint(cfg, "cuda", (W, I, r, conv), g)
    _assert_match(k, _adjoint(cfg, "torch", (W, I, r, conv), g))
    assert torch.isfinite(k[1]).all()
    assert (k[1][~conv] == 0).all()


@pytest.mark.cuda
def test_adjoint_is_one_launch_and_one_sync(cuda_device):
    cfg, W, I, r, conv = _fixed_point(cuda_device, 16)
    g = _cotangent(cuda_device, r.shape)
    n0 = ift_adjoint.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ift._bwd(cfg, "iterative", 20000, BWD_ATOL, (W, I, r, conv), g)
        torch.cuda.synchronize()
    counts = profiling.counters()
    assert ift_adjoint.launches == n0 + 1
    assert counts["ift.adjoint_kernel_launches"] == 1
    assert counts["host_syncs.ift.stop_test"] == 1
    assert "ift.adjoint_eager_iterations" not in counts
    # the fit's 2N=102: W in shared memory
    assert "ift.adjoint_w_device_launches" not in counts
    assert counts["ift.adjoint_rows.102"] == 16 * 16


class _OneRank:
    """A split of one rank: its max over ranks is the value itself."""

    model = None

    def max(self, x):
        return x


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [7, 64])
def test_adjoint_kernel_chunks_over_ranks_equal_unsplit(cuda_device,
                                                        stride):
    """``_chunk_over_ranks`` through the kernel (count mode: the chunk,
    the all-reduce, the replay) gives the unsplit kernel's lam and count
    bit for bit, per member; no iteration runs eagerly."""
    cfg, W, I, r, conv = _fixed_point(cuda_device, 16, lead=(2,),
                                      factors=[0.9, 1.2])
    g = _cotangent(cuda_device, r.shape)
    saved = (W, I, r, conv)
    k = _adjoint(cfg, "cuda", saved, g, group_axes=1)
    ift.adjoint_iterations = 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        W_bar, philam = ift._adjoint(cfg, "iterative", 20000, BWD_ATOL,
                                     saved, g, stride, 1, split=_OneRank())
        torch.cuda.synchronize()
    counts = profiling.counters()
    assert ift.adjoint_iterations == k[3]
    assert torch.equal(W_bar, k[0]) and torch.equal(philam, k[1])
    assert counts["ift.adjoint_kernel_launches"] >= -(-k[3] // stride)
    assert "ift.adjoint_eager_iterations" not in counts
