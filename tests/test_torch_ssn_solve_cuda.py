"""The SSN solver kernel on a CUDA device against its plain torch version.

Every test here carries the ``cuda`` marker and skips where no CUDA device
is visible. The file imports no jax, so the machine with the card runs it
as it is:

    python -m pytest tests/test_torch_ssn_solve_cuda.py -m cuda -q

Tolerance: flags equal, rates rtol 1e-4 atol 1e-5 (the kernel-vs-lockstep
tolerance of tests/test_pallas_solver.py), iters within two check strides
(the mat-vec summation order differs, which can move the atol crossing by a
chunk).

The tests from before the two-phase schedule run one phase
(``pallas_two_phase=False``; ``ab.problem`` does so by default); the
two-phase tests hold the kernel to the plain version with the fast pass
(phase 1, and the refinement tail's ``W e``) in emulated TF32
(``ssn_solve.drive_1xtf32``), at every path of the kernel, with the
refinement tail (the default) and with the 3xTF32 tail. With
``SSN_SOLVE_BASELINE`` set to an earlier ``ssn_solve.cu`` that has the
two-phase schedule and no refinement tail (a source from before the
tail), ``test_refine_off_is_the_baseline_two_phase`` holds the 3xTF32 tail
bit for bit to that build's two phases.
"""

import ctypes
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tcgan_torch.ops import stimulus, weights
from tcgan_torch.ops.cuda import ssn_solve
from tcgan_torch.ops.ssn import SSNConfig
from tcgan_torch.tools import ssn_solve_ab as ab
from tcgan_torch.utils import profiling

BASE = dict(N=8, k=0.01, n=2.2, dt=0.001, max_iter=4000, atol=1e-6,
            pallas_two_phase=False)
RTOL, ATOL = 1e-4, 1e-5
SATURATING = dict(rate_soft_bound=0.15, rate_hard_bound=0.8,
                  rate_stop_at=50.0)
CASES = {
    # name: (SSNConfig overrides, check_every, accel)
    "plain": ({}, 1, False),
    "check8": ({}, 8, False),
    "asym_tanh": (dict(io_type="asym_tanh", **SATURATING), 4, False),
    "asym_linear": (dict(io_type="asym_linear", **SATURATING), 4, False),
    "expo": (dict(stepper="expo", dt=0.004, max_iter=2000), 4, False),
    "feedforward": (dict(init="feedforward"), 4, False),
    "anderson": ({}, 8, True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(device, B=5, seed=11):
    N = BASE["N"]
    z = np.random.default_rng(seed).standard_normal((B, 2 * N, 2 * N))
    x = torch.linspace(-0.5, 0.5, N, device=device)
    t = lambda v: torch.tensor(v, device=device)  # noqa: E731
    W = weights.build_weight(t([[0.025, 0.02], [0.025, 0.015]]),
                             t([[0.1, 0.08], [0.1, 0.08]]),
                             t([[0.25, 0.1], [0.25, 0.1]]),
                             torch.tensor(z, dtype=torch.float32,
                                          device=device), x)
    I = stimulus.stimulus_battery((0.25, 1.0), (5.0,), x, 0.03125)
    return W, I


def _check(cfg, W, I, check_every, accel, converged_rows_only=False,
           witness=False):
    """Kernel against plain: flags equal, rates within tolerance (on the
    rows both converged, where asked: a diverging or unresolved row's rates
    depend on the summation order; with ``witness``, a row outside it
    passes on its own fp32 trajectory, ``ab.off_own_trajectory``), iters
    within two strides. In two phases the plain version's phase 1 runs in
    emulated TF32, as the kernel's does."""
    before = (ssn_solve.launches, ssn_solve.launches_two_phase,
              ssn_solve.launches_refine)
    out = ssn_solve.solve_fixed_point_cuda(cfg, W, I, check_every, accel)
    fast = ssn_solve.drive_1xtf32 if cfg.pallas_two_phase else None
    ref = ssn_solve.solve_fixed_point_plain(cfg, W, I, check_every, accel,
                                            fast_drive=fast)
    torch.cuda.synchronize()
    refine = ssn_solve.schedule(cfg).refine
    assert (ssn_solve.launches, ssn_solve.launches_two_phase,
            ssn_solve.launches_refine) == (
        before[0] + 1, before[1] + cfg.pallas_two_phase, before[2] + refine)
    assert out.r.device == W.device and out.r.dtype == torch.float32
    assert torch.equal(out.converged, ref.converged)
    assert torch.equal(out.diverged, ref.diverged)
    rows = (out.converged & ref.converged if converged_rows_only
            else torch.ones_like(out.converged))
    if witness:
        off = rows & ((out.r - ref.r).abs()
                      > ATOL + RTOL * ref.r.abs()).any(-1)
        for b, s in off.nonzero().tolist():
            assert ab.off_own_trajectory(out, cfg, W, I, b, s, check_every,
                                         accel)[1], (b, s)
            rows[b, s] = False
    torch.testing.assert_close(out.r[rows], ref.r[rows], rtol=RTOL,
                               atol=ATOL)
    d_iters = (out.iters.long() - ref.iters.long()).abs().max()
    assert int(d_iters) <= 2 * check_every
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(cuda_device, case):
    cfg_kw, check_every, accel = CASES[case]
    W, I = _problem(cuda_device)
    out = _check(SSNConfig(**{**BASE, **cfg_kw}), W, I, check_every, accel)
    assert out.converged.all()


@pytest.mark.cuda
def test_kernel_ragged_and_wide_battery(cuda_device):
    """Batch and row counts that fill no row chunk evenly: B=3, S=11."""
    W, _ = _problem(cuda_device, B=3)
    x = torch.linspace(-0.5, 0.5, BASE["N"], device=cuda_device)
    I = stimulus.stimulus_battery(tuple(np.linspace(0, 1, 11)), (5.0,), x,
                                  0.03125)
    _check(SSNConfig(**BASE), W, I, 4, False)


def _slice_problem(device, B, N=51, contrasts=(10.0,), seed=3):
    """chip_smoke.py's forward-slice circuit (its J, D, S unscaled) at width
    N: W (B, 2N, 2N) from NumPy noise and 8 bandwidths x ``contrasts``
    rows."""
    cfg = SSNConfig(**{**ab.SLICE_SSN, "N": N, "pallas_two_phase": False})
    z = np.random.default_rng(seed).standard_normal((B, 2 * N, 2 * N))
    t = lambda v: torch.tensor(v, device=device).reshape(2, 2)  # noqa: E731
    x = cfg.site_pos(device=device)
    W = weights.build_weight(t(ab.SLICE_J), t(ab.SLICE_D), t(ab.SLICE_S),
                             torch.tensor(z, dtype=torch.float32,
                                          device=device), x)
    I = stimulus.stimulus_battery(ab.BANDWIDTHS, contrasts, x,
                                  cfg.smoothness)
    return cfg, W, I


SLICE_CASES = {
    # name: (N, B, contrasts, SSNConfig overrides, accel); every n8 tile
    # count the kernel instantiates, the last widths of the register path
    # (2N <= 112) and the first of the path past it, the shared-memory
    # limit, a width that is no multiple of 16, one circuit, and more
    # circuits than SMs
    "S8": (51, 32, (10.0,), {}, False),
    "S16_atol1e-5": (51, 32, (5.0, 10.0), dict(atol=1e-5, max_iter=10000),
                     False),
    "S24": (51, 16, (5.0, 10.0, 13.0), {}, False),
    "S32": (51, 8, (2.0, 5.0, 10.0, 13.0), {}, False),
    "S40": (51, 4, (1.0, 2.0, 5.0, 10.0, 13.0), {}, False),
    "2N224_S8": (112, 8, (10.0,), {}, False),
    "2N26": (13, 8, (10.0,), {}, False),
    "2N112": (56, 8, (10.0,), {}, False),
    "2N114": (57, 8, (10.0,), {}, False),
    "B1": (51, 1, (10.0,), {}, False),
    "B200": (51, 200, (10.0,), {}, False),
    "anderson_S16": (51, 16, (5.0, 10.0), dict(atol=1e-5, max_iter=10000),
                     True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_kernel_matches_plain_at_slice_shapes(cuda_device, case):
    N, B, contrasts, cfg_kw, accel = SLICE_CASES[case]
    cfg, W, I = _slice_problem(cuda_device, B, N, contrasts)
    out = _check(dataclasses.replace(cfg, **cfg_kw), W, I, 32, accel,
                 converged_rows_only=True)
    assert torch.isfinite(out.r).all()
    assert out.r.shape == (B, I.shape[0], 2 * N)
    assert float(out.converged.float().mean()) > 0.5


CLUSTER_CASES = {
    # name: (N, B, contrasts or bandwidth count, SSNConfig overrides,
    # accel): thread-block clusters of 2, 4 and 8 blocks per circuit, the
    # slice's circuit with J and D scaled to N (ab.problem)
    "2N240_S8": (120, 8, (10.0,), {}, False),
    "2N402_S8": (201, 8, (10.0,), {}, False),
    "2N402_anderson_S16": (201, 8, (5.0, 10.0),
                           dict(atol=1e-5, max_iter=10000), True),
    "2N402_ragged_B3_S11": (201, 3, 11, {}, False),
    "2N402_S24": (201, 4, (5.0, 10.0, 13.0), {}, False),
    "2N512_S16": (256, 4, (5.0, 10.0), {}, False),
    "2N512_anderson_S16": (256, 4, (5.0, 10.0), {}, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_cluster_kernel_matches_plain(cuda_device, case):
    N, B, contrasts, cfg_kw, accel = CLUSTER_CASES[case]
    if isinstance(contrasts, int):  # a ragged battery: S bandwidths
        cfg, W, _ = ab.problem(B, (10.0,), cfg_kw, N=N)
        I = stimulus.stimulus_battery(
            tuple(np.linspace(0, 1, contrasts)), (10.0,),
            cfg.site_pos(device=cuda_device), cfg.smoothness)
    else:
        cfg, W, I = ab.problem(B, contrasts, cfg_kw, N=N)
    assert ssn_solve.plan(2 * N, I.shape[0], accel).cluster > 1
    out = _check(cfg, W, I, 32, accel, converged_rows_only=True)
    assert torch.isfinite(out.r).all()
    assert out.r.shape == (B, I.shape[0], 2 * N)
    assert float(out.converged.float().mean()) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ab.SPLIT_SHAPES))
def test_split_kernel_matches_plain(cuda_device, case):
    """Batteries past a cluster of 8, each circuit's rows in chunks: flags
    equal to the plain version's, rates within rtol/atol, and a row
    outside them on its own fp32 trajectory to the kernel's iters."""
    N, _, contrasts, cfg_kw, accel = ab.SPLIT_SHAPES[case]
    cfg, W, I = ab.problem(4, contrasts, cfg_kw, N=N, seed=1)
    assert ssn_solve.plan(2 * N, I.shape[0], accel).chunks > 1
    out = _check(cfg, W, I, 32, accel, converged_rows_only=True,
                 witness=True)
    assert torch.isfinite(out.r).all()
    assert float(out.converged.float().mean()) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("accel", [False, True])
def test_forced_split_is_bit_equal(cuda_device, accel):
    """2N=102, S=32 in one chunk and forced into 4 chunks of 8 rows, one
    block per chunk either way: rates, flags and iters bit-equal."""
    cfg, W, I = ab.problem(16, (2.5, 5.0, 10.0, 13.0), {}, seed=2)
    assert ssn_solve.plan(102, 32, accel) == (1, 32, 1, False)
    assert ssn_solve.plan(102, 32, accel, rows=8) == (1, 8, 4, False)
    lib = ssn_solve._library()
    whole, _, _ = ssn_solve.launch(lib, cfg, W, I, 32, accel)
    split, p, _ = ssn_solve.launch(lib, cfg, W, I, 32, accel,
                                   rows_per_chunk=8)
    assert p == (1, 8, 4, False)
    torch.cuda.synchronize()
    for a, b in zip(whole, split):
        assert torch.equal(a, b)
    assert float(whole.converged.float().mean()) > 0.5


# name: (N, circuits, contrasts, accel, the shared-W plan): W read from
# device memory, forced at the shared-W plan's cluster size and rows
GLOBAL_FORCED = {
    "2N240_S8": (120, 16, (10.0,), False, (2, 8, 1)),
    "2N402_S8": (201, 16, (10.0,), False, (4, 8, 1)),
    "2N402_S32_anderson_chunks": (201, 8, (2.5, 5.0, 7.5, 10.0), True,
                                  (4, 8, 4)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GLOBAL_FORCED))
def test_forced_global_w_is_bit_equal(cuda_device, case):
    """The W-global path forced where W's slab fits shared memory, at the
    same cluster size and rows: the k-loop reads the same values in the
    same order, so rates, flags and iters are bit-equal."""
    N, B, contrasts, accel, shared = GLOBAL_FORCED[case]
    cfg, W, I = ab.problem(B, contrasts, {}, N=N, seed=2)
    S = I.shape[0]
    assert ssn_solve.plan(2 * N, S, accel) == (*shared, False)
    assert ssn_solve.plan(2 * N, S, accel, w_global=True) == (*shared, True)
    lib = ssn_solve._library()
    a, _, _ = ssn_solve.launch(lib, cfg, W, I, 32, accel)
    b, p, _ = ssn_solve.launch(lib, cfg, W, I, 32, accel, w_global=True)
    torch.cuda.synchronize()
    assert p == (*shared, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a.converged.float().mean()) > 0.5


# name: (N, circuits, contrasts, the shared-W plan, its one-pass loop as
# partial sums) in the default schedule, the refinement tail:
# n201_forward's plan (7 warps a block: the single chain), 3 row tiles on
# clusters of 8 (2 partials), and 7 row tiles on blocks of 4 warps (two
# groups of 4 tiles, the last with a tile off, past the rate plane)
GLOBAL_FORCED_REFINE = {
    "2N402_S8_clusters4": (201, 16, (10.0,), (4, 8, 1), False),
    "2N402_S24_clusters8": (201, 8, (5.0, 10.0, 13.0), (8, 24, 1), True),
    "2N194_S56_clusters4": (97, 8, (2.5, 4.0, 5.0, 6.5, 8.0, 10.0, 13.0),
                            (4, 56, 1), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GLOBAL_FORCED_REFINE))
def test_forced_global_w_is_bit_equal_in_the_refinement_tail(cuda_device,
                                                             case):
    """The W-global path forced at the shared-W plan in two phases with the
    refinement tail: its one-pass loop reads W from device memory into the
    same sums in the same order (the single chain, or the same partial
    sums), so rates, flags and iters are bit-equal."""
    N, B, contrasts, shared, partials = GLOBAL_FORCED_REFINE[case]
    cfg, W, I = ab.problem(B, contrasts, {}, N=N, seed=2, two_phase=True)
    S = I.shape[0]
    assert ssn_solve.schedule(cfg).refine
    assert ssn_solve.plan(2 * N, S, False, refine=True) == (*shared, False)
    assert ssn_solve.query(2 * N, S, False, True).partial_sums == partials
    assert ssn_solve.plan(2 * N, S, False, w_global=True,
                          refine=True) == (*shared, True)
    lib = ssn_solve._library()
    a, pa, sa = ssn_solve.launch(lib, cfg, W, I, 32, False)
    b, pb, sb = ssn_solve.launch(lib, cfg, W, I, 32, False, w_global=True)
    torch.cuda.synchronize()
    assert (pa, pb, sa, sb) == ((*shared, False), (*shared, True), partials,
                                partials)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a.converged.float().mean()) > 0.5


# name: (N, circuits, contrasts, accel): past a cluster of 8's shared memory
# at 8 rows, W read from device memory; contrasts to 10 (past it the
# stopping chunk of slow rows is not stable under rounding, PERF.md)
GLOBAL_CASES = {
    "2N600_S8": (300, 8, (10.0,), False),
    "2N600_S24": (300, 4, (2.5, 5.0, 10.0), False),
    "2N1024_anderson_S16": (512, 4, (5.0, 10.0), True),
    "2N2048_S8_B2": (1024, 2, (10.0,), False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GLOBAL_CASES))
def test_global_w_kernel_matches_plain(cuda_device, case):
    N, B, contrasts, accel = GLOBAL_CASES[case]
    cfg, W, I = ab.problem(B, contrasts, {}, N=N, seed=1)
    assert ssn_solve.plan(2 * N, I.shape[0], accel).w_global
    out = _check(cfg, W, I, 32, accel, converged_rows_only=True,
                 witness=True)
    assert torch.isfinite(out.r).all()
    assert out.r.shape == (B, I.shape[0], 2 * N)
    assert float(out.converged.float().mean()) > 0.5


# name: (N, circuits, contrasts, the plan, its one-pass loop as partial
# sums) in the default schedule, the refinement tail: the N=201 fit's solve
# (clusters of 8), n201_forward's (clusters of 4, the single chain) and W
# from device memory (2N=600)
COUNTED_CASES = {
    "fit_2N402_S16": (201, 4, (5.0, 10.0), (8, 16, 1, False), True),
    "forward_2N402_S8": (201, 4, (10.0,), (4, 8, 1, False), False),
    "wglobal_2N600_S8": (300, 2, (10.0,), (4, 8, 1, True), True),
}


@pytest.mark.cuda
def test_plan_matches_the_kernel(cuda_device):
    """The wrapper's plan is the kernel's: cluster size, rows per chunk,
    chunks, where W is read from and the shared memory, from the C entry
    point (``ssn_solve_query``) over a grid of shapes, in one phase and in
    the refinement tail's layout, both refusing past 2N=2048. And under a
    profiler a solve counts the plan its launch reported
    (:data:`COUNTED_CASES`): its cluster size and, where the one-pass loop
    ran as partial sums, one ``launches_partial_sums``, as
    ``ssn_solve_query`` plans the shape."""
    for n2 in (2, 26, 102, 224, 240, 402, 512, 576, 578, 596, 598, 600, 640,
               1024, 1500, 2048, 2050):
        for S in (1, 8, 17, 24, 32, 48, 64, 96, 184, 256, 1000):
            for accel in (False, True):
                for refine in (False, True):
                    try:
                        p = ssn_solve.plan(n2, S, accel, refine=refine)
                    except ValueError:
                        with pytest.raises(ValueError, match="no plan"):
                            ssn_solve.query(n2, S, accel, refine)
                        continue
                    q = ssn_solve.query(n2, S, accel, refine)
                    assert q.plan == p, (n2, S, accel, refine)
                    assert q.smem_bytes == ssn_solve.smem_bytes(
                        n2, p.rows, accel, p.cluster, p.w_global, refine)
    for case, (N, B, contrasts, plan, partials) in COUNTED_CASES.items():
        cfg, W, I = ab.problem(B, contrasts, {}, N=N, seed=2, two_phase=True)
        q = ssn_solve.query(2 * N, I.shape[0], False, True)
        assert (q.plan, q.partial_sums) == (plan, partials), case
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            ssn_solve.solve_fixed_point_cuda(cfg, W, I, 32)
            torch.cuda.synchronize()
        counts = profiling.counters()
        assert {k: v for k, v in counts.items()
                if k.startswith("ssn_solve.launches_")} == {
            f"ssn_solve.launches_cluster.{q.plan.cluster}": 1,
            **({"ssn_solve.launches_partial_sums": 1} if partials else {})
        }, case


@pytest.mark.cuda
def test_cluster_kernel_flags_runaway_divergence(cuda_device):
    """Hard divergers at 2N=402 (a cluster of 4): every row diverges, under
    the ceiling, as in the plain solve."""
    cfg = SSNConfig(N=201, k=0.05, n=2.2, dt=0.002, max_iter=512,
                    rate_stop_at=200.0, atol=1e-6, pallas_two_phase=False)
    W = 0.05 * torch.tensor(
        np.abs(np.random.default_rng(0).standard_normal((3, 402, 402))),
        dtype=torch.float32, device=cuda_device)
    I = 50.0 * torch.ones((8, 402), device=cuda_device)
    out = _check(cfg, W, I, 32, False)
    assert out.diverged.all() and torch.isfinite(out.r).all()
    assert float(out.r.max()) <= 10.0 * cfg.rate_stop_at


@pytest.mark.cuda
def test_kernel_flags_runaway_divergence(cuda_device):
    cfg = SSNConfig(N=4, k=0.05, n=2.2, dt=0.002, max_iter=512,
                    rate_stop_at=200.0, atol=1e-6, pallas_two_phase=False)
    W = 8.0 * torch.tensor(
        np.abs(np.random.default_rng(0).standard_normal((2, 8, 8))),
        dtype=torch.float32, device=cuda_device)
    I = 50.0 * torch.ones((1, 8), device=cuda_device)
    out = _check(cfg, W, I, 32, False)
    assert out.diverged.all() and torch.isfinite(out.r).all()
    assert float(out.r.max()) <= 10.0 * cfg.rate_stop_at


@pytest.mark.cuda
def test_cuda_tensor_past_2048_raises(cuda_device):
    """Past 2N=2048 a CUDA tensor is refused, never solved elsewhere."""
    before = ssn_solve.launches
    with pytest.raises(ValueError, match="512-thread limit"):
        ssn_solve.solve_fixed_point_cuda(
            SSNConfig(N=1025), torch.zeros(1, 2050, 2050, device=cuda_device),
            torch.zeros(8, 2050, device=cuda_device))
    assert ssn_solve.launches == before


@pytest.mark.cuda
def test_cuda_tensor_never_falls_back(cuda_device, monkeypatch):
    """A CUDA tensor goes to the kernel or raises: a library that cannot be
    built is an error, not a reason to run the plain version."""
    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(ssn_solve, "_library", broken)
    W, I = _problem(cuda_device, B=2)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ssn_solve.solve_fixed_point_cuda(SSNConfig(**BASE), W, I)


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [False, True], ids=["one", "refine"])
def test_blocks_per_sm_fits_shared_memory(cuda_device, refine):
    """The runtime's occupancy figure at 2N=102 with the 8- and 16-row
    batteries: at least two blocks per SM (B=256 at S=16 in one wave on
    132 SMs), no more than the SM's shared memory or registers hold at one
    warp per 16 neurons, and Anderson's extra planes never raise it; the
    same in the refinement tail's kernel and layout."""
    props = torch.cuda.get_device_properties(cuda_device)
    per_sm = getattr(props, "shared_memory_per_multiprocessor", None)
    threads = 32 * 7  # one warp per m16 slab of 102 neurons
    for S in (8, 16):
        n = {accel: ssn_solve.query(102, S, accel, refine,
                                    cuda_device).blocks_per_sm
             for accel in (False, True)}
        assert 2 <= n[True] <= n[False]
        assert n[False] * threads <= getattr(
            props, "max_threads_per_multi_processor", 2048)
        if per_sm:
            for accel, blocks in n.items():
                assert blocks * ssn_solve.smem_bytes(
                    102, S, accel, refine=refine) <= per_sm


@pytest.mark.cuda
def test_solve_any_cuda_backend_launches(cuda_device):
    from tcgan_torch.ops import fixed_point

    W, I = _problem(cuda_device, B=2)
    cfg = dataclasses.replace(SSNConfig(**BASE), backend="cuda",
                              check_every=4)
    before = ssn_solve.launches
    res = fixed_point.solve_any(cfg, W.double(), I.double())
    assert ssn_solve.launches == before + 1
    assert res.r.dtype == torch.float32 and res.converged.all()


TWO_PHASE_CASES = {
    # name: (N, B, contrasts, SSNConfig overrides, accel): the two-phase
    # schedule on every path: the register path (2N <= 112, with Anderson
    # too), one block with W in fp32 (2N=224), a cluster of 4 (2N=402), row
    # chunks (2N=402, S=32 with Anderson: 4 chunks of 8 rows on clusters of
    # 4) and W read from device memory (2N=600); J and D scaled to N
    "register_S8": (51, 32, (10.0,), {}, False),
    "register_S16_atol1e-5": (51, 32, (5.0, 10.0),
                              dict(atol=1e-5, max_iter=10000), False),
    "register_anderson_S16": (51, 16, (5.0, 10.0),
                              dict(atol=1e-5, max_iter=10000), True),
    "one_block_2N224_S8": (112, 8, (10.0,), {}, False),
    "cluster_2N402_S8": (201, 8, (10.0,), {}, False),
    "chunks_2N402_S32_anderson": (201, 4, (2.5, 5.0, 7.5, 10.0), {}, True),
    "wglobal_2N600_S8": (300, 4, (10.0,), {}, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [True, False], ids=["refine", "3xtf32"])
@pytest.mark.parametrize("case", sorted(TWO_PHASE_CASES))
def test_two_phase_kernel_matches_plain(cuda_device, case, refine):
    """Both tails at every path; 2N=224 takes a cluster of 2 in the
    refinement tail's layout."""
    N, B, contrasts, cfg_kw, accel = TWO_PHASE_CASES[case]
    cfg, W, I = ab.problem(B, contrasts, {**cfg_kw, "pallas_refine": refine},
                           N=N, seed=1, two_phase=True)
    p = ssn_solve.plan(2 * N, I.shape[0], accel, refine=refine)
    assert (p.cluster > 1) == (case.startswith(("cluster", "chunks",
                                                "wglobal"))
                               or (refine and N == 112))
    assert (p.chunks > 1) == case.startswith("chunks")
    assert p.w_global == case.startswith("wglobal")
    out = _check(cfg, W, I, 32, accel, converged_rows_only=True)
    assert torch.isfinite(out.r).all()
    assert float(out.converged.float().mean()) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("margin,want", [(0.0, 64), (2.0, 32)])
def test_two_phase_reopen_margin_on_card(cuda_device, margin, want):
    """Hard divergers (tests/test_torch_ssn_solve.py::_runaway_problem):
    reopened at margin 0, they diverge again a chunk later; at 2.0 they keep
    their phase-1 flag and iters, as on the CPU and in the reference."""
    cfg = SSNConfig(N=4, k=0.05, n=2.2, dt=0.002, max_iter=512,
                    rate_stop_at=200.0, atol=1e-6,
                    pallas_reopen_margin=margin)
    W = 8.0 * torch.tensor(
        np.abs(np.random.default_rng(0).standard_normal((2, 8, 8))),
        dtype=torch.float32, device=cuda_device)
    I = 50.0 * torch.ones((1, 8), device=cuda_device)
    out = _check(cfg, W, I, 32, False)
    assert out.diverged.all() and (out.iters == want).all()


@pytest.mark.cuda
def test_two_phase_reopen_margin_keeps_flags(cuda_device):
    """The slice's battery with half its circuits hard divergers (W = 0.5
    |N(0, 1)|): margins 0 and 2.0 give the same flags, and 2.0 fewer iters
    on the diverged rows."""
    outs = []
    for margin in (0.0, 2.0):
        cfg, W, I = ab.problem(16, (10.0,), dict(pallas_reopen_margin=margin),
                               seed=1, two_phase=True)
        W[8:] = 0.5 * torch.tensor(
            np.abs(np.random.default_rng(2).standard_normal((8, 102, 102))),
            dtype=torch.float32, device=cuda_device)
        outs.append(_check(cfg, W, I, 32, False, converged_rows_only=True))
    a, b = outs
    assert a.diverged[8:].all() and a.converged[:8].all()
    assert torch.equal(a.diverged, b.diverged)
    assert torch.equal(a.converged, b.converged)
    assert (b.iters[8:] <= a.iters[8:]).all()
    assert (b.iters[8:] < a.iters[8:]).any()


@pytest.mark.cuda
def test_two_phase_bad_margin_raises_on_card(cuda_device):
    """A bad schedule flag raises for a CUDA tensor; nothing launches."""
    W, I = _problem(cuda_device, B=2)
    before = ssn_solve.launches
    with pytest.raises(ValueError, match="pallas_reopen_margin"):
        ssn_solve.solve_fixed_point_cuda(
            SSNConfig(**{**BASE, "pallas_two_phase": True,
                         "pallas_reopen_margin": -1.0}), W, I)
    assert ssn_solve.launches == before


@pytest.mark.cuda
def test_refine_cluster_blocks_agree(cuda_device):
    """The refinement tail on clusters of 4 (2N=402): every block decides
    the flags from its own copy of the rates, so a block that disagreed
    would stop at another chunk and leave its peers at the cluster barrier.
    The launch ends; each block's slab of the rates agrees with the plain
    version (each block writes its own slab from its own flags); and the
    W-global path forced at the same cluster size, which reads W from
    device memory in the same order, is bit-equal."""
    cfg, W, I = ab.problem(8, (5.0, 10.0), {}, N=201, seed=2, two_phase=True)
    p = ssn_solve.plan(402, 16, False, refine=True)
    assert p.cluster == 8 and not p.w_global
    out = _check(cfg, W, I, 32, False, converged_rows_only=True,
                 witness=True)
    lib = ssn_solve._library()
    forced, _, _ = ssn_solve.launch(lib, cfg, W, I, 32, False, w_global=True)
    torch.cuda.synchronize()
    for x, y in zip(out, forced):
        assert torch.equal(x, y)
    assert float(out.converged.float().mean()) > 0.5


@pytest.mark.cuda
def test_fit_battery_at_the_paper_width_on_clusters_of_8(cuda_device):
    """The round-2 fit's solve at the paper's width: B=256 circuits of S=16
    rows (contrasts 5 and 10) at 2N=402 and atol 1e-5, in the default
    schedule (two phases, the refinement tail), one launch on clusters of
    8 (2,048 blocks), against the plain version: flags equal, rates within
    tolerance where both converged (a row off it stopped at another
    substep, which its own fp32 trajectory witnesses, as above)."""
    cfg, W, I = ab.problem(256, (5.0, 10.0), dict(atol=1e-5, max_iter=10000),
                           N=201, seed=4, two_phase=True)
    assert ssn_solve.schedule(cfg).refine
    assert ssn_solve.plan(402, 16, False, refine=True) == ssn_solve.Plan(
        8, 16, 1, False)
    out = _check(cfg, W, I, 32, False, converged_rows_only=True,
                 witness=True)
    assert float(out.converged.float().mean()) > 0.5


class _BeforeTheTail:
    """A build of a source from before the refinement tail, launched
    through today's :func:`ssn_solve.launch`: its two-phase entry
    ``ssn_solve_launch_schedule`` (today's launch arguments without the
    substep totals and the plan) answers for ``ssn_solve_run``; the one
    place that knows that earlier interface."""

    def __init__(self, path):
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self._launch = lib.ssn_solve_launch_schedule
        self._launch.argtypes = ([p] * 7 + [i] * 4 + [f] * 9 + [i] * 4 + [p]
                                 + [i, i, i, f, i, f])
        self._launch.restype = i
        self.ssn_solve_error_string = lib.ssn_solve_error_string
        self.ssn_solve_error_string.argtypes = [i]
        self.ssn_solve_error_string.restype = ctypes.c_char_p

    def ssn_solve_run(self, *args):
        *launch_args, substeps, _ = args
        assert substeps is None
        return self._launch(*launch_args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TWO_PHASE_CASES))
def test_refine_off_is_the_baseline_two_phase(cuda_device, case):
    """With ``pallas_refine`` off the kernel's two phases are those of the
    build before the refinement tail, bit for bit: the earlier source named
    by ``SSN_SOLVE_BASELINE`` (for example ``git show
    <rev>:tcgan_torch/csrc/ssn_solve.cu`` into a git-ignored directory),
    built with the same flags, on the same inputs."""
    src = os.environ.get("SSN_SOLVE_BASELINE")
    if not src:
        pytest.skip("SSN_SOLVE_BASELINE names no earlier ssn_solve.cu")
    old = _BeforeTheTail(ab._build_baseline(Path(src))[0])
    N, B, contrasts, cfg_kw, accel = TWO_PHASE_CASES[case]
    cfg, W, I = ab.problem(B, contrasts, {**cfg_kw, "pallas_refine": False},
                           N=N, seed=1, two_phase=True)
    a, _, _ = ssn_solve.launch(old, cfg, W, I, 32, accel)
    b, _, _ = ssn_solve.launch(ssn_solve._library(), cfg, W, I, 32, accel)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
