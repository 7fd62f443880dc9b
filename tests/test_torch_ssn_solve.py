"""Port parity for the fused SSN solver: the CPU path of
``tcgan_torch.ops.cuda.ssn_solve.solve_fixed_point_cuda`` (its plain torch
version) against the Pallas kernel ``solve_fixed_point_pallas`` run in
interpret mode, in f32 on identical NumPy inputs.

Tolerance: flags equal, rates rtol 1e-4 atol 1e-5 (the kernel-vs-lockstep
tolerance of tests/test_pallas_solver.py), iters within a few steps (the
mat-vec summation order differs, which can move the atol crossing).

The kernel itself runs in tests/test_torch_ssn_solve_cuda.py, on a card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.ops import ssn as jssn
from tcgan_tpu.ops import stimulus as jstim
from tcgan_tpu.ops import weights as jw
from tcgan_tpu.ops.pallas import solve_fixed_point_pallas
from tcgan_torch.ops import fixed_point as tfp
from tcgan_torch.ops import ssn as tssn
from tcgan_torch.ops.cuda import build
from tcgan_torch.ops.cuda import ssn_solve

BASE = dict(N=8, k=0.01, n=2.2, dt=0.001, max_iter=4000, atol=1e-6)
RTOL, ATOL = 1e-4, 1e-5


def _problem(B=5, seed=11):
    """f32 NumPy W (B, 2N, 2N) and battery I (2, 2N), as in
    tests/test_pallas_solver.py::_problem."""
    N = BASE["N"]
    z = np.random.default_rng(seed).standard_normal((B, 2 * N, 2 * N))
    x = np.linspace(-0.5, 0.5, N)
    W = jw.build_weight(np.array([[0.025, 0.02], [0.025, 0.015]]),
                        np.array([[0.1, 0.08], [0.1, 0.08]]),
                        np.array([[0.25, 0.1], [0.25, 0.1]]), z, x)
    I = jstim.stimulus_battery((0.25, 1.0), (5.0,), jnp.asarray(x), 0.03125)
    return (np.asarray(W, dtype=np.float32), np.asarray(I, dtype=np.float32))


def _runaway_problem():
    """Hard divergers, shaped like tests/test_pallas_solver.py:192-197."""
    W = 8.0 * np.abs(np.random.default_rng(0).standard_normal((2, 8, 8)))
    return W.astype(np.float32), 50.0 * np.ones((1, 8), np.float32)


SATURATING = dict(rate_soft_bound=0.15, rate_hard_bound=0.8,
                  rate_stop_at=50.0)
CASES = {
    # name: (SSNConfig overrides, check_every, accel, batch)
    "plain": ({}, 1, False, 5),
    "check8": ({}, 8, False, 5),
    "asym_tanh": (dict(io_type="asym_tanh", **SATURATING), 1, False, 4),
    "asym_linear": (dict(io_type="asym_linear", **SATURATING), 1, False, 4),
    "expo": (dict(stepper="expo", dt=0.004, max_iter=2000), 1, False, 4),
    "feedforward": (dict(init="feedforward"), 1, False, 4),
    "anderson": ({}, 8, True, 5),
    "ragged": ({}, 4, False, 3),
    "diverge": (dict(N=4, k=0.05, n=2.2, dt=0.002, max_iter=512,
                     rate_stop_at=200.0), 32, False, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_path_matches_pallas_interpret(case):
    cfg_kw, check_every, accel, B = CASES[case]
    W, I = _runaway_problem() if case == "diverge" else _problem(B)
    jcfg = jssn.SSNConfig(**{**BASE, **cfg_kw})
    ref = solve_fixed_point_pallas(jcfg, jnp.asarray(W), jnp.asarray(I),
                                   block_b=4, check_every=check_every,
                                   interpret=True, two_phase=False,
                                   accel=accel)
    tcfg = tssn.SSNConfig(**{**BASE, **cfg_kw}, pallas_two_phase=False)
    out = ssn_solve.solve_fixed_point_cuda(
        tcfg, torch.tensor(W), torch.tensor(I), check_every=check_every,
        accel=accel)
    assert out.r.dtype == torch.float32 and out.iters.dtype == torch.int32
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.diverged.numpy(),
                                  np.asarray(ref.diverged))
    np.testing.assert_allclose(out.r.numpy(), np.asarray(ref.r), rtol=RTOL,
                               atol=ATOL)
    d_iters = np.abs(out.iters.numpy().astype(np.int64)
                     - np.asarray(ref.iters, np.int64))
    assert d_iters.max() <= max(4, 2 * check_every)
    if case == "diverge":
        assert out.diverged.all() and torch.isfinite(out.r).all()
        assert float(out.r.max()) <= 10.0 * jcfg.rate_stop_at
    else:
        assert out.converged.all()
    if case.startswith("asym_"):  # the saturating branch is exercised
        assert float(out.r.max()) > SATURATING["rate_soft_bound"]


def test_cpu_path_matches_pallas_two_phase_refine():
    """Against the TPU kernel's default two-phase precision with the
    refinement tail, in the port's default schedule (two phases): same
    fixed point, iters within one check stride."""
    W, I = _problem(B=4)
    ref = solve_fixed_point_pallas(jssn.SSNConfig(**BASE), jnp.asarray(W),
                                   jnp.asarray(I), block_b=4, check_every=8,
                                   interpret=True)
    out = ssn_solve.solve_fixed_point_cuda(
        tssn.SSNConfig(**BASE), torch.tensor(W), torch.tensor(I),
        check_every=8)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(out.r.numpy(), np.asarray(ref.r), rtol=RTOL,
                               atol=ATOL)
    assert np.max(np.abs(out.iters.numpy().astype(np.int64)
                         - np.asarray(ref.iters, np.int64))) <= 8


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    """In one phase the CPU path is the lockstep solve, bit for bit."""
    W, I = _problem(B=3)
    cfg = tssn.SSNConfig(**BASE, init="feedforward", pallas_two_phase=False)
    before = ssn_solve.launches
    out = ssn_solve.solve_fixed_point_cuda(cfg, torch.tensor(W),
                                           torch.tensor(I), check_every=4,
                                           accel=True)
    ref = tfp.solve_fixed_point(dataclasses.replace(cfg, accel="anderson"),
                                torch.tensor(W), torch.tensor(I),
                                check_every=4)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert ssn_solve.launches == before


def test_f64_inputs_give_f32_results():
    W, I = _problem(B=2)
    out = ssn_solve.solve_fixed_point_cuda(
        tssn.SSNConfig(**BASE), torch.tensor(W, dtype=torch.float64),
        torch.tensor(I, dtype=torch.float64), check_every=4)
    assert out.r.dtype == torch.float32


def test_solve_any_dispatches_cuda_backend(monkeypatch):
    """backend='cuda' with W (B, 2N, 2N) and I (S, 2N) goes to the kernel
    wrapper with the config's check stride and accel; any layout the kernel
    cannot take raises instead of falling back to the lockstep solve."""
    seen = []
    real = ssn_solve.solve_fixed_point_cuda

    def spy(cfg, W, I, check_every, accel):
        seen.append((check_every, accel))
        return real(cfg, W, I, check_every, accel)

    monkeypatch.setattr(ssn_solve, "solve_fixed_point_cuda", spy)
    W, I = _problem(B=2)
    cfg = tssn.SSNConfig(**BASE, backend="cuda", check_every=8,
                         accel="anderson")
    tfp.solve_any(cfg, torch.tensor(W), torch.tensor(I))
    assert seen == [(8, True)]
    with pytest.raises(ValueError, match="shared battery"):
        tfp.solve_any(cfg, torch.tensor(W[0]), torch.tensor(I))  # 2-D W
    with pytest.raises(ValueError, match="shared battery"):
        tfp.solve_any(cfg, torch.tensor(W), torch.tensor(I)[None])  # 3-D I
    assert len(seen) == 1


def test_shape_and_device_errors():
    cfg = tssn.SSNConfig(**BASE)
    W, I = _problem(B=2)
    with pytest.raises(ValueError, match="expected W"):
        ssn_solve.solve_fixed_point_cuda(cfg, torch.tensor(W[0]),
                                         torch.tensor(I))
    with pytest.raises(ValueError, match="expected W"):
        ssn_solve.solve_fixed_point_cuda(cfg, torch.tensor(W),
                                         torch.tensor(I[:, :5]))
    with pytest.raises(ValueError, match="check_every"):
        ssn_solve.solve_fixed_point_cuda(cfg, torch.tensor(W),
                                         torch.tensor(I), check_every=0)
    # a tensor that is neither on the CPU nor on a CUDA device is refused,
    # never solved somewhere else
    with pytest.raises(ValueError, match="CUDA device"):
        ssn_solve.solve_fixed_point_cuda(
            cfg, torch.empty(W.shape, device="meta"),
            torch.empty(I.shape, device="meta"))


@pytest.mark.parametrize("refine", [False, True], ids=["3xtf32", "refine"])
@pytest.mark.parametrize("n2,S,accel,cluster", [
    (102, 24, True, 1), (224, 8, False, 1), (240, 8, False, 2),
    (402, 8, False, 4), (402, 24, True, 8), (512, 16, True, 8),
    (512, 16, False, 8)])
def test_shared_memory_limit_raises(n2, S, accel, cluster, refine):
    """One circuit's state fits one block up to 2N=224 at S=8; past that a
    cluster of 2, 4 or 8 blocks takes it, each block's layout within the
    limit, up to every 2N <= 512 at S <= 16 and 2N=402 with the 24-row
    battery and Anderson. A battery past a cluster of 8 is solved in
    chunks of rows (2N=512 at S=24 with Anderson, 2N=402 at S=64). Where
    not even an 8-row chunk fits a cluster of 8 with W's slab in shared
    memory (2N=598, 578 with Anderson), W is read from device memory; past
    2N=2048, where a block of a cluster of 8 would need more than 512
    threads, the wrapper raises, on CPU tensors too, naming the limit. The
    refinement tail's two more slab planes (one with Anderson) move 2N=224
    at S=8 to a cluster of 2 and W to device memory from 2N=586 (570 with
    Anderson); the same shapes are solved."""
    if refine and (n2, S) == (224, 8):
        cluster = 2
    kw = dict(refine=refine)
    assert ssn_solve.plan(n2, S, accel, **kw) == (cluster, S, 1, False)
    assert ssn_solve.smem_bytes(n2, S, accel, cluster, **kw) <= \
        ssn_solve.MAX_SMEM_BYTES
    if cluster > 1:  # the least cluster size that fits
        assert ssn_solve.smem_bytes(n2, S, accel, cluster // 2, **kw) > \
            ssn_solve.MAX_SMEM_BYTES
    for n2, S, accel in ((512, 24, True), (402, 64, False)):
        p = ssn_solve.plan(n2, S, accel, **kw)
        assert p.chunks > 1 and not p.w_global and ssn_solve.smem_bytes(
            n2, p.rows, accel, p.cluster, **kw) <= ssn_solve.MAX_SMEM_BYTES
    for n2, accel in ((586, False), (570, True)) if refine else (
            (598, False), (578, True)):
        assert ssn_solve.plan(n2 - 2, 1000, accel, **kw).chunks > 1
        assert not ssn_solve.plan(n2 - 2, 8, accel, **kw).w_global
        assert ssn_solve.smem_bytes(n2, 8, accel, 8, **kw) > \
            ssn_solve.MAX_SMEM_BYTES
        p = ssn_solve.plan(n2, 8, accel, **kw)
        assert p.w_global and p.chunks == 1 and ssn_solve.smem_bytes(
            n2, 8, accel, p.cluster, True, **kw) <= ssn_solve.MAX_SMEM_BYTES
        with pytest.raises(ValueError, match="W in shared memory"):
            # forced rows keep W there
            ssn_solve.plan(n2, 8, accel, rows=8, **kw)
    assert ssn_solve.plan(2048, 8, True, **kw) == (8, 8, 1, True)
    for accel in (False, True):
        with pytest.raises(ValueError, match="cluster of 8.*544 threads.*"
                           "512-thread limit") as e:
            ssn_solve.plan(2050, 8, accel, **kw)
        assert "2048" in str(e.value)
    with pytest.raises(ValueError, match="512-thread limit"):
        ssn_solve.solve_fixed_point_cuda(
            tssn.SSNConfig(N=1025, pallas_refine=refine),
            torch.zeros(1, 2050, 2050), torch.zeros(8, 2050))


def test_every_width_to_512_fits_a_cluster():
    for n2 in range(2, 513):
        for S in range(1, 17):
            for accel in (False, True):
                c, R, K, w_global = ssn_solve.plan(n2, S, accel)
                assert (R, K, w_global) == (S, 1, False)
                assert ssn_solve.smem_bytes(n2, S, accel, c) <= \
                    ssn_solve.MAX_SMEM_BYTES
                assert 32 * ssn_solve.slab(n2, c) // 16 <= 512
    for S in range(17, 25):
        assert ssn_solve.plan(402, S, True) == (8, S, 1, False)


@pytest.mark.parametrize("accel", [False, True])
def test_plan_admits_every_battery(accel):
    """Every 2N <= 576 at every S <= 256: each chunk's layout fits a block
    with at most 512 threads, and the chunks cover the S rows exactly
    (balanced, multiples of 8). Wherever a cluster size fits the whole
    battery (every shape admitted before row chunks), the plan is the
    least such and one chunk: those launches are unchanged."""
    limit = ssn_solve.MAX_SMEM_BYTES
    n_split = 0
    for n2 in range(2, 577):
        R_max = None  # the most rows, a multiple of 8, at the split's c
        for S in range(1, 257):
            c, R, K, w_global = ssn_solve.plan(n2, S, accel)
            assert not w_global, (n2, S)
            assert 32 * ssn_solve.slab(n2, c) // 16 <= 512
            assert ssn_solve.smem_bytes(n2, R, accel, c) <= limit, (n2, S)
            assert (K - 1) * R < S <= K * R, (n2, S)
            whole = next((c for c in ssn_solve.CLUSTER_SIZES
                          if 32 * ssn_solve.slab(n2, c) // 16 <= 512
                          and ssn_solve.smem_bytes(n2, S, accel, c) <= limit),
                         None)
            if whole is not None:
                assert (c, R, K) == (whole, S, 1), (n2, S)
                continue
            n_split += 1
            assert R % 8 == 0 and K > 1, (n2, S)
            # the least cluster size at which 8 rows fit, and no fewer
            # chunks there
            assert c == next(c for c in ssn_solve.CLUSTER_SIZES
                             if ssn_solve.smem_bytes(n2, 8, accel, c) <= limit
                             and 32 * ssn_solve.slab(n2, c) // 16 <= 512)
            if R_max is None:
                R_max = 8
                while ssn_solve.smem_bytes(n2, R_max + 8, accel, c) <= limit:
                    R_max += 8
            assert K == -(-S // R_max), (n2, S)
            assert R == 8 * -(-S // (8 * K)), (n2, S)  # balanced chunks
    assert n_split > 10000


def _rule(n2, S, accel, w_global, refine=False, nbytes=None):
    """The plan rule, from the layout bytes alone (``nbytes(n2, R, accel,
    c, w_global)``, by default ``smem_bytes`` in the refinement tail's
    layout or not), at one kind of layout: the least cluster size that
    holds the whole battery, one chunk; else the least that holds 8 rows,
    the fewest chunks there, balanced rows; None where 8 rows fit no
    cluster. Cluster sizes from 2 with W in device memory."""
    limit = ssn_solve.MAX_SMEM_BYTES
    sizes = (2, 4, 8) if w_global else (1, 2, 4, 8)
    nbytes = nbytes or (lambda *a: ssn_solve.smem_bytes(*a, refine=refine))

    def fits(R, c):
        return (32 * ssn_solve.slab(n2, c) // 16 <= 512
                and nbytes(n2, R, accel, c, w_global) <= limit)

    whole = next((c for c in sizes if fits(S, c)), None)
    if whole is not None:
        return whole, S, 1
    c = next((c for c in sizes if fits(8, c)), None)
    if c is None:
        return None
    R_max = 8
    while fits(R_max + 8, c):
        R_max += 8
    K = -(-S // R_max)
    return c, 8 * -(-S // (8 * K)), K


@pytest.mark.parametrize("refine", [False, True], ids=["3xtf32", "refine"])
@pytest.mark.parametrize("accel", [False, True])
def test_plan_admits_every_width_to_2048(accel, refine):
    """Every 2N in 577..2048 at S from 1 to 256: each chunk's layout fits a
    block, the slab needs at most 16 warps, the chunks cover the S rows
    exactly; W is read from device memory exactly where no cluster of 8
    holds 8 rows with W's slab in shared memory, and the plan is the
    shared-W plan (unchanged) wherever one does; in the refinement tail's
    layout too (from 2N=561, below its first W-global plan, 2N=569 with
    Anderson)."""
    limit = ssn_solve.MAX_SMEM_BYTES
    n_global = 0
    for n2 in range(561 if refine else 577, 2049):
        shared8 = ssn_solve.smem_bytes(n2, 8, accel, 8, refine=refine) <= limit
        for S in (1, 8, 9, 16, 24, 32, 48, 64, 256):
            c, R, K, w_global = ssn_solve.plan(n2, S, accel, refine=refine)
            assert 32 * ssn_solve.slab(n2, c) // 16 <= 512, (n2, S)
            assert ssn_solve.smem_bytes(n2, R, accel, c, w_global,
                                        refine) <= limit
            assert (K - 1) * R < S <= K * R, (n2, S)
            assert w_global == (not shared8), (n2, S)
            assert (c, R, K) == _rule(n2, S, accel, w_global, refine), (n2,
                                                                        S)
            n_global += w_global
    assert n_global > 13000


def _bytes_before_refine(n2, S, accel, c=1, w_global=False, extra=0):
    """One block's shared memory in the layout before the refinement tail
    (with ``extra``, that many more planes over the slab): W's slab (none
    with W in device memory) and both rate planes at stride ld, the battery
    and Anderson's three planes over the slab at stride lds (each the least
    stride >= its row that is 4 mod 8, or the row rounded up to 4 where
    that would not fit), then 2S + rows + rows / 8 + 1 ints and, in a
    cluster with Anderson, 3 c rows floats."""
    rows, w = -(-S // 8) * 8, min(ssn_solve.slab(n2, c), n2)

    def nbytes(ld, lds):
        floats = (0 if w_global else w) * ld + 2 * rows * ld + rows * lds * (
            (4 if accel else 1) + extra)
        return 4 * (floats + 2 * S + rows + rows // 8 + 1
                    + (3 * c * rows if c > 1 and accel else 0))

    padded = nbytes(-(-(n2 + 4) // 8) * 8 - 4, -(-(w + 4) // 8) * 8 - 4)
    if padded <= ssn_solve.MAX_SMEM_BYTES:
        return padded
    return nbytes(-(-n2 // 4) * 4, -(-w // 4) * 4)


@pytest.mark.parametrize("accel", [False, True])
def test_plans_without_refine_are_unchanged(accel):
    """Without the refinement tail every layout and plan is the one from
    before it (``_bytes_before_refine`` and the plan rule on it), at every
    cluster size, with W in shared or device memory; the tail's layout adds
    its planes (two over the slab, one with Anderson, whose chunk-input
    plane it shares) and nothing else."""
    for n2 in list(range(2, 260, 3)) + list(range(400, 2049, 37)):
        for S in (1, 8, 9, 16, 24, 32, 48, 64, 184, 256):
            for c in ssn_solve.CLUSTER_SIZES:
                for wg in (False, True):
                    assert ssn_solve.smem_bytes(n2, S, accel, c, wg) == \
                        _bytes_before_refine(n2, S, accel, c, wg), (n2, S)
                    assert ssn_solve.smem_bytes(n2, S, accel, c, wg,
                                                True) == _bytes_before_refine(
                        n2, S, accel, c, wg, 1 if accel else 2), (n2, S)
            want = [(_rule(n2, S, accel, wg, nbytes=_bytes_before_refine), wg)
                    for wg in (False, True)]
            want = next(((*p, wg) for p, wg in want if p is not None), None)
            if want is None:
                with pytest.raises(ValueError):
                    ssn_solve.plan(n2, S, accel)
                continue
            assert ssn_solve.plan(n2, S, accel, refine=False) == want, (n2, S)


def _circuit(N, bandwidths, contrasts, B=2, seed=5):
    """f32 NumPy W (B, 2N, 2N) and battery I of the slice's circuit at width
    N, J and D scaled by 51 / N (``ssn_solve_ab.problem``), and the
    slice's SSNConfig keywords."""
    from tcgan_torch.tools import ssn_solve_ab as ab

    scale = 51 / N
    z = np.random.default_rng(seed).standard_normal((B, 2 * N, 2 * N))
    x = np.linspace(-0.5, 0.5, N)
    m22 = lambda v, c=1.0: c * np.array(v).reshape(2, 2)  # noqa: E731
    W = np.asarray(jw.build_weight(m22(ab.SLICE_J, scale),
                                   m22(ab.SLICE_D, scale), m22(ab.SLICE_S),
                                   z, x), dtype=np.float32)
    I = np.asarray(jstim.stimulus_battery(bandwidths, contrasts,
                                          jnp.asarray(x), 0.03125),
                   dtype=np.float32)
    return W, I, {**ab.SLICE_SSN, "N": N}


def _check_against(ref, out, n2, I):
    assert out.r.shape == (2, I.shape[0], n2)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.diverged.numpy(),
                                  np.asarray(ref.diverged))
    np.testing.assert_allclose(out.r.numpy(), np.asarray(ref.r), rtol=RTOL,
                               atol=ATOL)


def _paper_width_against_xla(bandwidths, contrasts, accel, N=201):
    """N=201 (2N=402) by default, 2 circuits, J and D scaled by 51 / N
    (``ssn_solve_ab.problem``): the wrapper's CPU path in one phase against
    the reference's lockstep (XLA) solve, which runs one; flags equal, rates
    within RTOL/ATOL. Returns the CPU path's result."""
    from tcgan_tpu.ops import fixed_point as jfp
    from tcgan_torch.tools import ssn_solve_ab as ab

    W, I, kw = _circuit(N, bandwidths, contrasts)
    kw["accel"] = "anderson" if accel else "none"
    ref = jfp.solve_fixed_point(jssn.SSNConfig(**kw), jnp.asarray(W),
                                jnp.asarray(I), check_every=ab.CHECK_EVERY)
    out = ssn_solve.solve_fixed_point_cuda(
        tssn.SSNConfig(**kw, pallas_two_phase=False), torch.tensor(W),
        torch.tensor(I), check_every=ab.CHECK_EVERY, accel=accel)
    _check_against(ref, out, 2 * N, I)
    return out


def test_cpu_path_matches_xla_at_paper_width():
    """2 circuits x 2 rows: a cluster of 4 on the card."""
    assert ssn_solve.plan(402, 2, False).cluster == 4
    out = _paper_width_against_xla((0.25, 1.0), (10.0,), False)
    assert out.converged.all()


def test_cpu_path_matches_xla_at_split_shape():
    """The 32-row battery (8 bandwidths x contrasts 5, 10, 13, 20) with
    Anderson: on the card, 4 chunks of 8 rows on clusters of 4. The CPU
    path solves the whole battery, which is what the chunks compute."""
    from tcgan_torch.tools import ssn_solve_ab as ab

    assert ssn_solve.plan(402, 32, True) == (4, 8, 4, False)
    out = _paper_width_against_xla(ab.BANDWIDTHS, (5.0, 10.0, 13.0, 20.0),
                                   True)
    assert float(out.converged.float().mean()) > 0.9


@pytest.mark.parametrize("N,accel", [(300, False), (512, True)])
def test_cpu_path_matches_xla_at_global_w_width(N, accel):
    """Past a cluster of 8's shared memory at 8 rows: 2N=600, and 2N=1024
    with Anderson, the 8-bandwidth battery at contrast 10; on the card, W
    read from device memory on clusters of 4. Against the reference's
    lockstep solve."""
    from tcgan_torch.tools import ssn_solve_ab as ab

    assert ssn_solve.plan(2 * N, 8, accel) == (4, 8, 1, True)
    out = _paper_width_against_xla(ab.BANDWIDTHS, (10.0,), accel, N=N)
    assert float(out.converged.float().mean()) > 0.9


def test_cpu_path_matches_pallas_interpret_at_global_w_width():
    """2N=600 against the reference's Pallas kernel in interpret mode (the
    wrapper clamps it to one circuit a tile there) at atol 1e-5: at atol
    1e-4 the reference's own kernel and lockstep solve sit up to 9.83e-05
    apart at these widths, past rtol 1e-4 / atol 1e-5."""
    from tcgan_torch.tools import ssn_solve_ab as ab

    W, I, kw = _circuit(300, ab.BANDWIDTHS, (10.0,))
    kw.update(atol=1e-5, max_iter=10000)
    ref = solve_fixed_point_pallas(jssn.SSNConfig(**kw), jnp.asarray(W),
                                   jnp.asarray(I),
                                   check_every=ab.CHECK_EVERY,
                                   interpret=True, two_phase=False)
    out = ssn_solve.solve_fixed_point_cuda(
        tssn.SSNConfig(**kw, pallas_two_phase=False), torch.tensor(W),
        torch.tensor(I), check_every=ab.CHECK_EVERY)
    _check_against(ref, out, 600, I)
    assert out.converged.all()


@pytest.mark.parametrize("accel", [False, True])
def test_reference_rows_are_independent(accel):
    """The reference kernel's rows are independent (each its own residual,
    peak, flags, iters, frozen update and Anderson sums; the chunk count
    gating Anderson is the same for every row), so a battery solved in
    chunks of rows equals the battery solved whole, bit for bit: what the
    CUDA kernel's row chunks rely on. 3 circuits, 20 rows (5 bandwidths x
    4 contrasts), whole and as chunks of 7, 7 and 6. The widest rows at
    contrast 20 stay unresolved at max_iter, so the last chunk runs on
    after the others have stopped, as the whole battery does."""
    W, _ = _problem(B=3)
    x = np.linspace(-0.5, 0.5, BASE["N"])
    I = np.asarray(jstim.stimulus_battery(
        (0.0, 0.25, 0.5, 0.75, 1.0), (2.5, 5.0, 10.0, 20.0), jnp.asarray(x),
        0.03125), dtype=np.float32)
    cfg = jssn.SSNConfig(**BASE)

    def solve(rows):
        return solve_fixed_point_pallas(cfg, jnp.asarray(W), jnp.asarray(rows),
                                        block_b=4, check_every=8,
                                        interpret=True, two_phase=False,
                                        accel=accel)

    whole = solve(I)
    parts = [solve(I[a:a + 7]) for a in range(0, 20, 7)]
    assert 0.5 < np.asarray(whole.converged).mean() < 1.0
    for field in ("r", "converged", "diverged", "iters"):
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(getattr(p, field)) for p in parts],
                           axis=1), np.asarray(getattr(whole, field)))


# name: (N, contrasts, SSNConfig overrides, the plan's cluster size): the
# N=201 fit's solve (2N=402, S=16, clusters of 8) in the default schedule
# and with the 3xTF32 tail, n201_forward's (clusters of 4), one block past
# the register path (2N=160), the register path (N=51) and W from device
# memory (2N=600)
COUNTED_CASES = {
    "fit_2N402_S16": (201, (5.0, 10.0), {}, 8),
    "fit_2N402_S16_refine_off": (201, (5.0, 10.0),
                                 dict(pallas_refine=False), 8),
    "forward_2N402_S8": (201, (10.0,), {}, 4),
    "one_block_2N160_S8": (80, (10.0,), {}, 1),
    "register_path_2N102_S16": (51, (5.0, 10.0), {}, 1),
    "w_global_2N600_S8": (300, (10.0,), {}, 4),
}


@pytest.mark.parametrize("case", sorted(COUNTED_CASES))
def test_cpu_counts_the_plans_cluster(case):
    """Under a profiler the CPU path counts its solve under the cluster size
    of the plan that cut the plain version's tiles, as the card counts the
    plan its launch took, and no ``ssn_solve.launches_partial_sums``: no
    kernel ran. One circuit, 64 substeps."""
    from tcgan_torch.tools import ssn_solve_ab as ab
    from tcgan_torch.utils import profiling

    N, contrasts, overrides, cluster = COUNTED_CASES[case]
    cfg, W, I = ab.problem(1, contrasts, dict(atol=1e-5, max_iter=64,
                                              **overrides),
                           N=N, device="cpu", two_phase=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ssn_solve.solve_fixed_point_cuda(cfg, W, I, ab.CHECK_EVERY)
    counts = profiling.counters()
    assert {k: v for k, v in counts.items()
            if k.startswith("ssn_solve.launches_")} == {
        f"ssn_solve.launches_cluster.{cluster}": 1}


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build("ssn_solve")
    assert not list(tmp_path.glob("*.so"))


def test_find_nvcc_search_order(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert build.find_nvcc() == str(nvcc)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    assert build.find_nvcc() == str(nvcc)

