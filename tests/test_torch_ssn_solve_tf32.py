"""The SSN solver kernel's arithmetic on the CPU: the lockstep solve with its
mat-vec replaced by a plain-torch 3xTF32 drive, as the kernel computes it on
the tensor cores, against the fp32 solve; and one TF32 pass, which does not
hold the fp32 solve's flags (``pytest -s`` prints the counts).

Each operand x is split into x_hi = rna_tf32(x) and x_lo = rna_tf32(x -
x_hi), where rna_tf32 rounds to nearest (ties away from zero) at a 10-bit
mantissa, done here by integer masking; u = hh + (hl + lh) + I with hh = W_hi
r_hi, hl = W_hi r_lo, lh = W_lo r_hi, each product exact in fp32 and each sum
in fp32, as the kernel's three accumulators.

Tolerance: flags equal, rates rtol 1e-4 atol 1e-5 (the kernel-vs-lockstep
tolerance of tests/test_pallas_solver.py), iters within two check strides
(the summation order differs, which can move the atol crossing by a chunk).
"""

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
from tcgan_torch.ops import stimulus, weights
from tcgan_torch.ops.cuda import ssn_solve
from tcgan_torch.tools import ssn_solve_ab as ab

# one phase: these tests hold the arithmetic of the kernel's 3xTF32 loop,
# which is all of it with pallas_two_phase off and its phase 2 with it on
BASE = dict(N=8, k=0.01, n=2.2, dt=0.001, max_iter=4000, atol=1e-6,
            pallas_two_phase=False)
RTOL, ATOL = 1e-4, 1e-5
# Circuits of the seed-3 draw of 16 (``_slice_problem``) at which one TF32
# pass flips 3, 3, 3 and 4 flags of the 16-row GAN battery at atol 1e-5
# (the other twelve flip 1-3 each); the fp32 solve resolves every row of
# all sixteen within 1,088 substeps.
TF32_FLIP_CIRCUITS = (3, 6, 9, 15)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulated solves are chains of thousands of small matmuls: one
    intra-op thread runs them fastest, and keeps this file from contending
    for the cores with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the kernel's TF32 rounding, its one-pass drive (phase 1, the refinement
# tail's W e) and its 3xTF32 drive, as the port's plain version emulates
# them
rna_tf32 = ssn_solve.rna_tf32
drive_1xtf32 = ssn_solve.drive_1xtf32
drive_3xtf32 = ssn_solve.drive_3xtf32


def _base_problem(B=5, seed=11):
    """f32 NumPy W (B, 16, 16) and battery I (2, 16), as in
    tests/test_torch_ssn_solve.py::_problem."""
    N = BASE["N"]
    z = np.random.default_rng(seed).standard_normal((B, 2 * N, 2 * N))
    x = np.linspace(-0.5, 0.5, N)
    W = jw.build_weight(np.array([[0.025, 0.02], [0.025, 0.015]]),
                        np.array([[0.1, 0.08], [0.1, 0.08]]),
                        np.array([[0.25, 0.1], [0.25, 0.1]]), z, x)
    I = jstim.stimulus_battery((0.25, 1.0), (5.0,), jnp.asarray(x), 0.03125)
    return (np.asarray(W, dtype=np.float32), np.asarray(I, dtype=np.float32))


def _slice_problem(circuits, seed=3, contrasts=(ab.CONTRAST,), **cfg_kw):
    """The forward slice's circuit (``ssn_solve_ab``'s, as chip_smoke.py
    runs it) at N=51: W (len(circuits), 102, 102), the given circuits of a
    draw of 16 from NumPy noise, and the 8-bandwidth battery at
    ``contrasts``."""
    cfg = tssn.SSNConfig(**{**ab.SLICE_SSN, "pallas_two_phase": False,
                            **cfg_kw})
    z = np.random.default_rng(seed).standard_normal(
        (16, 102, 102))[list(circuits)]
    t = lambda v: torch.tensor(v).reshape(2, 2)  # noqa: E731
    x = cfg.site_pos()
    W = weights.build_weight(t(ab.SLICE_J), t(ab.SLICE_D), t(ab.SLICE_S),
                             torch.tensor(z, dtype=torch.float32), x)
    I = stimulus.stimulus_battery(ab.BANDWIDTHS, contrasts, x,
                                  cfg.smoothness)
    return cfg, W, I


def _assert_match(out, ref, check_every):
    ref = [torch.tensor(np.array(v)) for v in ref]
    np.testing.assert_array_equal(out.converged.numpy(), ref[1].numpy())
    np.testing.assert_array_equal(out.diverged.numpy(), ref[2].numpy())
    np.testing.assert_allclose(out.r.numpy(), ref[0].numpy(), rtol=RTOL,
                               atol=ATOL)
    d_iters = (out.iters.long() - ref[3].long()).abs().max()
    assert int(d_iters) <= 2 * check_every


def _solve_3xtf32(monkeypatch, cfg, W, I, check_every, accel=False,
                  drive=drive_3xtf32):
    with monkeypatch.context() as m:
        m.setattr(tfp, "recurrent_drive", drive)
        return ssn_solve.solve_fixed_point_plain(cfg, W, I, check_every,
                                                 accel)


def test_rna_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23,
                      -(1.0 + ulp / 2), 1.0 + 1.5 * ulp, 3.0e-30, 0.0],
                     dtype=torch.float32)
    want = [1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp]
    got = rna_tf32(x)
    assert got[:5].tolist() == want
    assert got[6] == 0.0
    assert got[5].view(torch.int32) & 0x1FFF == 0
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = rna_tf32(y)
    assert ((hi - y).abs() <= y.abs() * 2.0 ** -11).all()
    lo = rna_tf32(y - hi)  # hi + lo carries ~21 bits of y
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()


def test_3xtf32_drive_is_near_fp32_and_one_pass_is_not():
    g = torch.Generator().manual_seed(1)
    W = torch.randn((4, 102, 102), generator=g) * 0.05
    r = torch.rand((4, 8, 102), generator=g) * 20.0
    I = torch.rand((8, 102), generator=g)
    exact = tssn.recurrent_drive(W.double(), r.double(), I.double())
    err3 = (drive_3xtf32(W, r, I).double() - exact).abs().max()
    err32 = (tssn.recurrent_drive(W, r, I).double() - exact).abs().max()
    err1 = (drive_1xtf32(W, r, I).double() - exact).abs().max()
    assert err3 <= 4 * err32
    assert err1 > 50 * err3


CASES = {
    # name: (SSNConfig overrides, check_every, accel)
    "plain": ({}, 1, False),
    "check8": ({}, 8, False),
    "feedforward": (dict(init="feedforward"), 4, False),
    "anderson": ({}, 8, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_solve_matches_jax_and_plain_at_base(monkeypatch, case):
    cfg_kw, check_every, accel = CASES[case]
    W, I = _base_problem()
    out = _solve_3xtf32(monkeypatch, tssn.SSNConfig(**{**BASE, **cfg_kw}),
                        torch.tensor(W), torch.tensor(I), check_every, accel)
    plain = ssn_solve.solve_fixed_point_plain(
        tssn.SSNConfig(**{**BASE, **cfg_kw}), torch.tensor(W),
        torch.tensor(I), check_every, accel)
    jcfg = jssn.SSNConfig(**{**BASE, **cfg_kw,
                             "accel": "anderson" if accel else "none"})
    ref = jfp.solve_fixed_point(jcfg, jnp.asarray(W), jnp.asarray(I),
                                check_every=check_every)
    assert np.asarray(ref.r).dtype == np.float32
    assert out.converged.all()
    _assert_match(out, ref, check_every)
    _assert_match(out, plain, check_every)


def test_3xtf32_solve_matches_plain_at_slice_width(monkeypatch):
    """N=51 (2N=102), 4 circuits, the 8-row battery, check stride 32."""
    cfg, W, I = _slice_problem(range(4))
    out = _solve_3xtf32(monkeypatch, cfg, W, I, 32)
    plain = ssn_solve.solve_fixed_point_plain(cfg, W, I, 32)
    assert float(plain.converged.float().mean()) > 0.9
    _assert_match(out, plain, 32)
    # the patch reached the solve: a different summation, not the same bits
    assert not torch.equal(out.r, plain.r)
    assert tfp.recurrent_drive is tssn.recurrent_drive


def test_one_tf32_pass_breaks_flags_where_3xtf32_holds_them(monkeypatch):
    """Why the kernel runs 3xTF32: at the GAN battery's atol 1e-5 (N=51,
    16 rows), one TF32 pass changes flags and leaves rows unconverged that
    the fp32 solve resolves; 3xTF32 does not. The four circuits are those
    of ``TF32_FLIP_CIRCUITS``; max_iter 4096 is nearly 4x the most
    substeps the fp32 solve needs (and every row that one TF32 pass leaves
    unresolved here is still unresolved at 10,000)."""
    cfg, W, I = _slice_problem(TF32_FLIP_CIRCUITS,
                               contrasts=(5.0, ab.CONTRAST), atol=1e-5,
                               max_iter=4096)
    plain = ssn_solve.solve_fixed_point_plain(cfg, W, I, 32)
    assert bool(plain.converged.all())
    one = _solve_3xtf32(monkeypatch, cfg, W, I, 32, drive=drive_1xtf32)
    three = _solve_3xtf32(monkeypatch, cfg, W, I, 32)
    for name, out in (("1xTF32", one), ("3xTF32", three)):
        both = out.converged & plain.converged
        print(f"{name}: flags differing "
              f"{int((out.converged != plain.converged).sum())} + "
              f"{int((out.diverged != plain.diverged).sum())}, unconverged "
              f"{float((~out.converged).float().mean()):.4f}, max |dr| on "
              f"rows both converged "
              f"{float((out.r - plain.r).abs()[both].max()):.3e}, max "
              f"|d iters| {int((out.iters - plain.iters).abs().max())}")
    flips = int((one.converged != plain.converged).sum()
                + (one.diverged != plain.diverged).sum())
    assert flips >= 8 and float((~one.converged).float().mean()) > 0.05
    _assert_match(three, plain, 32)


def _fp32_core_layout_bytes(n2, S, accel):
    """Shared memory of the solver's earlier layout (fp32 CUDA-core
    mat-vec): W transposed at stride round_up(2N, 4), four row planes (seven
    with Anderson) in rows of 8, and 2S + 1 ints."""
    ld, rows = (n2 + 3) // 4 * 4, (S + 7) // 8 * 8
    return 4 * (ld * n2 + rows * ld * (7 if accel else 4)) + 4 * (2 * S + 1)


def _one_block_layout_bytes(n2, S, accel):
    """Shared memory of the one-block layout before thread-block clusters
    (3xTF32 on mma.sync): W and the row planes at the least stride >= 2N
    that is 4 mod 8 (round_up(2N, 4) where that would not fit), three row
    planes (six with Anderson) in rows of 8, then 2S + rows + rows / 8 + 1
    ints."""
    rows = (S + 7) // 8 * 8

    def nbytes(ld):
        floats = n2 * ld + rows * ld * (6 if accel else 3)
        return 4 * (floats + 2 * S + rows + rows // 8 + 1)

    padded = (n2 + 4 + 7) // 8 * 8 - 4
    if nbytes(padded) <= ssn_solve.MAX_SMEM_BYTES:
        return nbytes(padded)
    return nbytes((n2 + 3) // 4 * 4)


@pytest.mark.parametrize("accel", [False, True])
def test_shared_memory_layout_admits_every_earlier_shape(accel):
    """Every (2N, S, accel) the earlier layouts fit in a block still fits:
    2N=224 at S=8, 2N=102 at S=24 with Anderson, and tiny N with hundreds
    of rows, where the bank-conflict padding gives way. Every shape the
    one-block layout held stays on one block (cluster size 1) with the
    same bytes: thread-block clusters change nothing below that limit."""
    limit = ssn_solve.MAX_SMEM_BYTES
    for n2 in range(1, 241):
        for S in range(1, 1100, 1 if n2 <= 40 else 7):
            if _fp32_core_layout_bytes(n2, S, accel) <= limit:
                assert ssn_solve.smem_bytes(n2, S, accel) <= limit, (n2, S)
            one = _one_block_layout_bytes(n2, S, accel)
            if one <= limit:
                assert ssn_solve.plan(n2, S, accel) == (1, S, 1, False), (
                    n2, S)
                assert ssn_solve.smem_bytes(n2, S, accel, 1) == one, (n2, S)
    assert ssn_solve.smem_bytes(102, 16, accel) < _fp32_core_layout_bytes(
        102, 16, accel)


def _solve_kernel_arithmetic(monkeypatch, cfg, W, I, check_every,
                             accel=False, stats=None):
    """The two-phase plain version computing what the kernel computes:
    phase 1 in one TF32 pass (``drive_1xtf32``), phase 2 in 3xTF32 or, in
    the refinement tail, its anchor in 3xTF32 and its ``W e`` in one TF32
    pass."""
    with monkeypatch.context() as m:
        m.setattr(tfp, "recurrent_drive", drive_3xtf32)
        return ssn_solve.solve_fixed_point_plain(
            cfg, W, I, check_every, accel,
            fast_drive=drive_1xtf32, stats=stats)


@pytest.mark.parametrize("refine", [True, False], ids=["refine", "3xtf32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_two_phase_kernel_arithmetic_matches_jax(monkeypatch, case, refine):
    """The kernel's two-phase arithmetic (phase 1 one TF32 pass, phase 2
    3xTF32, or the refinement tail: a 3xTF32 anchor and ``W e`` in one
    TF32 pass) against the reference's two-phase kernel with the same
    ``refine`` in interpret mode at block_b=1 (its default-precision
    passes in fp32 on the CPU): flags equal, rates within rtol/atol, iters
    within two strides."""
    from tcgan_tpu.ops.pallas import solve_fixed_point_pallas

    cfg_kw, check_every, accel = CASES[case]
    kw = {**BASE, **cfg_kw, "pallas_two_phase": True,
          "pallas_refine": refine}
    W, I = _base_problem()
    out = _solve_kernel_arithmetic(monkeypatch, tssn.SSNConfig(**kw),
                                   torch.tensor(W), torch.tensor(I),
                                   check_every, accel)
    ref = solve_fixed_point_pallas(jssn.SSNConfig(**kw), jnp.asarray(W),
                                   jnp.asarray(I), block_b=1,
                                   check_every=check_every, interpret=True,
                                   refine=refine, accel=accel)
    assert out.converged.all()
    _assert_match(out, ref, check_every)


def test_two_phase_holds_the_flags_one_tf32_pass_breaks(monkeypatch):
    """Where one TF32 pass over the whole solve changes flags
    (``TF32_FLIP_CIRCUITS``, the GAN battery at atol 1e-5), the two-phase
    schedule with a TF32 first phase and the 3xTF32 tail gives the fp32
    flags: phase 2 decides every flag again at full precision. Its iters
    are the fp32 two-phase solve's within two strides, and phase 1 runs a
    share of the substeps (``pytest -s`` prints it)."""
    cfg, W, I = _slice_problem(TF32_FLIP_CIRCUITS,
                               contrasts=(5.0, ab.CONTRAST), atol=1e-5,
                               max_iter=4096, pallas_two_phase=True,
                               pallas_refine=False)
    fp32 = ssn_solve.solve_fixed_point_plain(cfg, W, I, 32)
    one_phase = ssn_solve.solve_fixed_point_plain(
        dataclasses.replace(cfg, pallas_two_phase=False), W, I, 32)
    assert bool(fp32.converged.all())
    assert torch.equal(fp32.converged, one_phase.converged)
    stats = {}
    out = _solve_kernel_arithmetic(monkeypatch, cfg, W, I, 32, stats=stats)
    _assert_match(out, fp32, 32)
    p1, p2 = stats["phase1_substeps"].sum(), stats["phase2_substeps"].sum()
    print(f"two phases, TF32 phase 1: phase 1's share of the substeps "
          f"{float(p1 / (p1 + p2)):.4f}, max |dr| from fp32 "
          f"{float((out.r - fp32.r).abs().max()):.3e}")
    assert p1 > 0 and p2 > 0


@pytest.mark.parametrize("circuits", [TF32_FLIP_CIRCUITS, tuple(range(16))],
                         ids=["flip_circuits", "all16"])
def test_refine_holds_the_flags_one_tf32_pass_breaks(monkeypatch, circuits):
    """The refinement tail in the kernel's arithmetic (phase 1 and ``W e``
    in one TF32 pass, the anchor in 3xTF32) where one TF32 pass over the
    whole solve changes flags (``TF32_FLIP_CIRCUITS``, the GAN battery at
    atol 1e-5; and all 16 circuits of the draw): the flags of the fp32
    two-phase solve with the 3xTF32 tail, rates within rtol/atol, iters
    within two strides; the one-pass rounding of ``W e`` is relative to
    the correction, not the rates (``pytest -s`` prints the counts)."""
    cfg, W, I = _slice_problem(circuits, contrasts=(5.0, ab.CONTRAST),
                               atol=1e-5, max_iter=4096,
                               pallas_two_phase=True)
    fp32 = ssn_solve.solve_fixed_point_plain(
        dataclasses.replace(cfg, pallas_refine=False), W, I, 32)
    assert bool(fp32.converged.all())
    stats = {}
    out = _solve_kernel_arithmetic(monkeypatch, cfg, W, I, 32, stats=stats)
    p1, p2 = stats["phase1_substeps"].sum(), stats["phase2_substeps"].sum()
    print(f"refinement tail, kernel arithmetic, {len(circuits)} circuits: "
          f"flags differing {int((out.converged != fp32.converged).sum())}"
          f" + {int((out.diverged != fp32.diverged).sum())}, max |dr| "
          f"{float((out.r - fp32.r).abs().max()):.3e}, max |d iters| "
          f"{int((out.iters - fp32.iters).abs().max())}, phase 1's share of "
          f"the substeps {float(p1 / (p1 + p2)):.4f}")
    _assert_match(out, fp32, 32)
    assert p1 > 0 and p2 > 0
