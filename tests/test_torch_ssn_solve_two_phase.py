"""The SSN solver kernel's two-phase schedule on the CPU: the CPU path of
``tcgan_torch.ops.cuda.ssn_solve.solve_fixed_point_cuda`` (its plain torch
version, in the port's default schedule) against the Pallas kernel
``solve_fixed_point_pallas`` run in interpret mode with ``two_phase=True``
(``_solver_kernel`` :291-343), in f32 on identical NumPy inputs.

The port's phase boundary belongs to one circuit's chunk of rows, so the
reference runs at ``block_b=1``, on each chunk of rows where the port's plan
splits the battery. On the CPU both first phases run in fp32 (what the
reference's default-precision pass computes here), so the schedules match.

Tolerance: flags equal, rates rtol 1e-4 atol 1e-5 (the kernel-vs-lockstep
tolerance of tests/test_pallas_solver.py), iters within one check stride
(the mat-vec's summation order differs, which can move a crossing by a
chunk).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.ops import fixed_point as jfp
from tcgan_tpu.ops import ssn as jssn
from tcgan_tpu.ops.pallas import solve_fixed_point_pallas
from tcgan_torch.ops import fixed_point
from tcgan_torch.ops import ssn as tssn
from tcgan_torch.ops.cuda import ssn_solve
from tests.test_torch_ssn_solve import (ATOL, BASE, CASES, RTOL, _problem,
                                        _runaway_problem)

RUNAWAY = dict(N=4, k=0.05, n=2.2, dt=0.002, max_iter=512,
               rate_stop_at=200.0, atol=1e-6)


def _reference(cfg_kw, W, I, check_every, accel=False, refine=True):
    return solve_fixed_point_pallas(
        jssn.SSNConfig(**cfg_kw), jnp.asarray(W), jnp.asarray(I), block_b=1,
        check_every=check_every, interpret=True, two_phase=True,
        refine=refine, accel=accel)


def _port(cfg_kw, W, I, check_every, accel=False):
    return ssn_solve.solve_fixed_point_cuda(
        tssn.SSNConfig(**cfg_kw), torch.tensor(W), torch.tensor(I),
        check_every=check_every, accel=accel)


def _assert_match(out, ref, stride):
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.diverged.numpy(),
                                  np.asarray(ref.diverged))
    np.testing.assert_allclose(out.r.numpy(), np.asarray(ref.r), rtol=RTOL,
                               atol=ATOL)
    d_iters = np.abs(out.iters.numpy().astype(np.int64)
                     - np.asarray(ref.iters, np.int64))
    assert d_iters.max() <= stride


@pytest.mark.parametrize("refine", [True, False], ids=["refine", "no_refine"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_path_matches_pallas_two_phase(case, refine):
    """The two-phase twin of test_torch_ssn_solve.py::
    test_cpu_path_matches_pallas_interpret: the port's default schedule
    against the reference's, with the refinement tail (the default) and
    without, each held to the reference with the same ``refine``."""
    cfg_kw, check_every, accel, B = CASES[case]
    W, I = _runaway_problem() if case == "diverge" else _problem(B)
    kw = {**BASE, **cfg_kw, "pallas_refine": refine}
    ref = _reference(kw, W, I, check_every, accel, refine)
    out = _port(kw, W, I, check_every, accel)
    _assert_match(out, ref, check_every)
    if case == "diverge":
        assert out.diverged.all() and torch.isfinite(out.r).all()
    else:
        assert out.converged.all()


def test_default_schedule_iters_are_the_references():
    """``_problem(B=4)`` at check stride 8: the reference's two-phase iters
    (208 216 216 216 208 216 208 216 at any block_b), which one phase gives
    8 substeps fewer on the rows that wait for their circuit's other row;
    the same with the refinement tail (the default) and without."""
    W, I = _problem(B=4)
    out = _port(BASE, W, I, 8)
    plain_tail = _port({**BASE, "pallas_refine": False}, W, I, 8)
    for o in (out, plain_tail):
        assert o.iters.flatten().tolist() == [208, 216, 216, 216, 208, 216,
                                              208, 216]
    one = _port({**BASE, "pallas_two_phase": False}, W, I, 8)
    assert one.iters.flatten().tolist() == [200, 216, 208, 216, 200, 216,
                                            200, 216]
    # the same fixed point: without the refinement tail each row runs the
    # same fp32 iterates, paused; the tail rounds r_base + e apart
    torch.testing.assert_close(plain_tail.r, one.r, rtol=0, atol=0)
    torch.testing.assert_close(out.r, one.r, rtol=RTOL, atol=ATOL)
    assert not torch.equal(out.r, one.r)


@pytest.mark.parametrize("margin,want", [(0.0, [64, 64]), (2.0, [32, 32])])
def test_runaway_iters_at_reopen_margin(margin, want):
    """Hard divergers: at margin 0 phase 2 reopens them and they diverge
    again a chunk later; at 2.0 they keep their phase-1 flag and iters. The
    reference's iters either way."""
    W, I = _runaway_problem()
    kw = {**RUNAWAY, "pallas_reopen_margin": margin}
    ref = _reference(kw, W, I, 32)
    out = _port(kw, W, I, 32)
    assert out.iters.flatten().tolist() == want
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    assert out.diverged.all()
    assert float(out.r.max()) <= 10.0 * RUNAWAY["rate_stop_at"]


def test_reopen_margin_same_flags_fewer_iters():
    """Port of tests/test_pallas_solver.py::
    test_reopen_margin_same_flags_fewer_iters: two hard divergers and two
    convergers; margin 2.0 gives the flags and converged rates of margin 0
    and of the lockstep solve, no more iters on the diverged rows, and the
    reference's iters at each margin."""
    g0, g1 = np.random.default_rng(0), np.random.default_rng(1)
    W = np.concatenate([8.0 * np.abs(g0.standard_normal((2, 8, 8))),
                        0.01 * np.abs(g1.standard_normal((2, 8, 8)))]
                       ).astype(np.float32)
    I = 10.0 * np.ones((1, 8), np.float32)
    kw = {**RUNAWAY, "atol": 1e-4}
    lock = jfp.solve_fixed_point(jssn.SSNConfig(**kw), jnp.asarray(W),
                                 jnp.asarray(I), check_every=32)
    out0 = _port(kw, W, I, 32)
    outm = _port({**kw, "pallas_reopen_margin": 2.0}, W, I, 32)
    for out in (out0, outm):
        np.testing.assert_array_equal(out.diverged.numpy(),
                                      np.asarray(lock.diverged))
        np.testing.assert_array_equal(out.converged.numpy(),
                                      np.asarray(lock.converged))
    assert bool(out0.diverged[:2].all()) and bool(out0.converged[2:].all())
    torch.testing.assert_close(outm.r[2:], out0.r[2:], rtol=1e-5,
                               atol=1e-6)
    assert (outm.iters[:2] <= out0.iters[:2]).all()
    assert (outm.iters[:2] < out0.iters[:2]).any()
    for margin, out in ((0.0, out0), (2.0, outm)):
        ref = _reference({**kw, "pallas_reopen_margin": margin}, W, I, 32)
        np.testing.assert_array_equal(out.iters.numpy(),
                                      np.asarray(ref.iters))


@pytest.fixture
def one_torch_thread():
    """torch's intra-op threads at one while the test runs. The plain
    version's lockstep solve of a 256-row battery issues thousands of small
    ops; with other test workers busy on the same cores, each op's parallel
    region waits for threads the scheduler has put aside (on 8 cores beside
    five such solves: 1.6 s with one thread, not done in 10 minutes with
    8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("refine,rows", [(True, 88), (False, 128)],
                         ids=["refine", "no_refine"])
@pytest.mark.usefixtures("one_torch_thread")
def test_row_chunks_are_the_tiles(refine, rows):
    """2N=102 with a 256-row battery (32 contrasts of 8 bandwidths): the
    plan cuts it into 2 chunks of 128 rows (3 of 88 in the refinement
    tail's layout), and each chunk switches phase on its own rows, as the
    reference does with each chunk as its battery at block_b=1."""
    from tcgan_torch.tools import ssn_solve_ab as ab

    from tests.test_torch_ssn_solve import _circuit

    chunks = -(-256 // rows)
    assert ssn_solve.plan(102, 256, False, refine=refine) == (
        1, rows, chunks, False)
    W, I, kw = _circuit(51, ab.BANDWIDTHS,
                        tuple(0.3125 * k for k in range(1, 33)))
    kw = {**kw, "pallas_refine": refine}
    out = _port(kw, W, I, ab.CHECK_EVERY)
    parts = [_reference(kw, W, I[a:a + rows], ab.CHECK_EVERY, refine=refine)
             for a in range(0, 256, rows)]
    ref = type(parts[0])(*(np.concatenate([np.asarray(getattr(p, f))
                                           for p in parts], axis=1)
                           for f in parts[0]._fields))
    _assert_match(out, ref, ab.CHECK_EVERY)
    assert float(out.converged.float().mean()) > 0.9
    # with the whole battery as one tile (the port's plain version), rows
    # wait for other rows
    cfg = tssn.SSNConfig(**kw)
    s = ssn_solve.schedule(cfg)
    whole = fixed_point.solve_fixed_point(
        cfg, torch.tensor(W), torch.tensor(I), check_every=ab.CHECK_EVERY,
        two_phase=fixed_point.TwoPhase(256, s.coarse, s.max_iter1,
                                       s.reopen_at, refine=s.refine))
    assert (out.iters != whole.iters).any()


def test_schedule_flags_are_checked():
    """A bad schedule flag raises, on CPU tensors too; nothing falls back
    to another schedule."""
    W, I = _problem(B=1)
    for bad in (dict(pallas_reopen_margin=-1.0),
                dict(pallas_reopen_margin=float("nan")),
                dict(pallas_reopen_margin=float("inf")),
                dict(pallas_two_phase=1), dict(pallas_refine="on")):
        with pytest.raises(ValueError, match="pallas_"):
            _port({**BASE, **bad}, W, I, 8)
    s = ssn_solve.schedule(tssn.SSNConfig(**BASE, pallas_reopen_margin=2.0))
    assert s == (True, 1e-2, 2000, 400.0, True)
    s = ssn_solve.schedule(tssn.SSNConfig(atol=1e-3))
    assert (s.coarse, s.reopen_at) == (0.1, 0.0)
    # the refinement tail acts in two phases only, as in the reference
    for two, refine in ((True, False), (False, True), (False, False)):
        s = ssn_solve.schedule(tssn.SSNConfig(pallas_two_phase=two,
                                              pallas_refine=refine))
        assert (s.two_phase, s.refine) == (two, False)


@pytest.mark.parametrize("refine", [True, False], ids=["refine", "no_refine"])
def test_two_phase_cpu_path_launches_nothing(refine):
    """The two-phase CPU path is the plain version (``stats``: the substeps
    of each phase) and counts no launch."""
    W, I = _problem(B=3)
    counts = lambda: (ssn_solve.launches, ssn_solve.launches_two_phase,  # noqa: E731
                      ssn_solve.launches_refine)
    before = counts()
    cfg = tssn.SSNConfig(**BASE, pallas_refine=refine)
    out = ssn_solve.solve_fixed_point_cuda(cfg, torch.tensor(W),
                                           torch.tensor(I), check_every=8)
    stats = {}
    ref = ssn_solve.solve_fixed_point_plain(cfg, torch.tensor(W),
                                            torch.tensor(I), 8, stats=stats)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert counts() == before
    p1, p2 = stats["phase1_substeps"], stats["phase2_substeps"]
    assert p1.shape == p2.shape == out.iters.shape
    # a row runs until it resolves in each phase, paused in between
    assert ((p1 > 0) & (p2 > 0)).all() and (p1 + p2 <= out.iters).all()



def test_refine_tail_runs_in_the_one_lockstep_loop():
    """The refinement tail is the TPU kernel's (``_solver_kernel``
    :252-273) in ``fixed_point.solve_fixed_point``: a one-substep chunk
    from r_base = f(I) (feedforward init) is r_base + min(alpha delta,
    ceiling - r_base) with delta = f(W r_base + I) - r_base (the 3xTF32
    tail's: min(r + alpha delta, ceiling)); over more substeps the two
    round apart. Where one tile of a battery is still in phase 1 while
    another has switched, the rows in phase 1 run the same bits with the
    tail on or off."""
    from tcgan_torch.ops import fixed_point as tfp

    W, I = (torch.tensor(a) for a in _problem(B=2))
    cfg = tssn.SSNConfig(**BASE, init="feedforward")
    f, alpha = cfg.io_fun(), cfg.step_gain(dtype=torch.float32)
    tail = tfp.TwoPhase(rows=1, coarse=1e-2, max_iter1=0, reopen_at=0.0,
                        refine=True)
    one = [tfp.solve_fixed_point(dataclasses.replace(cfg, max_iter=1), W, I,
                                 check_every=1, two_phase=sched)
           for sched in (tail, tail._replace(refine=False))]
    r0 = f(I).expand_as(one[0].r)
    delta = f(tssn.recurrent_drive(W, r0, I)) - r0
    assert torch.equal(one[0].r, r0 + torch.minimum(
        alpha * delta, 10.0 * cfg.rate_stop_at - r0))
    assert torch.equal(one[1].r, torch.minimum(
        r0 + alpha * delta, torch.tensor(10.0 * cfg.rate_stop_at)))

    # each row its own tile: stop the solve where some rows have switched
    # and others are still in phase 1
    stats = {}
    sched = tail._replace(coarse=1e-3, max_iter1=2000)
    tfp.solve_fixed_point(cfg, W, I, check_every=8, two_phase=sched,
                          stats=stats)
    p1 = stats["phase1_substeps"]
    stop = int(p1.min()) + 16
    assert int(p1.max()) > stop
    early = dataclasses.replace(cfg, max_iter=stop)
    on, off = (tfp.solve_fixed_point(early, W, I, check_every=8,
                                     two_phase=sched._replace(refine=r))
               for r in (True, False))
    in_phase1 = p1 > stop
    assert torch.equal(on.r[in_phase1], off.r[in_phase1])
    assert not torch.equal(on.r[~in_phase1], off.r[~in_phase1])
    torch.testing.assert_close(on.r, off.r, rtol=RTOL, atol=ATOL)
