"""The replay with which a card run holds a solver row that stopped at
another substep than the plain version's: ``stop_at`` in
``tcgan_torch.ops.fixed_point.solve_fixed_point`` (through the solver
kernel's plain version) and ``ssn_solve_ab.own_trajectory``, on the CPU at
the slice's N=51.

Tolerance: a replay to a solve's own stopping substeps is bit-equal to the
solve (the same operations on the same state); the one-phase replay of a
row alone runs another batch shape of the same operations (1e-6).

Schedules: ``one`` phase, ``two`` (the default: two phases, the refinement
tail) and ``two_3xtf32`` (``pallas_refine`` off).
"""

import pytest
import torch

from tcgan_torch.ops.cuda import ssn_solve
from tcgan_torch.tools import ssn_solve_ab as ab

CHECK_EVERY = 16


SCHEDULES = {"one": dict(two_phase=False), "two": dict(two_phase=True),
             "two_3xtf32": dict(two_phase=True, pallas_refine=False)}


def _problem(B=3, two_phase=True, **kw):
    return ab.problem(B, (5.0, 10.0), kw, seed=3, device="cpu",
                      two_phase=two_phase)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("accel", [False, True], ids=["plain", "anderson"])
def test_stop_at_own_iters_replays_the_solve(schedule, accel):
    cfg, W, I = _problem(**SCHEDULES[schedule])
    two_phase = cfg.pallas_two_phase
    fast = ssn_solve.drive_1xtf32 if two_phase else None
    out = ssn_solve.solve_fixed_point_plain(cfg, W, I, CHECK_EVERY, accel,
                                            fast_drive=fast)
    assert out.converged.all()
    rerun = ssn_solve.solve_fixed_point_plain(
        cfg, W, I, CHECK_EVERY, accel, fast_drive=fast, stop_at=out.iters)
    for a, b in zip(rerun, out):
        assert torch.equal(a, b)


def test_stop_at_moves_only_its_row():
    """A row stopped two strides past its own crossing: its iters are the
    forced count and its rates moved on; its tile-mates are untouched."""
    cfg, W, I = _problem(B=1)
    fast = ssn_solve.drive_1xtf32
    out = ssn_solve.solve_fixed_point_plain(cfg, W, I, CHECK_EVERY,
                                            fast_drive=fast)
    stop = torch.zeros_like(out.iters)
    stop[0, 3] = int(out.iters[0, 3]) + 2 * CHECK_EVERY
    rerun = ssn_solve.solve_fixed_point_plain(cfg, W, I, CHECK_EVERY,
                                              fast_drive=fast, stop_at=stop)
    assert int(rerun.iters[0, 3]) == int(stop[0, 3])
    assert bool(rerun.converged[0, 3])
    assert not torch.equal(rerun.r[0, 3], out.r[0, 3])
    others = torch.arange(I.shape[0]) != 3
    assert torch.equal(rerun.r[0, others], out.r[0, others])
    assert torch.equal(rerun.iters[0, others], out.iters[0, others])


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_own_trajectory_to_own_iters_is_the_row(schedule):
    cfg, W, I = _problem(B=1, **SCHEDULES[schedule])
    two_phase = cfg.pallas_two_phase
    fast = ssn_solve.drive_1xtf32 if two_phase else None
    out = ssn_solve.solve_fixed_point_plain(cfg, W, I, CHECK_EVERY,
                                            fast_drive=fast)
    for s in (0, 5, 11):
        own = ab.own_trajectory(cfg, W, I, 0, s, int(out.iters[0, s]),
                                CHECK_EVERY, False)
        if two_phase:
            assert torch.equal(own, out.r[0, s])
        else:  # the row alone at atol 0: the same substeps
            torch.testing.assert_close(own, out.r[0, s], rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("two_phase", [False, True], ids=["one", "two"])
def test_off_own_trajectory_fails_wrong_rates(two_phase):
    """The witness passes a row's own rates and fails them moved by 1e-3,
    or another stimulus row's rates under its iters."""
    cfg, W, I = _problem(B=1, two_phase=two_phase)
    fast = ssn_solve.drive_1xtf32 if two_phase else None
    out = ssn_solve.solve_fixed_point_plain(cfg, W, I, CHECK_EVERY,
                                            fast_drive=fast)
    assert ab.off_own_trajectory(out, cfg, W, I, 0, 5, CHECK_EVERY,
                                 False)[1]
    bumped = out.r.clone()
    bumped[0, 5, 7] += 1e-3
    assert not ab.off_own_trajectory(out._replace(r=bumped), cfg, W, I, 0, 5,
                                     CHECK_EVERY, False)[1]
    swapped = out.r.clone()
    swapped[0, 5] = out.r[0, 12]
    assert not ab.off_own_trajectory(out._replace(r=swapped), cfg, W, I, 0,
                                     5, CHECK_EVERY, False)[1]
