"""The yardstick on tiny shapes, against counts done by hand."""

import pytest
import torch

from benchmark import count, forward, inputs, tiny
from benchmark.reference import ssn


def test_solve_count_by_hand():
    # 2 circuits, 2N = 4, 2 rows, substeps 32 + 64 + 32 + 32 = 160
    ops = count.solve_ops(4, 160)
    assert ops == 2 * 4 * 4 * 160 == 5120
    nbytes = count.solve_bytes(2, 2, 4)
    # W 2*16, battery 2*4, alpha 4 floats read; 4 rows of 4 rates, two
    # one-byte flags and an int32 iters written
    assert nbytes == 4 * (32 + 8 + 4) + 4 * (16 + 2 + 4) == 264
    assert count.least_seconds(ops, nbytes) == pytest.approx(
        max(5120 / 495e12, 264 / 3.35e12))


def test_step_counts_by_hand():
    dims = [16, 128, 128, 1]
    f = 2 * 256 * (16 * 128 + 128 * 128 + 128)
    assert count.mlp_ops(256, dims) == f
    assert count.critic_update_ops(256, dims) == 12 * f
    assert count.generator_loss_ops(256, dims) == 2 * f
    assert count.adjoint_ops(3, 102) == pytest.approx(
        3 * (2 / 3 * 102 ** 3 + 6 * 102 ** 2))


def test_traced_count_reads_the_reference_substeps():
    cell = tiny.cell("n51_forward")
    cfg, tr = cell.config, cell.traffic
    out = forward.traced_count(cfg, tr, 5, torch.device("cpu"),
                               [("trace", 0), ("trace", 1)])
    iters = forward._reference(cfg, tr, inputs.Draws(5, "cpu"),
                               [("trace", 0), ("trace", 1)])[-1]
    n2 = 2 * cfg["circuit"]["N"]
    assert out["ops"] == 2 * n2 * n2 * float(iters.double().sum())
    assert bool((iters % cfg["circuit"]["check_every"] == 0).all())
    S, B = iters.shape[1], tr["batch"]
    assert out["bytes"] == 2 * count.solve_bytes(B, S, n2)
    assert out["least_s"] > 0

