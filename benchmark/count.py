"""The yardstick: operations and bytes of the work, counted from shapes and
from the reference's own substeps, and the least time an H100 could take.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit): 495 TFLOP/s TF32 on the tensor cores, 3.35 TB/s HBM3. No
fp32-accurate solve runs faster than its products at the TF32 rate, so the
TF32 peak bounds every implementation.

A solve's count does not depend on how it is implemented: 2 (2N)^2
operations per row per substep, each product counted once, over the
substeps the reference's one-phase float32 Euler solve of the same inputs
needed (``iters`` of :func:`benchmark.reference.ssn.solve`), never the
program's iterations, phases or passes; W, the battery and alpha read once,
the rates, both flags and iters written once.
"""

from __future__ import annotations

PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def solve_ops(n2: int, row_substeps: float) -> float:
    """Operations of a solve whose rows took ``row_substeps`` substeps in
    all."""
    return 2.0 * n2 * n2 * float(row_substeps)


def solve_bytes(B: int, S: int, n2: int) -> float:
    """Bytes a solve must move: W, the battery and alpha read, the rates,
    two bool flags and the int32 iters of each row written."""
    return 4.0 * (B * n2 * n2 + S * n2 + n2) + B * S * (4.0 * n2 + 2 + 4)


def least_seconds(ops: float, nbytes: float) -> float:
    """max(operations at the TF32 peak, bytes at the HBM peak)."""
    return max(ops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES)


def adjoint_ops(rows: int, n2: int) -> float:
    """The implicit gradient's least work, from shapes: per row the slope at
    the fixed point (one mat-vec, 2 (2N)^2), a dense solve of the adjoint
    system (LU, 2/3 (2N)^3, and its two triangular solves, 2 (2N)^2) and the
    row's outer product into dL/dW (2 (2N)^2)."""
    return rows * (2.0 / 3.0 * n2 ** 3 + 6.0 * n2 * n2)


def mlp_ops(rows: int, dims) -> float:
    """One forward pass of the critic over ``rows`` rows (``dims``: input
    size, hidden sizes, 1)."""
    return 2.0 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def critic_update_ops(rows: int, dims) -> float:
    """One critic update: the forward on real and fake rows and their
    backward (2 x), the gradient penalty's forward on the interpolates, its
    input gradient (1 x) and that gradient's backward to the weights (2 x
    the input gradient, 2 x the forward it was taken through)."""
    f = mlp_ops(rows, dims)
    return 3.0 * 2.0 * f + (1.0 + 1.0 + 4.0) * f


def generator_loss_ops(rows: int, dims) -> float:
    """The critic's forward on the generator's batch and its backward to the
    tuning curves."""
    return 2.0 * mlp_ops(rows, dims)
