"""Batched SSN weight-matrix builder with Dale's-law rectification.

Port of :mod:`tcgan_tpu.ops.weights`. Two populations (E, I) of N sites on a
uniform grid; 2x2 block parameters J (mean strength), D (disorder), S
(Gaussian spatial range), each indexed [post, pre] with populations ordered
(E, I):

    W_ij = sign(pre_j) * relu(J_ab + D_ab * z_ij) * exp(-d(x_i,x_j)^2 / (2 S_ab^2))

with z_ij ~ N(0, 1) the per-connection quenched noise.
"""

from __future__ import annotations

import torch


def site_positions(N: int, L: float = 1.0, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Uniform grid of N preferred positions spanning ``[-L/2, L/2]``."""
    return torch.linspace(-L / 2.0, L / 2.0, N, dtype=dtype, device=device)


def block_matrices(J, D, S, N: int):
    """Expand (..., 2, 2) block params to full (..., 2N, 2N) matrices.

    Block [a, b] = (post population a, pre population b); neuron order in
    the flat 2N vector is [E_1..E_N, I_1..I_N].
    """
    def expand(M):
        return M.repeat_interleave(N, dim=-2).repeat_interleave(N, dim=-1)

    return expand(J), expand(D), expand(S)


def presynaptic_sign(N: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Row vector of Dale signs over presynaptic index: +1 for E, -1 for I."""
    return torch.cat([torch.ones(N, dtype=dtype, device=device),
                      -torch.ones(N, dtype=dtype, device=device)])


def build_weight(J, D, S, z, x) -> torch.Tensor:
    """Build batched Dale-constrained weight matrices.

    Args:
      J, D, S: (..., 2, 2) positive block parameters.
      z: (..., 2N, 2N) standard-normal quenched noise, one draw per circuit;
        leading dims broadcast against those of J/D/S.
      x: (N,) site positions (shared by the E and I grids).

    Returns:
      W: (..., 2N, 2N), W[i, j] = weight from presynaptic j onto
      postsynaptic i.
    """
    N = x.shape[0]
    Jf, Df, Sf = block_matrices(J, D, S, N)
    xx = torch.cat([x, x])
    dist2 = (xx[:, None] - xx[None, :]) ** 2
    profile = torch.exp(-dist2 / (2.0 * Sf**2))
    strength = torch.clamp(Jf + Df * z, min=0.0)
    return (presynaptic_sign(N, dtype=strength.dtype, device=strength.device)
            * strength * profile)


def sample_z(generator: torch.Generator, batch_shape, N: int, device,
             dtype=torch.float32) -> torch.Tensor:
    """Sample the per-connection quenched noise z ~ N(0, 1)."""
    shape = tuple(batch_shape) + (2 * N, 2 * N)
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)
