"""Plain PyTorch reference of the SSN forward pass: the weight matrices, the
stimulus battery, the fixed-point Euler solve and the tuning-curve readout.

Written from the model's equations (Arakaki, Barello & Ahmadian, PLoS
Comput Biol 15(4):e1006816, 2019) for the benchmark's comparisons. It
imports nothing of the program under test: every value the program derives
from the benchmark's inputs (W, the battery, the fixed points, the tuning
curves) is worked out here again.

    W_ij = sign(j) relu(J_ab + D_ab z_ij) exp(-(x_i - x_j)^2 / (2 S_ab^2))
    r <- min(r + alpha (f(W r + I) - r), 10 rate_stop_at),  f(u) = k relu(u)^n

with alpha = dt / tau per population. The solve runs every row in lockstep,
in chunks of ``check_every`` substeps; after a chunk a row whose last
residual max|f(u) - r| is under ``atol`` has converged, one whose rates
passed ``rate_stop_at`` has diverged, and a resolved row keeps its rates
from then on. ``iters`` is the substep count at the chunk that resolved a
row, at most ``max_iter``.

Every matrix product goes through :func:`matmul`. ``precision="fp32"`` is
what the configurations state: float32 with TF32 off. ``precision="tf32"``
rounds both operands to TF32 (10 mantissa bits) first, the precision just
below: the benchmark's control.
"""

from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32")


def full_fp32() -> None:
    """Matrix products in float32 with TF32 off, as the configurations
    state them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties away from zero); the
    gradient passes through as if unrounded."""
    x = x.to(torch.float32)
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    if precision == "tf32":
        return torch.matmul(round_tf32(a), round_tf32(b))
    if precision != "fp32":
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return torch.matmul(a, b)


def site_positions(N: int, L: float, device=None) -> torch.Tensor:
    """N sites evenly spaced over [-L/2, L/2]."""
    return torch.linspace(-L / 2.0, L / 2.0, N, dtype=torch.float32,
                          device=device)


def weights(J, D, S, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """W (B, 2N, 2N) from the (2, 2) blocks J, D, S ([post, pre], E then I)
    and the noise z (B, 2N, 2N); differentiable in J, D and S."""
    N = x.shape[0]
    pop = torch.arange(2 * N, device=x.device) // N  # 0: E, 1: I
    post, pre = pop[:, None], pop[None, :]
    xx = torch.cat([x, x])
    dist2 = (xx[:, None] - xx[None, :]) ** 2
    profile = torch.exp(-dist2 / (2.0 * S[post, pre] ** 2))
    sign = 1.0 - 2.0 * pop.to(torch.float32)  # +1 onto E columns, -1 I
    return sign * torch.relu(J[post, pre] + D[post, pre] * z) * profile


def battery(bandwidths, contrasts, x: torch.Tensor,
            smoothness: float) -> torch.Tensor:
    """The stimulus battery (len(contrasts) * len(bandwidths), 2N): a bar of
    width b at contrast c, c * sigmoid((b/2 - |x|) / smoothness) at each
    site, the same onto E and I; rows contrast-major."""
    b = torch.tensor(bandwidths, dtype=torch.float32, device=x.device)
    c = torch.tensor(contrasts, dtype=torch.float32, device=x.device)
    box = torch.sigmoid((b[:, None] / 2.0 - x.abs()[None, :]) / smoothness)
    rows = (c[:, None, None] * box[None]).reshape(-1, x.shape[0])
    return torch.cat([rows, rows], dim=-1)


def gain(circuit: dict, device=None) -> torch.Tensor:
    """alpha = dt / tau, (2N,)."""
    N = circuit["N"]
    tau = torch.cat([torch.full((N,), circuit["tau_E"]),
                     torch.full((N,), circuit["tau_I"])])
    return (circuit["dt"] / tau).to(torch.float32).to(device)


def rate_fn(u: torch.Tensor, k: float, n: float) -> torch.Tensor:
    return k * torch.relu(u) ** n


def slope_fn(u: torch.Tensor, k: float, n: float) -> torch.Tensor:
    return k * n * torch.relu(u) ** (n - 1.0)


def solve(circuit: dict, W: torch.Tensor, I: torch.Tensor, *, atol: float,
          max_iter: int, check_every: int, precision: str = "fp32"):
    """(rates (B, S, 2N), converged (B, S), diverged (B, S), iters (B, S))
    of the lockstep Euler solve described in the module docstring."""
    if circuit.get("io_type", "asym_power") != "asym_power":
        raise ValueError("the reference solves the asym_power io only")
    k, n = circuit["k"], circuit["n"]
    stop = circuit["rate_stop_at"]
    B, n2, S = W.shape[0], W.shape[-1], I.shape[0]
    Wt = W.transpose(-1, -2)
    if precision == "tf32":
        Wt = round_tf32(Wt)
    alpha = gain(circuit, W.device)
    r = torch.zeros((B, S, n2), dtype=torch.float32, device=W.device)
    conv = torch.zeros((B, S), dtype=torch.bool, device=W.device)
    div = torch.zeros_like(conv)
    iters = torch.full((B, S), max_iter, dtype=torch.int32, device=W.device)
    it = 0
    while it < max_iter:
        active = ~(conv | div)
        if not bool(active.any()):
            break
        rn = r
        for _ in range(check_every):
            delta = rate_fn(matmul(rn, Wt, precision) + I, k, n) - rn
            rn = torch.clamp(rn + alpha * delta, max=10.0 * stop)
        err = delta.abs().amax(dim=-1)
        newly_div = active & (rn.amax(dim=-1) > stop)
        newly_conv = active & ~newly_div & (err < atol)
        it += check_every
        iters = torch.where(newly_div | newly_conv,
                            torch.full_like(iters, min(it, max_iter)), iters)
        r = torch.where(active[..., None], rn, r)
        conv, div = conv | newly_conv, div | newly_div
    return r, conv, div, iters


def residual64(circuit: dict, W: torch.Tensor, I: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    """max_i |f(u_i) - r_i| of each row (B, S), in float64."""
    W64, r64 = W.to(torch.float64), r.to(torch.float64)
    u = torch.matmul(r64, W64.transpose(-1, -2)) + I.to(torch.float64)
    return (rate_fn(u, circuit["k"], circuit["n"]) - r64).abs().amax(dim=-1)


def probe(circuit: dict) -> int:
    """The neuron read out as a tuning curve: the E cell at the grid's
    centre site."""
    return circuit["N"] // 2


def tuning_curves(circuit: dict, r: torch.Tensor) -> torch.Tensor:
    """(B, S): each circuit's probe rate under every stimulus."""
    return r[..., probe(circuit)]


def circuit_inputs(circuit: dict, J, D, S, z: torch.Tensor, contrasts):
    """(W, I) of circuits with blocks J, D, S (4 numbers each, row-major)
    and noise z, under the battery at ``contrasts``."""
    device = z.device
    x = site_positions(circuit["N"], circuit["L"], device)
    blocks = [torch.as_tensor(v, dtype=torch.float32,
                              device=device).reshape(2, 2) for v in (J, D, S)]
    W = weights(*blocks, z, x)
    I = battery(circuit["bandwidths"], contrasts, x, circuit["smoothness"])
    return W, I
