"""SSN input/output (f-I curve) nonlinearities.

Port of :mod:`tcgan_tpu.ops.io_funs`: the same three io types and closed-form
derivatives, as plain torch functions that broadcast over any batch shape.

io types:

- ``asym_power``:  f(u) = k * relu(u)**n            (the paper's form)
- ``asym_tanh``:   power law below a soft bound r0, then saturating smoothly
                   toward a hard bound r1:
                   f = fp                              if fp <= r0
                       r0 + (r1-r0)*tanh((fp-r0)/(r1-r0))  otherwise
- ``asym_linear``: power law below r0, then C^1 linear continuation:
                   f = r0 + fp'(u0) * (u - u0)       for u > u0,
                   where u0 = rate_to_volt(r0).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

IO_TYPES = ("asym_power", "asym_tanh", "asym_linear")


def asym_power(u, k, n):
    """Rectified power law ``k * relu(u)**n``."""
    return k * torch.pow(torch.clamp(u, min=0.0), n)


def asym_power_deriv(u, k, n):
    """d/du of :func:`asym_power` (closed form)."""
    return k * n * torch.pow(torch.clamp(u, min=0.0), n - 1.0)


def rate_to_volt(r, k, n):
    """Inverse of the power law: the u >= 0 with ``k*u**n == r``."""
    return torch.pow(torch.clamp(r, min=0.0) / k, 1.0 / n)


def linear_knee(k, n, r0):
    """(u0, slope) of the asym_linear continuation, in float64 on the host."""
    u0 = (max(r0, 0.0) / k) ** (1.0 / n)
    return u0, k * n * u0 ** (n - 1.0)


def asym_tanh(u, k, n, r0, r1):
    """Power law saturating smoothly to the hard bound ``r1``.

    Below the soft bound ``r0`` this is exactly ``asym_power``; above, the
    excess rate is squashed through tanh so f(u) < r1 for all u.
    """
    fp = asym_power(u, k, n)
    d = r1 - r0
    # clip the tanh argument as the reference does: tanh is 1.0 to machine
    # precision beyond ~20
    arg = torch.clamp(torch.clamp(fp - r0, min=0.0) / d, 0.0, 30.0)
    return torch.where(fp <= r0, fp, r0 + d * torch.tanh(arg))


def asym_tanh_deriv(u, k, n, r0, r1):
    fp = asym_power(u, k, n)
    dfp = asym_power_deriv(u, k, n)
    d = r1 - r0
    t = torch.tanh(torch.clamp(torch.clamp(fp - r0, min=0.0) / d, 0.0, 30.0))
    return torch.where(fp <= r0, dfp, dfp * (1.0 - t * t))


def asym_linear(u, k, n, r0):
    """Power law below the soft bound ``r0``, C^1 linear continuation above.

    The linear branch is the first-order Taylor expansion of the power law at
    u0 = rate_to_volt(r0): f(u) = r0 + k*n*u0**(n-1) * (u - u0).
    """
    u0, slope = linear_knee(k, n, r0)
    fp = asym_power(u, k, n)
    return torch.where(u <= u0, fp, r0 + slope * (u - u0))


def asym_linear_deriv(u, k, n, r0):
    u0, slope = linear_knee(k, n, r0)
    return torch.where(u <= u0, asym_power_deriv(u, k, n),
                       torch.full_like(u, slope))


def make_io_fun(io_type: str, k, n, r0=100.0, r1=200.0) -> Callable:
    """Return ``f(u)`` for the given io type with parameters bound."""
    if io_type == "asym_power":
        return partial(asym_power, k=k, n=n)
    if io_type == "asym_tanh":
        return partial(asym_tanh, k=k, n=n, r0=r0, r1=r1)
    if io_type == "asym_linear":
        return partial(asym_linear, k=k, n=n, r0=r0)
    raise ValueError(f"unknown io_type {io_type!r}; expected one of {IO_TYPES}")


def make_io_deriv(io_type: str, k, n, r0=100.0, r1=200.0) -> Callable:
    """Closed-form derivative matching :func:`make_io_fun`."""
    if io_type == "asym_power":
        return partial(asym_power_deriv, k=k, n=n)
    if io_type == "asym_tanh":
        return partial(asym_tanh_deriv, k=k, n=n, r0=r0, r1=r1)
    if io_type == "asym_linear":
        return partial(asym_linear_deriv, k=k, n=n, r0=r0)
    raise ValueError(f"unknown io_type {io_type!r}; expected one of {IO_TYPES}")
