"""Everything the program under test receives, drawn from ``--seed`` by the
benchmark's own code: each circuit batch's noise z, each fit step's noise
(critic z, GP eps, generator z) and real minibatches, and the critic's
initial weights. The reference regenerates the same tensors from the same
seed on the same device.

Each draw has a seed of its own, derived from ``--seed`` and the draw's name
and index (:func:`derive`), so any draw can be made again alone. The
generator lives on the device, so no input crosses from the host. The
critic's initial weights come from the mix's own ``critic_seed``, as
``run.gan`` draws them from its ``--seed``, so that every run's fit starts
alike and the seed changes the step's noise and rows only.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch


def derive(seed: int, *keys) -> int:
    """A 63-bit seed for the draw named by ``keys`` (strings and
    non-negative ints) under the run's ``seed``."""
    words = [int(seed) % 2**64]
    for k in keys:
        words.append(zlib.crc32(k.encode()) if isinstance(k, str) else int(k))
    hi, lo = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(hi) << 31) ^ int(lo)


class Draws:
    """Seeded draws on one device (one reseeded generator)."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = torch.device(device)
        self.gen = torch.Generator(self.device)

    def _at(self, *keys) -> torch.Generator:
        self.gen.manual_seed(derive(self.seed, *keys))
        return self.gen

    def normal(self, shape, *keys) -> torch.Tensor:
        return torch.randn(shape, generator=self._at(*keys),
                           device=self.device)

    def uniform(self, shape, *keys) -> torch.Tensor:
        return torch.rand(shape, generator=self._at(*keys),
                          device=self.device)

    def permutation(self, n: int, *keys) -> torch.Tensor:
        return torch.randperm(n, generator=self._at(*keys),
                              device=self.device)

    def circuit_z(self, batch: int, N: int, *keys) -> torch.Tensor:
        """Noise of ``batch`` circuits, (batch, 2N, 2N)."""
        return self.normal((batch, 2 * N, 2 * N), "z", *keys)

    def critic_init(self, dims) -> dict:
        """He-initialised critic weights ``w{i}`` (d_in, d_out) and zero
        biases ``b{i}`` over the layer sizes ``dims`` (input first, 1
        last)."""
        params = {}
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"w{i}"] = math.sqrt(2.0 / din) * self.normal(
                (din, dout), "critic", i)
            params[f"b{i}"] = torch.zeros((dout,), device=self.device)
        return params

    def step(self, t: int, traffic: dict, N: int, tc_data: torch.Tensor):
        """Inputs of fit step ``t``: (real stack (n_critic, batch, d),
        critic z list, GP eps list, generator z). Real rows are taken from
        a seeded permutation of the data, as many steps to a permutation as
        it holds whole, so the rows of those steps all differ."""
        n_critic, B = traffic["n_critic"], traffic["batch"]
        per_step = n_critic * B
        steps_per_perm = max(1, tc_data.shape[0] // per_step)
        perm = self.permutation(tc_data.shape[0], "rows",
                                t // steps_per_perm)
        slot = t % steps_per_perm
        idx = perm[slot * per_step:(slot + 1) * per_step]
        if idx.numel() < per_step:  # a dataset smaller than one step
            idx = perm[torch.arange(per_step, device=self.device)
                       % tc_data.shape[0]]
        real = tc_data[idx].reshape(n_critic, B, tc_data.shape[-1])
        critic_z = [self.circuit_z(B, N, "critic", t, i)
                    for i in range(n_critic)]
        eps = [self.uniform((B, 1), "eps", t, i) for i in range(n_critic)]
        return real, critic_z, eps, self.circuit_z(B, N, "gen", t)
