"""Tuning-curve datasets: file loading, fake-truth synthesis, minibatching.

Port of :mod:`tcgan_tpu.data.datasets`: load real tuning curves from
``.npz``/``.npy``/``.mat``, or synthesize a "fake truth" dataset by solving
the SSN forward at known parameters (through the CUDA solver kernel when the
device is a GPU and the backend is ``cuda``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable, Tuple

import numpy as np
import torch

from tcgan_torch.models import generator as gen_lib
from tcgan_torch.models.generator import GeneratorConfig
from tcgan_torch.train.datastore import KnownError


def load_tuning_curves(path: str | Path) -> np.ndarray:
    """Load a (num_samples, tc_dim) tuning-curve array from .npz/.npy/.mat.

    ``.npz`` uses key ``tuning_curves`` (fallback: first array). ``.mat``
    needs scipy and a variable named ``tuning_curves``, ``tc`` or
    ``tc_data``, or a single variable.
    """
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path)
    if path.suffix == ".npz":
        data = np.load(path)
        key = ("tuning_curves" if "tuning_curves" in data.files
               else data.files[0])
        return data[key]
    if path.suffix == ".mat":
        try:
            from scipy.io import loadmat
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                ".mat loading requires scipy; convert the dataset to .npz "
                "(key 'tuning_curves') instead") from e
        data = loadmat(path)
        arrays = {k: v for k, v in data.items() if not k.startswith("__")}
        for key in ("tuning_curves", "tc", "tc_data"):
            if key in arrays:
                return np.asarray(arrays[key])
        if len(arrays) == 1:
            return np.asarray(next(iter(arrays.values())))
        raise ValueError(
            f"{path} holds {sorted(arrays)} — name the tuning-curve "
            "variable 'tuning_curves' (or 'tc'), or export a single-"
            "variable file")
    raise ValueError(f"unsupported dataset format: {path.suffix}")


def generate_fake_truth(
    cfg: GeneratorConfig,
    true_J,
    true_D,
    true_S,
    num_samples: int,
    seed: int = 0,
    batch: int = 64,
    tries_factor: int = 4,
    device=None,
    zs: Iterable | None = None,
) -> np.ndarray:
    """Synthesize ground-truth tuning curves at known circuit parameters by
    solving SSN fixed points (forward only).

    Returns (num_effective_samples, tc_dim); circuits with any unconverged
    condition are dropped. Each solver batch takes its noise from ``zs``
    (an iterable of z arrays, one per batch) when given, else from a
    ``torch.Generator`` seeded with ``seed``. Raises ``KnownError`` when the
    survivor yield stays below ~1/``tries_factor``.
    """
    cfg = dataclasses.replace(cfg, solver="ift")
    device = torch.device(device or "cpu")
    params = gen_lib.init_params(cfg, true_J, true_D, true_S, device=device)
    generator = torch.Generator(device).manual_seed(seed)
    zs = iter(zs) if zs is not None else None
    spc = cfg.samples_per_circuit()
    chunks, n_done, tries = [], 0, 0
    max_tries = max(20, tries_factor * (num_samples // max(batch, 1) + 1))
    while n_done < num_samples:
        if tries >= max_tries:
            raise KnownError(
                f"fake-truth generation yielded {n_done}/{num_samples} "
                f"converged samples after {tries} batches — the 'true' "
                "circuit parameters are likely unstable or the solver "
                "budget (max_iter/atol) too tight")
        tries += 1
        with torch.no_grad():
            out = gen_lib.sample_tuning_curves(
                cfg, params, batch, z=None if zs is None else next(zs),
                generator=generator)
        ok = out.converged.all(dim=-1).cpu().numpy()  # (batch,)
        tc = out.tc.cpu().numpy()
        good = tc[ok] if cfg.track_offset_identity else tc[np.repeat(ok, spc)]
        chunks.append(good)
        n_done += good.shape[0]
    return np.concatenate(chunks, axis=0)[:num_samples]


@dataclasses.dataclass
class TuningCurveDataset:
    """In-memory dataset, staged to the device once; minibatches are
    gathered on the device."""

    tc: torch.Tensor  # (num_samples, tc_dim)

    @classmethod
    def from_array(cls, arr, dtype=torch.float32, device=None
                   ) -> "TuningCurveDataset":
        return cls(tc=torch.tensor(np.asarray(arr), dtype=dtype,
                                   device=device))

    @property
    def num_samples(self) -> int:
        return self.tc.shape[0]

    @property
    def tc_dim(self) -> int:
        return self.tc.shape[1]

    def sample_stack(self, generator: torch.Generator, n_stacks: int,
                     batch: int) -> torch.Tensor:
        """(n_stacks, batch, tc_dim) random minibatches (with replacement)."""
        idx = torch.randint(0, self.num_samples, (n_stacks, batch),
                            generator=generator, device=self.tc.device)
        return self.tc[idx]

    def moments(self) -> Tuple[torch.Tensor, torch.Tensor]:
        from tcgan_torch.models.moments import data_moments

        return data_moments(self.tc)
