"""Checkpointing of the full training state with ``torch.save``.

Port of :mod:`tcgan_tpu.train.checkpoint` (orbax there). The whole state —
generator and critic params, every optimizer state, the anchor buffers and
the step — is saved as nested dicts of tensors (NamedTuples flattened to
dicts of their fields), one file per step written atomically, the newest
``max_to_keep`` kept. ``restore`` rebuilds the structure of a template
state, so a field added to ``TrainState`` after a checkpoint was written
takes the template's fresh-init value (the reference's forward-compatible
restore); any other mismatch raises. Under a mesh of several ranks the
saved state must be equal on every rank (checked), rank 0 writes and
every rank waits at a barrier after each save; every rank restores the
same file.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

import torch

from tcgan_torch.parallel.mesh import barrier, check_replicated, is_writer

_NAME = re.compile(r"^(\d+)\.pt$")


def _to_plain(obj: Any) -> Any:
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {f: _to_plain(getattr(obj, f)) for f in obj._fields}
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    return obj


def _from_plain(saved: Any, like: Any, where: str) -> Any:
    """``saved`` in the structure, device and dtype of ``like``."""
    def mismatch():
        return ValueError(f"checkpoint field {where or '<root>'} does not "
                          "match the current state structure")

    if isinstance(like, tuple) and hasattr(like, "_fields"):
        if not isinstance(saved, dict) or set(saved) != set(like._fields):
            raise mismatch()
        return type(like)(**{f: _from_plain(saved[f], getattr(like, f),
                                            f"{where}.{f}")
                             for f in like._fields})
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            raise mismatch()
        return {k: _from_plain(saved[k], like[k], f"{where}.{k}")
                for k in like}
    if torch.is_tensor(like):
        if not torch.is_tensor(saved) or saved.shape != like.shape:
            raise mismatch()
        return saved.to(device=like.device, dtype=like.dtype)
    if like is None or saved is None:
        if like is not None or saved is not None:
            raise mismatch()
        return None
    if type(saved) is not type(like):
        raise mismatch()
    return saved


class CheckpointManager:
    """``save(step, state)`` / ``latest_step()`` / ``restore(state_like)``."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.writer = is_writer()
        if self.writer:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self):
        if not self.directory.is_dir():  # a rank ahead of rank 0's mkdir
            return []
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def save(self, step: int, state: Any):
        check_replicated(state, f"checkpoint {step}")
        if self.writer:
            path = self.directory / f"{step}.pt"
            tmp = self.directory / f"{step}.pt.tmp"
            torch.save(_to_plain(state), tmp)
            os.replace(tmp, path)
            if self.max_to_keep:
                for old in self._steps()[:-self.max_to_keep]:
                    (self.directory / f"{old}.pt").unlink()
        barrier()

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: int | None = None) -> Any:
        """Restore into the structure of ``state_like``; top-level fields the
        checkpoint lacks keep ``state_like``'s values."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        saved = torch.load(self.directory / f"{step}.pt", map_location="cpu",
                           weights_only=True)
        if not hasattr(state_like, "_fields"):
            return _from_plain(saved, state_like, "")
        fields = set(state_like._fields)
        if not set(saved) <= fields:
            raise ValueError(
                f"checkpoint {step} under {self.directory} holds fields "
                f"{sorted(set(saved) - fields)} the current state lacks")
        missing = sorted(fields - set(saved))
        if missing:
            print(f"[checkpoint] forward-compat restore of step {step}: "
                  f"checkpoint predates state field(s) {missing}; they "
                  "start from their init values")
        return state_like._replace(**{
            f: _from_plain(saved[f], getattr(state_like, f), f)
            for f in saved})
