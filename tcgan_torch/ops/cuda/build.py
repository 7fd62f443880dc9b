"""Build the port's CUDA sources into shared libraries with nvcc, at first use.

Each source ``tcgan_torch/csrc/<name>.cu`` has a plain C interface and is
compiled for Hopper (``sm_90a``) into ``tcgan_torch/_build/``, keyed by a
hash of the source and the flags, so an edit rebuilds and an unchanged tree
reuses the library. nvcc is looked up in ``$CUDA_HOME/bin``, then on
``PATH``, then in ``/usr/local/cuda/bin``. A failed build raises with nvcc's
output; nothing falls back to another implementation.

No ``--use_fast_math``: the solver's flags at the atol crossing depend on
exact ``expf``/``logf``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output, including ptxas' register/spill report


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise FileNotFoundError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin)")


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless a library of the same key exists."""
    src = CSRC_DIR / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{key}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return BuildResult(out, 0.0,
                           log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n"
                           f"{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)

