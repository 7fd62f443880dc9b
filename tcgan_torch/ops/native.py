"""ctypes binding of the native CPU baseline solver (``csrc/ssnode.cpp``).

Port of :mod:`tcgan_tpu.ops.native`: the same C source and signature, the
same shape checks and Euler-only guard. The library is compiled here, with
g++ and OpenMP, into ``tcgan_torch/_build/`` (git-ignored), keyed by a hash
of the source, the flags and the host CPU (``-march=native``), so an edit
rebuilds and a library built for another CPU is not loaded. The C source is
only read; a failed build raises with the compiler's output.

This is the CPU baseline a benchmark of the port measures against: float64,
batch-parallel over (circuit, stimulus) rows with OpenMP. The compilers
tried are ``$CXX``, ``g++`` on ``PATH``, ``/usr/bin/g++`` and ``clang++``, the
first that builds with ``-fopenmp`` winning. OpenMP is required, as
``csrc/Makefile`` requires it: a single-threaded baseline would inflate every
accelerator-to-CPU ratio measured against it.
Inputs are NumPy arrays or CPU tensors; outputs are NumPy arrays.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from tcgan_torch.ops.io_funs import IO_TYPES
from tcgan_torch.ops.ssn import SSNConfig

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "ssnode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-Wall", "-fPIC", "-std=c++17",
             "-shared", "-fopenmp")


class Build(NamedTuple):
    path: Path
    compiler: str


def cpu_model() -> str:
    """The host CPU's model name from ``/proc/cpuinfo``; where that says
    "unknown" (some virtual machines), its vendor, family and model
    numbers; where the file is absent, the platform's processor string."""
    fields = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    except OSError:
        return platform.processor() or platform.machine()
    name = fields.get("model name", "unknown")
    if name and name != "unknown":
        return name
    return (f"{name} ({fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')}, {platform.machine()})")


def _compilers() -> list:
    found = [os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++",
             shutil.which("clang++")]
    return list(dict.fromkeys(c for c in found
                              if c and os.access(c, os.X_OK)))


@functools.cache
def build() -> Build:
    """Compile ``csrc/ssnode.cpp`` with OpenMP unless a library of the same
    key exists; raises with every compiler's output when none builds it."""
    compilers = _compilers()
    if not compilers:
        raise RuntimeError("native solver: no C++ compiler ($CXX, g++, "
                           "clang++)")
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + cpu_model().encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libssnode-{key}.so"
    if out.exists():
        return Build(out, "(built earlier)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    for cxx in compilers:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)
            return Build(out, cxx)
        tmp.unlink(missing_ok=True)
        failures.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    raise RuntimeError("native solver build failed (OpenMP is required):\n"
                       + "\n".join(failures))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    dp, i64, dbl = (ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                    ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.ssnode_solve_batch.restype = i64
    lib.ssnode_solve_batch.argtypes = [
        dp, dp, dp, dp,  # W, I, r (in/out), tau
        i64, i64, i64,  # batch, n_stim, n2
        dbl, ctypes.c_int,  # dt, io_type
        dbl, dbl, dbl, dbl,  # k, n, rate_soft_bound, rate_hard_bound
        i64, dbl, dbl,  # max_iter, atol, rate_stop_at
        ip, ip,  # flags, iters
    ]
    lib.ssnode_num_threads.restype = ctypes.c_int32
    lib.ssnode_num_threads.argtypes = []
    return lib


def num_threads() -> int:
    """OpenMP threads the solver runs on."""
    return int(_library().ssnode_num_threads())


class NativeResult(NamedTuple):
    r: np.ndarray
    converged: np.ndarray
    diverged: np.ndarray
    iters: np.ndarray


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        if a.device.type != "cpu":
            raise ValueError(f"the native solver takes host arrays; got a "
                             f"tensor on {a.device}")
        a = a.detach().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def solve_fixed_point_native(
    cfg: SSNConfig, W, I_ext, r0=None,
) -> NativeResult:
    """Solve on the CPU with the OpenMP C++ solver (float64).

    Same contract as :func:`tcgan_torch.ops.fixed_point.solve_fixed_point`
    with a (batch, n_stim, 2N) layout; W (batch, 2N, 2N) or (2N, 2N),
    I_ext (batch, n_stim, 2N) or (n_stim, 2N)."""
    if cfg.stepper != "euler":
        raise NotImplementedError(
            "the native CPU baseline implements the reference's forward "
            "Euler only; use stepper='euler' for cross-checks against it")
    W, I_ext = _host(W), _host(I_ext)
    if W.ndim == 2:
        W = W[None]
    if I_ext.ndim == 2:
        I_ext = np.broadcast_to(I_ext[None],
                                (W.shape[0],) + I_ext.shape).copy()
    batch, n2 = W.shape[0], W.shape[-1]
    n_stim = I_ext.shape[-2]
    # The C solver indexes raw pointers: every batch/size relation is
    # checked here (a mismatched 3-D I_ext, or an I_ext/W width mismatch,
    # would read past the end of a buffer inside C). Size-1 batch dims
    # broadcast.
    if W.ndim != 3 or W.shape[-2] != n2:
        raise ValueError(f"W must be (batch, 2N, 2N); got {W.shape}")
    if I_ext.shape[-1] != n2:
        raise ValueError(
            f"I_ext width {I_ext.shape[-1]} != W width {n2}")
    if I_ext.ndim != 3:
        raise ValueError(f"I_ext must be (batch, n_stim, 2N) or "
                         f"(n_stim, 2N); got {I_ext.shape}")
    if I_ext.shape[0] != batch:
        if I_ext.shape[0] == 1:
            I_ext = np.broadcast_to(I_ext, (batch, n_stim, n2)).copy()
        elif batch == 1 and I_ext.shape[0] > 1:
            batch = I_ext.shape[0]
            W = np.broadcast_to(W, (batch, n2, n2)).copy()
        else:
            raise ValueError(
                f"batch mismatch: W has {batch}, I_ext has "
                f"{I_ext.shape[0]}")
    r = np.zeros((batch, n_stim, n2))
    if r0 is not None:
        r[...] = _host(r0)
    # float32 time constants widened to float64, as the reference's binding
    # passes them (its results are held to this one's bit for bit)
    tau = cfg.tau_vector(dtype=torch.float32).numpy().astype(np.float64)
    flags = np.zeros((batch, n_stim), dtype=np.int32)
    iters = np.zeros((batch, n_stim), dtype=np.int32)

    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa
    _library().ssnode_solve_batch(
        dptr(W), dptr(I_ext), dptr(r), dptr(tau),
        batch, n_stim, n2,
        cfg.dt, IO_TYPES.index(cfg.io_type),
        cfg.k, cfg.n, cfg.rate_soft_bound, cfg.rate_hard_bound,
        cfg.max_iter, cfg.atol, cfg.rate_stop_at,
        iptr(flags), iptr(iters),
    )
    return NativeResult(r, flags == 1, flags == 2, iters)
