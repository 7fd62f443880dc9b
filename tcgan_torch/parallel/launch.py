"""Starting the ranks of a mesh: one process per rank, one process group.

No reference counterpart: a JAX program sees every device from one
process, a ``torch.distributed`` program runs a process per rank. Three
ways in:

- :func:`spawn` runs a function on n fresh processes (the ``spawn`` start
  method) joined in a process group, with a ``file://`` rendezvous in a
  temporary directory, and returns each rank's result. A rank that fails
  stops the others; each collective and the whole run have a timeout. The
  tests, the multichip dryrun (:mod:`tcgan_torch.entry`) and
  ``chip_smoke.py`` use it; what they run in a rank lives in the package
  (:func:`call_each`, :func:`sharded_step`) or in a module that imports
  torch only, so a rank imports no jax.
- :func:`run_ranks` runs a CLI's ``main`` on every rank of
  ``--parallel mesh``: under ``torchrun`` the process is one rank (the
  environment's ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``); from a plain
  ``python -m`` it is one rank per visible CUDA device (spawned when there
  are several), or one rank on the CPU.
- Each rank's device is ``cuda:LOCAL_RANK`` with NCCL, or the CPU with
  gloo.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_lib
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from tcgan_torch.parallel import mesh as mesh_lib

# Seconds a rank waits in one collective before its process group fails
# it, for the ranks of a CLI run (a step holds collectives; none waits on
# another rank's checkpoint write for long).
CLI_TIMEOUT = 1800.0


def env_ranks() -> tuple[int, int, int] | None:
    """(world size, rank, local rank) from the environment ``torchrun``
    sets; None outside it."""
    if "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def in_group() -> bool:
    """Whether this process is a rank of an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _to_host(tree: Any) -> Any:
    """``tree`` with its tensors as NumPy arrays (bfloat16 as float32)."""
    def host(t):
        if not torch.is_tensor(t):
            return t
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return mesh_lib.tree_map(host, tree)


def _in_group(rank: int, world: int, init_method: str, backend: str,
              device: torch.device, timeout: float, fn: Callable,
              args: Sequence) -> Any:
    """``fn(*args)`` as rank ``rank`` of a process group that lives for the
    call."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def _rank_main(rank, world, init_method, backend, device, timeout, fn, args,
               results):
    """A spawned rank: one intra-op thread on the CPU (the ranks share the
    host's cores), the call, and its result or traceback on ``results``."""
    device = torch.device(device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        out = _to_host(_in_group(rank, world, init_method, backend, device,
                                 timeout, fn, args))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def spawn(fn: Callable, nprocs: int, args: Sequence = (), *,
          backend: str = "gloo", devices: Sequence | None = None,
          timeout: float = 300.0, deadline: float | None = 600.0) -> list:
    """Run ``fn(*args)`` on ``nprocs`` ranks, each a fresh process, in one
    process group of ``backend``; return the ranks' results in rank order,
    their tensors as NumPy arrays.

    ``fn`` is pickled by reference, so it is a module-level function of an
    importable module. ``devices``: each rank's device (default: the CPU);
    a CUDA device is made the rank's current one. ``timeout`` bounds each
    collective, ``deadline`` the whole run (None: no bound), in seconds.
    Raises ``RuntimeError`` with a failed rank's traceback,
    ``TimeoutError`` when the ranks outlast the deadline; either way every
    rank is stopped."""
    devices = [str(d) for d in (devices or ["cpu"] * nprocs)]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="tcgan_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        rank, nprocs, init, backend, devices[rank], timeout, fn, tuple(args),
        results)) for rank in range(nprocs)]
    out: dict = {}
    t_end = None if deadline is None else time.monotonic() + deadline
    end = lambda: (float("inf") if t_end is None  # noqa: E731
                   else t_end - time.monotonic())
    try:
        for p in procs:
            p.start()
        while len(out) < nprocs:  # drain the queue before joining
            left = end()
            if left <= 0:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} did "
                                   "not finish by their deadline")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                lost = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if lost and results.empty():
                    raise RuntimeError(
                        f"rank {lost[0]} of {fn.__name__} exited with code "
                        f"{procs[lost[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(min(max(end(), 1.0), 60.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(nprocs)]


# -- what a rank runs -------------------------------------------------------


def call_each(calls: Sequence) -> list:
    """One rank's run of ``calls``, ``(function, args, kwargs)`` triples of
    module-level functions, in order (several checks share one spawn);
    returns their results."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def sharded_step(kind: str, n_batch: int, n_model: int, cfg, *args,
                 **kwargs):
    """One rank's sharded step on a fresh (n_batch, n_model) mesh: ``kind``
    "gan" (:mod:`tcgan_torch.models.wgan`), "mm" (moment matching) or
    "ensemble" (``args[1]`` the K-member state, of which this rank steps
    its members; the result gathered back to K). Returns (new state,
    metrics, the collectives this rank issued by kind)."""
    from tcgan_torch.models import ensemble, moments, wgan

    mesh = mesh_lib.make_mesh(n_batch, n_model)
    if kind == "ensemble":
        step = mesh_lib.make_sharded_ensemble_step(
            ensemble.ensemble_train_step, mesh)
        n_critic, states, *rest = args
        out = step(cfg, n_critic, mesh.member_shard(states), *rest, **kwargs)
        out = mesh.gather_members(out)
    else:
        make, impl = {
            "gan": (mesh_lib.make_sharded_gan_step, wgan.train_step_impl),
            "mm": (mesh_lib.make_sharded_mm_step, moments.train_step_impl),
        }[kind]
        out = make(impl, mesh)(cfg, *args, **kwargs)
    return (*out, dict(mesh.counts))


def run_ranks(main: Callable, argv, device: torch.device) -> int:
    """``main(argv)`` on every rank of ``--parallel mesh`` (see the module
    docstring), from a process outside any process group; returns the
    largest exit code. ``device``: the CLI's resolved ``--device``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    env = env_ranks()
    if env is not None:  # torchrun started this process as one rank
        world, rank, local = env
        dev = torch.device("cuda", local) if device.type == "cuda" else device
        return _in_group(rank, world, "env://", _backend(dev), dev,
                         CLI_TIMEOUT, main, (argv,))
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > 1:
        return max(spawn(main, n, (argv,), backend="nccl",
                         devices=[f"cuda:{i}" for i in range(n)],
                         timeout=CLI_TIMEOUT, deadline=None))
    tmp = tempfile.mkdtemp(prefix="tcgan_ranks_")
    try:
        return _in_group(0, 1, "file://" + os.path.join(tmp, "rendezvous"),
                         _backend(device), device, CLI_TIMEOUT, main, (argv,))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
