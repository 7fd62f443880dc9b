"""Process-group mesh and sharded train-step factories.

Port of :mod:`tcgan_tpu.parallel.mesh` on ``torch.distributed``. The
reference names a (batch, model) mesh and lets GSPMD partition one global
program; PyTorch has no partitioner, so the same global semantics are
written here with explicit collectives. A step sharded over P ranks
computes what the unsharded step computes on the same noise; only the work
is split.

- **Batch axis (sample parallel).** Every rank draws the same full noise
  and keeps its B/P rows of ``z`` (``generator.sample_tuning_curves``);
  each solves its own circuits (on the CUDA backend, one kernel launch per
  rank); the solver's outputs are gathered over the batch group
  (:meth:`Mesh.gather_rows`) and everything downstream (critic, losses,
  moments, metrics, optimizers) is computed identically on every rank.
  :meth:`Mesh.reduce_grad` sums the gradient of J, D and S over the ranks
  where they enter the weight build, so each rank's graph reaches only its
  own circuits and every rank gets the full gradient before the
  optimizer's global-norm clip. The implicit adjoint's stop test takes
  its max over every rank's circuits (:class:`Split`): one all-reduce per
  check-stride chunk of adjoint iterations, the chunk replayed up to the
  batch's stop, so the ranks stop where the unsharded batch does.
- **Model axis (tensor parallel over 2N, optional).** W's columns, the
  presynaptic axis, split over the model group (:class:`ModelAxis`): the
  drive ``r @ W^T`` is a sum of per-rank partial products (the psum XLA
  inserts; differentiable through :class:`_ModelDrive`, for the BPTT
  unroll), the adjoint's ``(phi * lam) @ W`` a gather of per-rank column
  slices; the direct adjoint gathers W's columns once per backward. The
  CUDA kernel solves whole circuits of a whole W, so on that backend the
  model group splits the circuits instead (:meth:`ModelAxis.rows`): each
  of its ranks builds W whole for its 1/M of them, solves them and runs
  their adjoint, and the outputs are gathered back over the group
  (:meth:`ModelAxis.gather_rows`); the adjoint's stop test then spans the
  model group too.
- **Members (ensembles).** :func:`make_sharded_ensemble_step`: each rank
  steps its K/P members, with no collective across members.

Collectives are ``all_reduce`` and ``barrier`` only, so they run on NCCL
and on gloo with CPU or CUDA tensors. A gather is an ``all_reduce`` of a
zero-filled full-size buffer: exact (x + 0 = x), at P times the bytes of
the rows.

The active mesh is process state, set by :func:`set_mesh` as
``jax.set_mesh`` sets it in the reference; a generator config with mesh
axes raises outside it. :mod:`tcgan_torch.parallel.launch` starts the
ranks.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist

BATCH_AXIS = "batch"
MODEL_AXIS = "model"

_current: "Mesh | None" = None


def mesh_shape(world_size: int, n_batch: int | None = None,
               n_model: int = 1) -> tuple[int, int]:
    """(n_batch, n_model) of a mesh over ``world_size`` ranks, with the
    reference's checks (``make_mesh``); the mesh must also use every rank,
    since a rank outside it would wait at its first collective."""
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_batch is None:
        if world_size % n_model:
            raise ValueError(
                f"{world_size} ranks not divisible by n_model={n_model} — a "
                f"silent floor would idle {world_size % n_model} rank(s)")
        n_batch = world_size // n_model
    if n_batch < 1 or n_batch * n_model > world_size:
        raise ValueError(f"mesh {n_batch}x{n_model} needs {n_batch * n_model}"
                         f" ranks, have {world_size}")
    if n_batch * n_model < world_size:
        raise ValueError(f"mesh {n_batch}x{n_model} leaves "
                         f"{world_size - n_batch * n_model} of {world_size} "
                         "ranks outside it")
    return n_batch, n_model


def row_slice(n: int, parts: int, index: int,
              axis: str = BATCH_AXIS) -> slice:
    """Part ``index`` of ``n`` rows split into ``parts`` equal parts; a
    split that would drop rows raises ``ValueError``."""
    if n % parts:
        raise ValueError(f"batch {n} does not split over the {parts}-rank "
                         f"{axis} axis of the mesh")
    k = n // parts
    return slice(index * k, (index + 1) * k)


class _GatherRows(torch.autograd.Function):
    """All-gather of row shards along ``dim``; the backward is the local
    slice of the cotangent, which is already the full one on every rank
    because everything downstream is replicated. (The backward of
    ``torch.distributed.nn.functional.all_gather`` sums the cotangents over
    the ranks, which with a replicated loss multiplies the gradient by P.)"""

    @staticmethod
    def forward(ctx, x, dim, index, parts, group):
        ctx.dim, ctx.start, ctx.n = dim, index * x.shape[dim], x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= parts
        full = x.new_zeros(shape)
        full.narrow(dim, ctx.start, ctx.n).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None, None, None


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the backward sums the cotangents of all inputs
    over ``group`` in one all-reduce."""

    @staticmethod
    def forward(ctx, counts, group, *xs):
        ctx.counts, ctx.group = counts, group
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        ctx.counts["reduce_grad"] += 1
        out, pos = [], 0
        for s in ctx.shapes:
            n = s.numel()
            out.append(flat[pos:pos + n].reshape(s))
            pos += n
        return (None, None, *out)


class _ModelDrive(torch.autograd.Function):
    """The drive ``r @ W^T`` with W's columns split over the model group:
    ``r`` (..., S, 2N) whole on every rank, ``W`` this rank's columns
    (..., 2N, 2N/M). The forward sums the partial products in one
    all-reduce; the backward, given the replicated cotangent ``g`` of the
    drive, returns W's columns' cotangent ``g^T r[..., cols]`` (local) and
    r's, ``W^T g`` made whole from each rank's columns in one collective:
    slicing r alone would drop the other ranks' columns of it."""

    @staticmethod
    def forward(ctx, r, W, model):
        cols = model.cols(r.shape[-1])
        rc = r[..., cols]
        ctx.save_for_backward(rc, W)
        ctx.model, ctx.shapes = model, (r.shape, W.shape)
        return model.psum(torch.matmul(rc, W.transpose(-1, -2)))

    @staticmethod
    def backward(ctx, g):
        rc, W = ctx.saved_tensors
        r_shape, w_shape = ctx.shapes
        g_r = g_w = None
        if ctx.needs_input_grad[0]:
            g_r = ctx.model.gather_cols(torch.matmul(g, W), r_shape[-1])
            g_r = g_r.sum_to_size(r_shape)
        if ctx.needs_input_grad[1]:
            g_w = torch.matmul(g.transpose(-1, -2), rc).sum_to_size(w_shape)
        return g_r, g_w, None


@dataclasses.dataclass
class ModelAxis:
    """This rank's part of the model axis: the contiguous slice ``cols`` of
    W's 2N columns and the collectives over its model group that the
    solvers and the adjoint call (``ops.ssn.recurrent_drive``,
    ``ops.fixed_point``, ``ops.euler``, ``ops.ift``)."""

    index: int
    size: int
    group: Any
    counts: collections.Counter

    def cols(self, n2: int) -> slice:
        if n2 % self.size:
            raise ValueError(f"2N={n2} does not split over a model axis of "
                             f"{self.size}")
        w = n2 // self.size
        return slice(self.index * w, (self.index + 1) * w)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the ranks' partial products, in place."""
        dist.all_reduce(x, group=self.group)
        self.counts["model_psum"] += 1
        return x

    def drive(self, r: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        """``r @ W^T`` summed over the group, differentiable with respect to
        r and this rank's columns W (:class:`_ModelDrive`)."""
        return _ModelDrive.apply(r, W, self)

    def gather_cols(self, x: torch.Tensor, n2: int,
                    kind: str = "model_gather") -> torch.Tensor:
        """The full (..., 2N) from each rank's column slice (..., 2N/M)."""
        full = x.new_zeros(x.shape[:-1] + (n2,))
        full[..., self.cols(n2)] = x
        dist.all_reduce(full, group=self.group)
        self.counts[kind] += 1
        return full

    def rows(self, n: int) -> slice:
        """This rank's share of ``n`` circuits (:func:`row_slice`)."""
        return row_slice(n, self.size, self.index, MODEL_AXIS)

    def gather_rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's :meth:`rows` of ``x`` along ``dim``, in rank order,
        on every rank of the group, in one collective."""
        self.counts["model_gather_rows"] += 1
        return _GatherRows.apply(x, dim, self.index, self.size, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the group, in place: every rank takes the
        forward solve's stop decision together, so none leaves a loop the
        others stay in."""
        return _all_max(x, self.group, self.counts, "model_max")


@dataclasses.dataclass
class Split:
    """How one batch's solve is split over ranks, as the implicit adjoint
    sees it (``ops.ift``): ``group`` spans every rank holding a part of
    the batch, and ``model`` is this rank's model axis (None: whole rows
    of W)."""

    group: Any
    model: ModelAxis | None
    counts: collections.Counter

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over ``group``, in place: the adjoint's stop
        test over the whole batch, so every rank stops on the iteration the
        unsharded solve would."""
        return _all_max(x, self.group, self.counts, "adjoint_max")


def _all_max(x: torch.Tensor, group, counts, kind: str) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    counts[kind] += 1
    return x


class Mesh:
    """A (batch, model) grid over the ranks of the default process group,
    rank = b * n_model + m. ``counts`` tallies the collectives this rank
    issued, by kind. Built by :func:`make_mesh`."""

    def __init__(self, n_batch: int, n_model: int):
        world = dist.get_world_size()
        self.shape = {BATCH_AXIS: n_batch, MODEL_AXIS: n_model}
        self.rank = dist.get_rank()
        b, m = divmod(self.rank, n_model)
        self._index = {BATCH_AXIS: b, MODEL_AXIS: m}
        self.counts = collections.Counter()

        self._groups = {
            BATCH_AXIS: _subgroup([[j * n_model + i for j in range(n_batch)]
                                   for i in range(n_model)], m, world),
            MODEL_AXIS: _subgroup([[i * n_model + j for j in range(n_model)]
                                   for i in range(n_batch)], b, world),
        }
        self.model = (ModelAxis(m, n_model, self._groups[MODEL_AXIS],
                                self.counts) if n_model > 1 else None)

    @property
    def size(self) -> int:
        return self.shape[BATCH_AXIS] * self.shape[MODEL_AXIS]

    def index(self, axis: str) -> int:
        return self._index[axis]

    def _group(self, axes) -> Any:
        """The group spanning ``axes``; None when they span one rank."""
        live = [a for a in axes if self.shape[a] > 1]
        if not live:
            return None
        return self._groups[live[0]] if len(live) == 1 else dist.group.WORLD

    # -- batch axis ---------------------------------------------------------

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n`` over the batch axis."""
        return row_slice(n, self.shape[BATCH_AXIS], self.index(BATCH_AXIS))

    def gather_rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The batch group's row shards of ``x`` along ``dim``, in rank
        order, on every rank (differentiable: see :class:`_GatherRows`)."""
        group = self._group((BATCH_AXIS,))
        if group is None:
            return x
        self.counts["gather_rows"] += 1
        return _GatherRows.apply(x, dim, self.index(BATCH_AXIS),
                                 self.shape[BATCH_AXIS], group)

    def split(self, axes) -> Split | None:
        """The :class:`Split` of a batch whose circuits split over the
        batch axis and whose W's columns split over the model axis, as
        ``axes`` say; None when they span one rank."""
        group = self._group(axes)
        if group is None:
            return None
        return Split(group, self.model if MODEL_AXIS in axes else None,
                     self.counts)

    def reduce_grad(self, *xs: torch.Tensor, axes=(BATCH_AXIS, MODEL_AXIS)):
        """``xs`` unchanged, their gradients summed over the ranks of
        ``axes`` (those whose graphs hold disjoint parts of the work)."""
        group = self._group(axes)
        if group is None or not torch.is_grad_enabled():
            return xs
        return _ReduceGrad.apply(self.counts, group, *xs)

    # -- members ------------------------------------------------------------

    def member_shard(self, tree: Any) -> Any:
        """This rank's members (the leading axis of every tensor leaf)."""
        return tree_map(lambda t: t[self.rows(t.shape[0])], tree)

    def gather_members(self, tree: Any) -> Any:
        """Every rank's members, in rank order, on every rank: one
        all-reduce for the whole tree (leaves packed as float64, exact for
        the float32, int32 and bool leaves of a state)."""
        leaves = []
        tree_map(leaves.append, tree)
        group = self._group((BATCH_AXIS,))
        if group is None or not leaves:
            return tree
        p, me = self.shape[BATCH_AXIS], self.index(BATCH_AXIS)
        sizes = [t.numel() for t in leaves]
        buf = torch.zeros((p, sum(sizes)), dtype=torch.float64,
                          device=leaves[0].device)
        buf[me] = torch.cat([t.reshape(-1).to(torch.float64)
                             for t in leaves])
        dist.all_reduce(buf, group=group)
        self.counts["gather_members"] += 1
        full, pos = [], 0
        for t, n in zip(leaves, sizes):
            full.append(buf[:, pos:pos + n].reshape((p,) + t.shape)
                        .flatten(0, 1).to(t.dtype))
            pos += n
        parts = iter(full)
        return tree_map(lambda t: next(parts), tree)


def _subgroup(parts, mine: int, world: int):
    """Group ``mine`` of a partition of the ranks into ``parts``: the world
    group when one part spans every rank, None when each holds one (no
    collective runs over it). Every rank creates every group, in order, as
    ``new_group`` requires."""
    if len(parts[0]) == world:
        return dist.group.WORLD
    if len(parts[0]) == 1:
        return None
    return [dist.new_group(ranks) for ranks in parts][mine]


def tree_map(fn, tree: Any) -> Any:
    """``fn`` over the tensor and array leaves of nested NamedTuples, dicts,
    lists and tuples, in order; other leaves (host ints, None) pass
    through."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def make_mesh(n_batch: int | None = None, n_model: int = 1) -> Mesh:
    """A (batch, model) mesh over every rank of the initialized default
    process group (:mod:`tcgan_torch.parallel.launch` starts them)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group; "
                           "start the ranks with tcgan_torch.parallel.launch "
                           "or torchrun")
    n_batch, n_model = mesh_shape(dist.get_world_size(), n_batch, n_model)
    return Mesh(n_batch, n_model)


@contextlib.contextmanager
def set_mesh(mesh: Mesh | None) -> Iterator[Mesh | None]:
    """Make ``mesh`` the one a generator config's mesh axes refer to (None:
    no mesh)."""
    global _current
    prev, _current = _current, mesh
    try:
        yield mesh
    finally:
        _current = prev


def current_mesh() -> Mesh | None:
    return _current


def is_writer() -> bool:
    """Whether this process writes run artifacts: rank 0, or a process
    outside any process group."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def barrier():
    """Wait for every rank (a no-op outside a process group)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def check_replicated(tree: Any, what: str) -> None:
    """Raise unless every tensor of ``tree`` is equal on every rank (one
    all-reduce; a no-op outside a process group of several ranks). A mesh
    run keeps its state replicated by computing it alike on every rank; a
    rank whose arithmetic drifted would otherwise go on training another
    model unseen."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return
    leaves = []
    tree_map(leaves.append, tree)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in leaves]).nan_to_num(nan=float("inf"))
    both = torch.stack([flat, -flat])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    if not torch.equal(both[0], -both[1]):
        n = int((both[0] != -both[1]).sum())
        raise RuntimeError(f"{what}: {n} of {flat.numel()} values differ "
                           "between the ranks")


def make_sharded_gan_step(impl, mesh: Mesh):
    """Shard a WGAN/cWGAN ``train_step_impl`` over ``mesh``; the signature
    is ``impl``'s. State and real data are replicated; the generator's
    circuits shard as the cfg's mesh axes say (pass a cfg through
    :func:`with_mesh_axes`). Every rank passes the same noise or a
    generator seeded alike."""
    def step(cfg, n_critic, state, real_stack, **kw):
        with set_mesh(mesh):
            return impl(cfg, n_critic, state, real_stack, **kw)

    return step


def make_sharded_mm_step(impl, mesh: Mesh):
    """Shard a moment-matching ``train_step_impl`` over ``mesh`` (the data
    moments are replicated; the circuits shard through the cfg's mesh
    axes)."""
    def step(cfg, state, data_mean, data_second, **kw):
        with set_mesh(mesh):
            return impl(cfg, state, data_mean, data_second, **kw)

    return step


def make_sharded_ensemble_step(impl, mesh: Mesh):
    """Shard an ensemble step (``models.ensemble.ensemble_train_step``) over
    the batch axis of ``mesh`` by MEMBER: each rank steps its K/P members,
    with no collective across members.

    The returned ``step(cfg, n_critic, states, real_stacks, *, noise=None,
    generator=None, **kw)`` takes this rank's members' ``states``
    (:meth:`Mesh.member_shard` of the K-member state) and the real stacks
    (K, n_critic, ...) and noise of all K members, or draws that noise from
    ``generator`` as the unsharded step would (every rank seeded alike);
    it keeps its members' parts and returns their new states and metrics
    (:meth:`Mesh.gather_members` collects them)."""
    def step(cfg, n_critic, states, real_stacks, *, noise=None,
             generator=None, **kw):
        from tcgan_torch.models.wgan import draw_step_noise

        if noise is None:
            noise = draw_step_noise(cfg, n_critic, real_stacks.transpose(0, 1),
                                    generator)
        return impl(cfg, n_critic, states, mesh.member_shard(real_stacks),
                    noise=mesh.member_shard(noise), **kw)

    return step


def with_mesh_axes(gen_cfg, batch: bool = True, model: bool = False):
    """A copy of a GeneratorConfig with the mesh axes on: its circuits
    split over the active mesh's batch axis and, with ``model``, W's
    columns over its model axis."""
    return dataclasses.replace(
        gen_cfg,
        mesh_axis=BATCH_AXIS if batch else None,
        model_axis=MODEL_AXIS if model else None,
    )
