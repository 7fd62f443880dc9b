"""What a rank of ``tests/test_torch_model_axis.py`` runs beside
``launch.sharded_step``: torch and the port only. A spawned rank imports
this module by name, so it imports no jax and no test module."""

import torch

from tcgan_torch.ops import euler
from tcgan_torch.ops.cuda import ssn_solve
from tcgan_torch.parallel import launch
from tcgan_torch.parallel import mesh as mesh_lib


def drive_grads(cfg, W, I_ext, r0, weight, seqlen, chunk):
    """On a mesh with a model axis of 2: the rates of a ``seqlen``-step
    unroll (checkpointed every ``chunk`` steps) with W's columns split over
    the model axis, and the gradient of ``sum(weight * r)`` with respect
    to r0 and to this rank's columns of W. Returns (rates, grad r0, grad
    of the columns, the first column, collectives by kind)."""
    mesh = mesh_lib.make_mesh(n_model=2)
    cols = mesh.model.cols(W.shape[-1])
    W_cols = W[..., cols].clone().requires_grad_(True)
    r0 = r0.clone().requires_grad_(True)
    res = euler.solve_dynamics(cfg, W_cols, I_ext, r0=r0, seqlen=seqlen,
                               checkpoint_chunk=chunk, model=mesh.model)
    g_r0, g_w = torch.autograd.grad((weight * res.r).sum(), (r0, W_cols))
    return res.r.detach(), g_r0, g_w, cols.start, dict(mesh.counts)


def counted_step(*args, **kwargs):
    """``launch.sharded_step(*args, **kwargs)`` and the circuits of each
    call of the kernel's plain version (the CUDA backend on CPU tensors)
    in this rank."""
    circuits = []
    plain = ssn_solve.solve_fixed_point_plain

    def counted(cfg, W, *a, **kw):
        circuits.append(int(W.shape[0]))
        return plain(cfg, W, *a, **kw)

    ssn_solve.solve_fixed_point_plain = counted
    try:
        return (*launch.sharded_step(*args, **kwargs), circuits)
    finally:
        ssn_solve.solve_fixed_point_plain = plain
