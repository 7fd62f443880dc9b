"""SSN tuning-curve generator.

Port of :mod:`tcgan_tpu.models.generator`. The generator is the circuit
parameter set theta = (J, D, S) (2x2 blocks each) plus per-connection noise
z. A forward pass draws z ~ N(0, 1)^{B x 2N x 2N} (or takes an injected z),
builds Dale-constrained weight matrices, solves the SSN fixed point under the
bandwidth x contrast battery and reads out tuning curves at probe neurons.

Gradients flow to the parameters through the fixed point by the implicit
function theorem (:mod:`tcgan_torch.ops.ift`, ``solver="ift"``, configs
C2/C4/C5) or by backpropagation through a fixed-length Euler unroll
(:mod:`tcgan_torch.ops.euler`, ``solver="bptt"``, config C3).

Parameters may carry a leading member axis (an ensemble of K fits,
:mod:`tcgan_torch.models.ensemble`): J/D/S (K, 2, 2) give W (K, B, 2N, 2N),
solved in one kernel launch, and every output gains the K axis.

Mesh axes (``mesh_axis``, ``model_axis``; :mod:`tcgan_torch.parallel.mesh`)
split one batch over the ranks of the active mesh: every rank draws the
whole noise and keeps its rows of z (after the antithetic pairing), solves
them, and the outputs are gathered back, so the result is the unsharded
one on every rank. With ``model_axis`` the model group splits each batch
shard further, on every solver path. The lockstep solve and the BPTT
unroll split W's columns over it and sum the drive over the group, each
rank's W cotangent covering its own columns. The kernel solves whole
circuits, so on that backend the group splits the circuits instead: each
rank builds W whole for its share, solves it and runs its adjoint, and the
outputs are gathered back over the group. Either way the sum over the mesh
in ``Mesh.reduce_grad`` makes the whole gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from tcgan_torch.ops import euler, ift, stimulus, weights
from tcgan_torch.ops.ssn import (
    DEFAULT_BANDWIDTHS,
    DEFAULT_CONTRASTS,
    DEFAULT_D,
    DEFAULT_J,
    DEFAULT_S,
    SSNConfig,
)
from tcgan_torch.parallel import mesh as mesh_lib
from tcgan_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Static generator configuration (same fields as the reference)."""

    ssn: SSNConfig = SSNConfig()
    bandwidths: Tuple[float, ...] = DEFAULT_BANDWIDTHS
    contrasts: Tuple[float, ...] = DEFAULT_CONTRASTS
    sample_sites: int = 1
    track_offset_identity: bool = False
    include_inhibitory_neurons: bool = False
    solver: str = "ift"  # "ift" (fixed point + implicit grad) | "bptt"
    grad_method: str = "iterative"  # backward solve for the ift path
    bptt_checkpoint_chunk: int = 0  # 0 = no remat
    param_space: str = "log"  # "log" | "raw"
    dtype: Any = torch.float32
    # Mesh axes of the active mesh (parallel.set_mesh) the batch's circuits
    # and W's columns split over; None = unsharded.
    mesh_axis: str | None = None
    model_axis: str | None = None
    # Antithetic quenched noise: batch/2 z-draws used as (+z, -z) pairs.
    antithetic: bool = False

    @property
    def n_stim(self) -> int:
        return len(self.bandwidths) * len(self.contrasts)

    @property
    def n_probe(self) -> int:
        return self.sample_sites * (2 if self.include_inhibitory_neurons else 1)

    @property
    def tc_dim(self) -> int:
        """Length of one tuning-curve sample vector as seen by the critic."""
        if self.track_offset_identity:
            return self.n_stim * self.n_probe
        return self.n_stim

    def samples_per_circuit(self) -> int:
        """How many critic samples one sampled circuit yields."""
        return 1 if self.track_offset_identity else self.n_probe

    def probe_indices(self, device=None) -> torch.Tensor:
        """Neuron indices read out as tuning curves: ``sample_sites``
        consecutive E sites from the grid center, then the I cells at the
        same sites when ``include_inhibitory_neurons``."""
        N = self.ssn.N
        base = N // 2 + torch.arange(self.sample_sites, device=device)
        if self.include_inhibitory_neurons:
            return torch.cat([base, base + N])
        return base

    def stimulus_battery(self, device=None) -> torch.Tensor:
        x = self.ssn.site_pos(dtype=self.dtype, device=device)
        return stimulus.stimulus_battery(
            self.bandwidths, self.contrasts, x, self.ssn.smoothness)

    def condition_features(self, device=None) -> torch.Tensor:
        return stimulus.condition_features(
            self.bandwidths, self.contrasts, dtype=self.dtype, device=device)


def init_params(cfg: GeneratorConfig, J=DEFAULT_J, D=DEFAULT_D, S=DEFAULT_S,
                device=None) -> Dict[str, torch.Tensor]:
    """Initial generator parameters in the unconstrained optimization space."""
    vals = {name: torch.as_tensor(v, dtype=cfg.dtype, device=device)
            for name, v in (("J", J), ("D", D), ("S", S))}
    if cfg.param_space == "log":
        return {name: torch.log(v) for name, v in vals.items()}
    return vals


def params_from_numpy(np_params, device=None, dtype=torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """The port's parameters from a dict of arrays, such as the reference's
    ``init_params`` passed through ``np.asarray`` (copied: arrays that come
    out of JAX are read-only)."""
    return {name: torch.tensor(np.array(v, copy=True), dtype=dtype,
                               device=device)
            for name, v in np_params.items()}


def param_values(cfg: GeneratorConfig, params: Dict[str, torch.Tensor]):
    """Map unconstrained params to the positive circuit values (J, D, S)."""
    if cfg.param_space == "log":
        return tuple(torch.exp(params[k]) for k in ("J", "D", "S"))
    return params["J"], params["D"], params["S"]


def member_axes(params: Dict[str, torch.Tensor]) -> int:
    """Leading member axes of a parameter dict: 0 for one fit, 1 for an
    ensemble."""
    return params["J"].ndim - 2


def mean_per_member(x: torch.Tensor, members: int) -> torch.Tensor:
    """Mean over every axis but the ``members`` leading ones (with none, a
    scalar)."""
    return x.mean(dim=tuple(range(members, x.ndim)))


def param_values_np(cfg: GeneratorConfig, host_params):
    """Host-NumPy twin of :func:`param_values`."""
    vals = tuple(np.asarray(host_params[k]) for k in ("J", "D", "S"))
    if cfg.param_space == "log":
        return tuple(np.exp(v) for v in vals)
    return vals


class GeneratorOutput(NamedTuple):
    """Forward-pass output.

    tc:        critic-ready tuning-curve samples,
               (B, n_stim * n_probe) when track_offset_identity else
               (B * n_probe, n_stim).
    rates:     (B, S, 2N) full rates (for penalties/analysis).
    converged: (B, S) bool; diverged: (B, S) bool; iters: (B, S) int32.

    With member-stacked parameters every field has a leading K axis.
    """

    tc: torch.Tensor
    rates: torch.Tensor
    converged: torch.Tensor
    diverged: torch.Tensor
    iters: torch.Tensor


def sample_tuning_curves(cfg: GeneratorConfig, params: Dict[str, torch.Tensor],
                         batch: int, *, z=None,
                         generator: torch.Generator | None = None
                         ) -> GeneratorOutput:
    """Sample ``batch`` circuits and return their tuning curves.

    The noise is ``z`` when given (an array or tensor shaped as
    :func:`weights.sample_z` would draw it: (batch // 2, 2N, 2N) in
    antithetic mode, else (batch, 2N, 2N), after the member axis when the
    parameters have one), otherwise one draw from ``generator``. Everything
    runs on the device of ``params``; differentiable with respect to
    ``params`` through the chosen solver; with a member axis the implicit
    backward stops per member. With mesh axes (see the module docstring)
    every rank passes the same ``z`` or a generator seeded alike.
    """
    if cfg.solver not in ("ift", "bptt"):
        raise ValueError(f"unknown solver {cfg.solver!r}")
    with profiling.span("generator.sample"):
        return _sample(cfg, params, batch, z, generator)


def _sample(cfg, params, batch, z, generator) -> GeneratorOutput:
    """:func:`sample_tuning_curves` inside its span, a span a stage."""
    mesh = _active_mesh(cfg)
    J, D, S = param_values(cfg, params)
    lead = J.shape[:-2]  # member axes
    device = J.device
    n_draw = batch // 2 if cfg.antithetic else batch
    if cfg.antithetic and batch % 2:
        raise ValueError("antithetic sampling needs an even batch")
    if z is None:
        z = weights.sample_z(generator, lead + (n_draw,), cfg.ssn.N,
                             device=device, dtype=cfg.dtype)
    else:
        z = torch.as_tensor(z, dtype=cfg.dtype, device=device)
    if cfg.antithetic:
        z = torch.cat([z, -z], dim=-3)
    split = model = row_model = None
    if mesh is not None:
        if cfg.mesh_axis:
            z = z[..., mesh.rows(batch), :, :]
        axes = [a for a, on in ((mesh_lib.BATCH_AXIS, cfg.mesh_axis),
                                (mesh_lib.MODEL_AXIS, cfg.model_axis)) if on]
        J, D, S = mesh.reduce_grad(J, D, S, axes=axes)
        split = mesh.split(axes)
        model = None if split is None else split.model
        if model is not None and cfg.solver == "ift" \
                and cfg.ssn.backend == "cuda":
            # the kernel solves whole circuits: the model group splits the
            # circuits, each rank building W whole for its share of them
            z = z[..., model.rows(z.shape[-3]), :, :]
            split = dataclasses.replace(split, model=None)
            model, row_model = None, model
    with profiling.span("generator.weights"):
        if lead:  # one (2, 2) block per member, broadcast over its circuits
            J, D, S = (p.unsqueeze(-3) for p in (J, D, S))
        x = cfg.ssn.site_pos(dtype=cfg.dtype, device=device)
        W = weights.build_weight(J, D, S, z, x)
        if model is not None:  # this rank's presynaptic columns
            W = W[..., model.cols(W.shape[-1])]
    with profiling.span("generator.battery"):
        I_ext = cfg.stimulus_battery(device)
    with profiling.span("generator.solve"):
        if cfg.solver == "ift":
            res = ift.solve_fixed_point_implicit(cfg.ssn, W, I_ext,
                                                 grad_method=cfg.grad_method,
                                                 group_axes=len(lead),
                                                 split=split)
        else:
            res = euler.solve_dynamics(
                cfg.ssn, W, I_ext,
                checkpoint_chunk=cfg.bptt_checkpoint_chunk or None,
                model=model)
    with profiling.span("generator.readout"):
        if row_model is not None:
            res = _gather_rows(row_model, res)
        if mesh is not None and cfg.mesh_axis:
            res = _gather_rows(mesh, res)
        tc = res.r[..., cfg.probe_indices(device)]  # (..., B, S, P)
        if cfg.track_offset_identity:
            tc = tc.reshape(lead + (batch, -1))  # (..., B, S*P)
        else:
            tc = tc.transpose(-1, -2).reshape(
                lead + (batch * cfg.n_probe, cfg.n_stim))
    return GeneratorOutput(tc, res.r, res.converged, res.diverged, res.iters)


def _active_mesh(cfg: GeneratorConfig):
    """The mesh a config's axes split over (None without axes)."""
    if not (cfg.mesh_axis or cfg.model_axis):
        return None
    mesh = mesh_lib.current_mesh()
    if mesh is None:
        raise ValueError("a generator config with mesh axes runs inside "
                         "tcgan_torch.parallel.set_mesh(mesh)")
    return mesh


def _gather_rows(axis, res):
    """The solver outputs of ``axis``'s group (the mesh's batch group or
    its model axis), gathered along the circuit axis in one collective:
    flags and iters ride in the rates' buffer (float32 at least, exact for
    them)."""
    r = res.r
    dtype = torch.promote_types(r.dtype, torch.float32)
    flags = torch.stack([t.to(dtype) for t in
                         (res.converged, res.diverged, res.iters)], dim=-1)
    full = axis.gather_rows(torch.cat([r.to(dtype), flags], dim=-1), dim=-3)
    n2 = r.shape[-1]
    return type(res)(full[..., :n2].to(r.dtype), full[..., n2] > 0,
                     full[..., n2 + 1] > 0, full[..., n2 + 2].to(torch.int32))


def rate_penalty(cfg: GeneratorConfig, rates: torch.Tensor,
                 members: int = 0) -> torch.Tensor:
    """Quadratic penalty on rates above ``rate_soft_bound``, zero below;
    one value per member when ``rates`` has ``members`` leading axes."""
    excess = torch.clamp(rates - cfg.ssn.rate_soft_bound, min=0.0)
    return (mean_per_member(excess**2, members)
            / cfg.ssn.rate_soft_bound**2)
