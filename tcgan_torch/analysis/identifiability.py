"""Parameter-identifiability analysis via the moment Jacobian.

Port of :mod:`tcgan_tpu.analysis.identifiability`. The NumPy parts (the
closed-form Dale-ensemble statistics, the SVD report, the Cramer-Rao
precision, the subspace decompositions) are the reference's own, copied;
the moment map and its Jacobian run in PyTorch on ``--device`` (default
``cuda``), the forward solve through the CUDA kernel under
``--solver-backend cuda``.

- :func:`moment_jacobian`: d(TC moments)/d(log theta) through the full
  generator forward (weight build + fixed-point solve + probe readout). One
  forward solve serves every row; the rows' backward passes run ``chunk``
  cotangents at a time, each chunk ONE adjoint solve with a stop rule per
  cotangent (:func:`tcgan_torch.ops.ift.vjp_W_batched`), as the
  reference's ``vmap`` over ``vjp`` does.
- :func:`identifiability_report`: SVD of the Jacobian (singular values,
  the flattest direction, per-parameter sensitivities; log-space params,
  so directions read as relative changes).
- :func:`battery_score` and the CLI: compare stimulus batteries by
  E-optimality (smallest singular value) before fitting.
- :func:`mean_rectified_strength` / :func:`dale_ridge_direction`: the
  closed-form Dale-ensemble statistics behind the J/D ridge.

Random draws come from ``torch.Generator`` seeds (not JAX keys); every
function that draws takes injected noise ``z`` too.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

PARAM_NAMES = tuple(
    f"{blk}_{post}{pre}"
    for blk in ("J", "D", "S")
    for post in ("E", "I")
    for pre in ("E", "I")
)


# ---------------------------------------------------------------------------
# Closed-form Dale-ensemble statistics (the analytic ridge)
# ---------------------------------------------------------------------------

def _phi(x):
    return np.exp(-0.5 * x**2) / np.sqrt(2.0 * np.pi)


def _Phi(x):
    from math import erf

    x = np.asarray(x, dtype=np.float64)
    return 0.5 * (1.0 + np.vectorize(erf)(x / np.sqrt(2.0)))


def mean_rectified_strength(J, D):
    """E[relu(J + D z)], z ~ N(0,1) — the mean synaptic strength of the
    Dale-rectified ensemble, elementwise over the 2x2 blocks."""
    J = np.asarray(J, dtype=np.float64)
    D = np.asarray(D, dtype=np.float64)
    a = J / D
    return J * _Phi(a) + D * _phi(a)


def var_rectified_strength(J, D):
    """Var[relu(J + D z)] elementwise over the 2x2 blocks."""
    J = np.asarray(J, dtype=np.float64)
    D = np.asarray(D, dtype=np.float64)
    a = J / D
    second = (J**2 + D**2) * _Phi(a) + J * D * _phi(a)
    m = mean_rectified_strength(J, D)
    return second - m**2


def dale_ridge_direction(J, D):
    """Unit direction in (dlogJ, dlogD) that preserves the mean rectified
    strength (elementwise): the analytic null direction of circuit-averaged
    observables. Uses d/dJ E[relu(J+Dz)] = Phi(J/D), d/dD = phi(J/D)."""
    J = np.asarray(J, dtype=np.float64)
    D = np.asarray(D, dtype=np.float64)
    a = J / D
    # gradient w.r.t. (logJ, logD) = (J*Phi(a), D*phi(a)); null direction
    # rotates it by 90 degrees.
    gJ, gD = J * _Phi(a), D * _phi(a)
    d = np.stack([gD, -gJ], axis=0)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


# ---------------------------------------------------------------------------
# Numeric moment Jacobian through the generator forward
# ---------------------------------------------------------------------------

def _draw_z(gen_cfg, n: int, seed: int, device) -> torch.Tensor:
    from tcgan_torch.ops import weights

    return weights.sample_z(torch.Generator(device).manual_seed(seed), (n,),
                            gen_cfg.ssn.N, device=device, dtype=gen_cfg.dtype)


def _weights(gen_cfg, theta_log: torch.Tensor, z: torch.Tensor):
    """W (B, 2N, 2N) for log-params (12,) under quenched noise z."""
    from tcgan_torch.ops import weights

    J, D, S = (torch.exp(theta_log[i:i + 4].reshape(2, 2))
               for i in (0, 4, 8))
    x = gen_cfg.ssn.site_pos(dtype=gen_cfg.dtype, device=theta_log.device)
    return weights.build_weight(J, D, S, z, x)


def _moments_of_rates(gen_cfg, r: torch.Tensor, converged: torch.Tensor):
    """TC moment vector (means then stds per feature) of rates (B, S, 2N),
    each feature (stimulus, probe) masked by its own convergence flag."""
    tc = r[..., gen_cfg.probe_indices(r.device)]  # (B, S, P)
    B = r.shape[0]
    # Per-feature convergence mask: a circuit whose contrast-20 stimulus
    # diverges still contributes its converged conditions. The flags are
    # bookkeeping, not differentiated.
    w = converged.detach().to(tc.dtype)[..., None].expand(tc.shape)
    if gen_cfg.track_offset_identity:
        tc, w = tc.reshape(B, -1), w.reshape(B, -1)
    else:
        tc = tc.transpose(-1, -2).reshape(B * gen_cfg.n_probe, gen_cfg.n_stim)
        w = w.transpose(-1, -2).reshape(B * gen_cfg.n_probe, gen_cfg.n_stim)
    n = torch.clamp(w.sum(dim=0), min=1.0)
    mean = (tc * w).sum(dim=0) / n
    var = ((tc - mean) ** 2 * w).sum(dim=0) / n
    return torch.cat([mean, torch.sqrt(var + 1e-12)])


def moment_fn(gen_cfg, theta_log: torch.Tensor, z) -> torch.Tensor:
    """TC moment vector (means then stds per feature) for log-params
    ``theta_log`` (12,) under FIXED quenched noise ``z`` (common random
    numbers keep the Jacobian deterministic); differentiable through the
    config's solver."""
    from tcgan_torch.ops import euler, ift

    z = torch.as_tensor(z, dtype=gen_cfg.dtype, device=theta_log.device)
    W = _weights(gen_cfg, theta_log, z)
    I_ext = gen_cfg.stimulus_battery(theta_log.device)
    if gen_cfg.solver == "bptt":
        res = euler.solve_dynamics(
            gen_cfg.ssn, W, I_ext,
            checkpoint_chunk=gen_cfg.bptt_checkpoint_chunk or None)
    else:
        res = ift.solve_fixed_point_implicit(
            gen_cfg.ssn, W, I_ext, grad_method=gen_cfg.grad_method)
    return _moments_of_rates(gen_cfg, res.r.to(W.dtype), res.converged)


def _log_theta(gen_cfg, J, D, S, device) -> torch.Tensor:
    return torch.cat([
        torch.log(torch.as_tensor(np.asarray(p, dtype=np.float64),
                                  dtype=gen_cfg.dtype, device=device)
                  .reshape(-1)) for p in (J, D, S)])


def moment_jacobian(gen_cfg, J, D, S, n_circuits: int = 256, seed: int = 0,
                    chunk: int | None = 64, device=None, z=None):
    """Jacobian of the TC moment vector w.r.t. log(J, D, S) (M x 12).

    Reverse mode, ``chunk`` output cotangents at a time (None: all at
    once). On the fixed-point solver ONE forward solve serves every row and
    each chunk is one adjoint solve; on the BPTT solver each row is its own
    backward through the unroll. ``z``: the circuits' quenched noise
    (default: ``n_circuits`` draws from ``seed``). Returns (jacobian,
    moments) as float64 host arrays."""
    from tcgan_torch.ops import fixed_point, ift

    device = torch.device(device or "cpu")
    theta = _log_theta(gen_cfg, J, D, S, device).requires_grad_(True)
    z = (_draw_z(gen_cfg, n_circuits, seed, device) if z is None
         else torch.as_tensor(z, dtype=gen_cfg.dtype, device=device))
    if gen_cfg.solver == "bptt":
        moments = moment_fn(gen_cfg, theta, z)
        eye = torch.eye(moments.shape[0], dtype=moments.dtype, device=device)
        jac = torch.stack([torch.autograd.grad(moments, theta, e,
                                               retain_graph=True)[0]
                           for e in eye])
    else:
        W = _weights(gen_cfg, theta, z)
        I_ext = gen_cfg.stimulus_battery(device)
        with torch.no_grad():
            res = fixed_point.solve_any(gen_cfg.ssn, W.detach(), I_ext)
        r = res.r.to(W.dtype).detach().requires_grad_(True)
        moments = _moments_of_rates(gen_cfg, r, res.converged)
        M = moments.shape[0]
        eye = torch.eye(M, dtype=moments.dtype, device=device)
        rows = []
        for lo in range(0, M, chunk or M):
            block = eye[lo:lo + (chunk or M)]
            g_r, = torch.autograd.grad(moments, r, block, retain_graph=True,
                                       is_grads_batched=True)
            W_bar = ift.vjp_W_batched(gen_cfg.ssn, W.detach(), I_ext, res,
                                      g_r, grad_method=gen_cfg.grad_method)
            rows.append(torch.autograd.grad(W, theta, W_bar,
                                            retain_graph=True,
                                            is_grads_batched=True)[0])
        jac = torch.cat(rows)
    return (jac.detach().cpu().numpy().astype(np.float64),
            moments.detach().cpu().numpy().astype(np.float64))


def sample_at(gen_cfg, J, D, S, n_circuits: int, seed: int, device=None,
              z=None):
    """One generator forward (no graph) at value-space (J, D, S)."""
    from tcgan_torch.models import generator as gen_lib

    device = torch.device(device or "cpu")
    params = gen_lib.init_params(gen_cfg, J, D, S, device=device)
    with torch.inference_mode():
        return gen_lib.sample_tuning_curves(
            gen_cfg, params, n_circuits, z=z,
            generator=torch.Generator(device).manual_seed(seed))


def convergence_fraction(gen_cfg, J, D, S, n_circuits: int = 64,
                         seed: int = 0, device=None,
                         z=None) -> Tuple[float, float]:
    """(per-solve convergence, per-circuit all-condition yield).

    The second number is the dataset-generation yield: a circuit enters a
    fake-truth dataset only if EVERY battery condition converges, so a
    battery whose per-solve rate looks fine (0.93) can still have a
    prohibitive circuit yield (0.93^24 ~ 0.18)."""
    conv = sample_at(gen_cfg, J, D, S, n_circuits, seed, device,
                     z).converged.cpu().numpy()
    return float(conv.mean()), float(conv.all(axis=-1).mean())


def survivor_tc(gen_cfg, out) -> np.ndarray:
    """Host tuning curves of the circuits whose every condition converged
    (the fake-truth dataset's selection)."""
    ok = out.converged.all(dim=-1).cpu().numpy()
    tc = out.tc.cpu()
    tc = (tc.float() if tc.dtype == torch.bfloat16 else tc).numpy()
    if gen_cfg.track_offset_identity:
        return tc[ok]
    return tc[np.repeat(ok, gen_cfg.samples_per_circuit())]


def identifiability_report(jac: np.ndarray,
                           param_names: Sequence[str] = PARAM_NAMES) -> Dict:
    """SVD-based report: singular spectrum, ridge direction, sensitivities.

    ``jac`` rows are moments, columns are log-params; singular values have
    units of [rate change per 100% relative param change].
    """
    jac = np.asarray(jac, dtype=np.float64)
    # full_matrices: a battery with fewer moment rows than params has an
    # EXACT null space that reduced SVD cannot see — sigma_min would be
    # the smallest of M positive row-space values and the report would
    # rank a degenerate battery as fully identifying all parameters.
    # Zero-pad s to the param count so sigma_min/condition_number/ridge
    # reflect the true spectrum (same convention as subspace_errors).
    u, s, vt = np.linalg.svd(jac, full_matrices=True)
    n_par = jac.shape[1]
    if s.shape[0] < n_par:
        s = np.concatenate([s, np.zeros(n_par - s.shape[0])])
    ridge = vt[-1]
    # sign convention: largest-|.| component positive
    ridge = ridge * np.sign(ridge[np.argmax(np.abs(ridge))])
    sens = np.linalg.norm(jac, axis=0)
    return {
        "singular_values": s.tolist(),
        "condition_number": float(s[0] / max(s[-1], 1e-300)),
        "sigma_min": float(s[-1]),
        "ridge_direction": {n: float(v)
                            for n, v in zip(param_names, ridge)},
        "param_sensitivity": {n: float(v)
                              for n, v in zip(param_names, sens)},
    }


def battery_score(gen_cfg, J, D, S, n_circuits: int = 256, seed: int = 0,
                  jac: np.ndarray | None = None,
                  moments: np.ndarray | None = None, device=None,
                  z=None) -> Dict:
    """E-/D-optimality scores for a stimulus battery + readout config.

    Pass precomputed (jac, moments) to reuse a Jacobian the caller also
    needs (the CLI does: one scoring implementation, shared). ``z``: the
    convergence draw's noise (default: drawn from ``seed``)."""
    if jac is None or moments is None:
        jac, moments = moment_jacobian(gen_cfg, J, D, S, n_circuits, seed,
                                       device=device)
    rep = identifiability_report(jac)
    s = np.maximum(np.asarray(rep["singular_values"]), 1e-300)
    rep["d_opt_log10"] = float(np.sum(np.log10(s)))  # log10 det(J^T J)^0.5
    rep["n_moments"] = int(jac.shape[0])
    rep["moment_scale"] = float(np.abs(moments).mean())
    rep["frac_converged"], rep["circuit_yield"] = convergence_fraction(
        gen_cfg, J, D, S, n_circuits=n_circuits, seed=seed, device=device,
        z=z)
    return rep


def bootstrap_moment_cov(tc: np.ndarray, n_boot: int = 256,
                         seed: int = 0) -> np.ndarray:
    """Per-sample-unit covariance of the moment vector [means, stds].

    Bootstraps the moment vector over the ``tc`` sample set (n, d) and
    rescales by n so the result C satisfies cov(m_hat at N samples) ~ C/N.
    """
    tc = np.asarray(tc, dtype=np.float64)
    n = tc.shape[0]
    rng = np.random.default_rng(seed)
    reps = np.empty((n_boot, 2 * tc.shape[1]))
    for b in range(n_boot):
        sub = tc[rng.integers(0, n, n)]
        reps[b] = np.concatenate([sub.mean(axis=0), sub.std(axis=0)])
    return n * np.cov(reps.T)


def expected_precision(jac: np.ndarray, moment_cov: np.ndarray,
                       n_data: int,
                       param_names: Sequence[str] = PARAM_NAMES,
                       rcond: float = 1e-10) -> Dict:
    """Cramer-Rao-style expected recovery precision at ``n_data`` samples.

    Fisher information F = n_data * J^T C^+ J (C the per-sample moment
    covariance); flat directions make F singular, so the parameter
    covariance uses the pseudo-inverse and the report separates
    constrained directions (eigenvalue above cutoff -> finite std) from
    unconstrained ones (std = inf). Log-space params, so stds read as
    relative (fractional) errors.
    """
    jac = np.asarray(jac, dtype=np.float64)
    C = np.asarray(moment_cov, dtype=np.float64)
    F = n_data * jac.T @ np.linalg.pinv(C, rcond=rcond) @ jac
    w, V = np.linalg.eigh(F)
    cutoff = max(w.max(), 0.0) * rcond
    constrained = w > cutoff
    inv_w = np.where(constrained, 1.0 / np.maximum(w, 1e-300), 0.0)
    cov_params = (V * inv_w) @ V.T
    per_param = np.sqrt(np.diag(cov_params))
    per_param = np.where(
        (np.abs(V[:, ~constrained]) > 1e-3).any(axis=1)
        if (~constrained).any() else np.zeros(len(per_param), bool),
        np.inf, per_param)
    dir_stds = np.where(constrained, 1.0 / np.sqrt(np.maximum(w, 1e-300)),
                        np.inf)
    order = np.argsort(dir_stds)
    return {
        "n_data": int(n_data),
        "n_constrained_directions": int(constrained.sum()),
        "per_param_std": {nm: float(v)
                          for nm, v in zip(param_names, per_param)},
        "directions": [
            {"std": float(dir_stds[i]),
             "direction": {nm: float(v)
                           for nm, v in zip(param_names, V[:, i])}}
            for i in order
        ],
    }


def subspace_trajectory(jac: np.ndarray, trajectories: Dict[str, np.ndarray],
                        true: Dict[str, np.ndarray]) -> Dict:
    """Project a whole parameter trajectory onto the Jacobian's singular
    directions: components[t, j] = <v_j, log theta_t - log theta_true>.

    ``trajectories``: {"J","D","S"} each (T, 2, 2) (RunRecord
    gen_param_trajectory output). Visualizes which directions a fit
    actually converges along, and at what rate — the dynamic version of
    :func:`subspace_errors`.
    """
    jac = np.asarray(jac, dtype=np.float64)
    _, s, vt = np.linalg.svd(jac, full_matrices=True)
    s_full = np.zeros(vt.shape[0])
    s_full[: len(s)] = s
    dtheta = np.concatenate([
        np.log(np.asarray(trajectories[k], dtype=np.float64).reshape(
            -1, 4))
        - np.log(np.asarray(true[k], dtype=np.float64).reshape(1, 4))
        for k in ("J", "D", "S")
    ], axis=1)  # (T, 12)
    comps = dtheta @ vt.T  # (T, 12)
    return {"singular_values": s_full, "components": comps}


def subspace_errors(jac: np.ndarray, fitted: Dict[str, np.ndarray],
                    true: Dict[str, np.ndarray],
                    sv_rel_threshold: float = 1e-3) -> Dict:
    """Decompose a fit's parameter error into the moment-Jacobian's singular
    basis: the honest recovery metric when some directions are provably
    unidentifiable (BASELINE.md "The J/D ridge").

    The raw per-block error mixes identifiable misfit with drift along flat
    directions the data cannot constrain. This splits
    ``dtheta = log(fitted) - log(true)`` into components along each right
    singular vector and reports:

    - ``identifiable_error``: RMS relative error restricted to directions
      with singular value >= ``sv_rel_threshold * sv_max`` — what the fit
      can be held accountable for;
    - ``unidentifiable_error``: the remainder (flat directions);
    - per-direction components with their singular values.
    """
    jac = np.asarray(jac, dtype=np.float64)
    _, s, vt = np.linalg.svd(jac, full_matrices=True)
    s_full = np.zeros(vt.shape[0])
    s_full[: len(s)] = s
    dtheta = np.concatenate([
        np.log(np.asarray(fitted[k], dtype=np.float64).reshape(-1))
        - np.log(np.asarray(true[k], dtype=np.float64).reshape(-1))
        for k in ("J", "D", "S")
    ])
    comps = vt @ dtheta
    ident_mask = s_full >= sv_rel_threshold * max(s_full.max(), 1e-300)
    n_ident = max(int(ident_mask.sum()), 1)
    n_flat = max(int((~ident_mask).sum()), 1)
    return {
        "identifiable_error": float(
            np.sqrt((comps[ident_mask] ** 2).sum() / n_ident)),
        "unidentifiable_error": float(
            np.sqrt((comps[~ident_mask] ** 2).sum() / n_flat)),
        "n_identifiable": int(ident_mask.sum()),
        "raw_error": float(np.sqrt((dtheta**2).mean())),
        "components": [
            {"singular_value": float(sv), "component": float(c),
             "direction": {n: float(v)
                           for n, v in zip(PARAM_NAMES, vt[i])}}
            for i, (sv, c) in enumerate(zip(s_full, comps))
        ],
    }

# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def make_parser():
    import argparse

    from tcgan_torch.run import common

    p = argparse.ArgumentParser(
        description="Identifiability analysis: moment-Jacobian SVD per "
        "candidate stimulus battery (evaluated at --J/--D/--S)")
    common.add_ssn_flags(p)
    common.add_stimulus_flags(p)
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32")
    p.add_argument("--n-circuits", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--contrast-sets", type=str, default=None,
        help="semicolon-separated candidate contrast lists, e.g. "
        "'10;5,10;2.5,5,10,20,40' — scores each against the base "
        "bandwidths/readout; default scores only the configured battery")
    p.add_argument("--fitted-J", type=float, nargs=4, default=None,
                   help="with --fitted-D/--fitted-S: decompose this fit's "
                   "error into identifiable vs flat directions (evaluated "
                   "against --J/--D/--S as truth, on the FIRST battery)")
    p.add_argument("--fitted-D", type=float, nargs=4, default=None)
    p.add_argument("--fitted-S", type=float, nargs=4, default=None)
    p.add_argument("--output", type=str, default=None,
                   help="write the JSON report here as well as stdout")
    p.add_argument("--save-jacobian", type=str, default=None,
                   help="save the FIRST battery's Jacobian/moments as .npz")
    p.add_argument("--data-samples", type=int, default=0,
                   help="add a Cramer-Rao expected-precision report for a "
                        "dataset of this many tuning curves (FIRST battery)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' with no visible GPU is an "
                        "error, never a CPU fallback")
    return p


def main(argv=None) -> int:
    from tcgan_torch.run import common

    args = make_parser().parse_args(argv)
    device = common.resolve_device(args)
    gen_cfg = common.generator_config_from_args(args, solver="ift")
    J, D, S = common.as22(args.J), common.as22(args.D), common.as22(args.S)

    sets: list[Tuple[float, ...]]
    if args.contrast_sets:
        sets = [tuple(float(c) for c in s.split(","))
                for s in args.contrast_sets.split(";")]
    else:
        sets = [tuple(gen_cfg.contrasts)]

    out = {"params": {"J": np.asarray(J).tolist(),
                      "D": np.asarray(D).tolist(),
                      "S": np.asarray(S).tolist()},
           "bandwidths": list(gen_cfg.bandwidths),
           "analytic_dale_ridge": {
               "mean_strength": mean_rectified_strength(J, D).tolist(),
               "ridge_dlogJ_dlogD": dale_ridge_direction(J, D).tolist(),
           },
           "batteries": []}
    for i, contrasts in enumerate(sets):
        cfg_c = dataclasses.replace(gen_cfg, contrasts=contrasts)
        jac, moments = moment_jacobian(cfg_c, J, D, S,
                                       n_circuits=args.n_circuits,
                                       seed=args.seed, device=device)
        rep = battery_score(cfg_c, J, D, S, seed=args.seed, jac=jac,
                            moments=moments, device=device)
        rep["contrasts"] = list(contrasts)
        if i == 0 and args.save_jacobian:
            np.savez(args.save_jacobian, jacobian=jac, moments=moments,
                     param_names=np.array(PARAM_NAMES),
                     contrasts=np.array(contrasts))
        if i == 0 and args.data_samples > 0:
            tc = survivor_tc(cfg_c, sample_at(
                cfg_c, J, D, S, max(args.n_circuits, 128), args.seed + 1,
                device))
            C = bootstrap_moment_cov(tc, seed=args.seed)
            rep["expected_precision"] = expected_precision(
                jac, C, args.data_samples)
        if i == 0 and args.fitted_J and args.fitted_D and args.fitted_S:
            rep["fit_decomposition"] = subspace_errors(
                jac,
                {"J": common.as22(args.fitted_J),
                 "D": common.as22(args.fitted_D),
                 "S": common.as22(args.fitted_S)},
                {"J": J, "D": D, "S": S})
        out["batteries"].append(rep)
        print(f"contrasts={contrasts}: sigma_min={rep['sigma_min']:.3e} "
              f"cond={rep['condition_number']:.1f} "
              f"d_opt_log10={rep['d_opt_log10']:.2f} "
              f"frac_converged={rep['frac_converged']:.3f} "
              f"circuit_yield={rep['circuit_yield']:.3f}", flush=True)

    text = json.dumps(out, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
