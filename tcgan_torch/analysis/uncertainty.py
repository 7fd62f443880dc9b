"""Per-run parameter uncertainty: Fisher/Laplace error bars at the fit.

Port of :mod:`tcgan_tpu.analysis.uncertainty`. Attaches expected-precision
error bars to a COMPLETED run (of either package), evaluated at the run's
own endpoint rather than at an assumed truth:

    F = n_data * J^T C^+ J          (Fisher information of the moment map)

with J the moment Jacobian w.r.t. log(J, D, S)
(:func:`tcgan_torch.analysis.identifiability.moment_jacobian`, on
``--device``, the forward solve through the CUDA kernel under
``--solver-backend cuda``) and C the per-sample moment covariance, both at
the fitted params. Flat (unidentifiable) directions get std = inf.

When the truth is recorded (fake-truth runs), each parameter's recovery
error is also expressed as a z-score against its own CI: |z| <~ 3 on every
constrained direction means the fit is information-limited; |z| >> 3 on a
constrained direction means an optimization failure.

Usage:
    python -m tcgan_torch.analysis.uncertainty --run runs/mm13fix \
        --device cuda --solver-backend cuda \
        [--params-source npz_ema] [--data-samples 4096] [-o out.json]

The scientific config (battery/readout/SSN) is read from the run's
info.json, exactly as run.eval does.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from tcgan_torch.analysis.identifiability import (
    PARAM_NAMES,
    bootstrap_moment_cov,
    expected_precision,
    moment_jacobian,
    sample_at,
    subspace_errors,
    survivor_tc,
)


def calibration(fitted: dict, true: dict, precision: dict) -> dict:
    """Recovery z-scores against the fit's own error bars.

    The principled check lives in Fisher EIGENDIRECTION space:
    z_j = <v_j, log fitted - log true> / std_j over the constrained
    directions from :func:`expected_precision` (log-space, so both sides
    are relative errors). Per-parameter marginals are reported too, but on
    moment-deficient batteries a parameter's marginal std is inf whenever
    it has ANY flat-direction component — often every parameter — so the
    marginal z defaults to 0 there (the data never constrained it) and the
    verdict comes from the direction-space maximum."""
    dtheta = np.concatenate([
        np.log(np.asarray(fitted[k], dtype=np.float64).reshape(-1))
        - np.log(np.asarray(true[k], dtype=np.float64).reshape(-1))
        for k in ("J", "D", "S")
    ])
    direction_z = []
    for d in precision["directions"]:
        std = float(d["std"])
        if not np.isfinite(std) or std <= 0:
            continue
        v = np.asarray([d["direction"][n] for n in PARAM_NAMES])
        direction_z.append({"std": std,
                            "z": float(v @ dtheta / std),
                            "direction": d["direction"]})
    max_z = (max(abs(e["z"]) for e in direction_z)
             if direction_z else 0.0)
    stds = np.asarray([precision["per_param_std"][n] for n in PARAM_NAMES])
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(np.isfinite(stds) & (stds > 0), dtheta / stds, 0.0)
    return {
        "z_scores": {n: float(v) for n, v in zip(PARAM_NAMES, z)},
        "direction_z": direction_z,
        "max_abs_z_constrained": float(max_z),
        "within_error_bars": bool(max_z <= 3.0),
        "verdict": ("information-limited (fit is within its own error "
                    "bars)" if max_z <= 3.0 else
                    "optimization-limited (recovery error exceeds what "
                    "the data allows — ridge stall / schedule failure)"),
    }


def run_uncertainty(gen_cfg, fitted: dict, n_data: int,
                    true: dict | None = None, n_circuits: int = 256,
                    seed: int = 0, n_boot: int = 256, device=None,
                    z_jac=None, z_cov=None) -> dict:
    """Fisher error bars + optional truth calibration at ``fitted``.

    ``fitted``/``true``: {"J","D","S"} 2x2 value-space. ``n_data`` is the
    dataset size the Fisher information scales with (the training run's
    truth-samples / dataset rows). ``z_jac`` / ``z_cov``: the quenched
    noise of the Jacobian's circuits and of the covariance's sample
    (default: drawn from ``seed`` and ``seed + 1``)."""
    Jf, Df, Sf = (tuple(map(tuple, np.asarray(fitted[k], dtype=np.float64)))
                  for k in ("J", "D", "S"))
    jac, moments = moment_jacobian(gen_cfg, Jf, Df, Sf,
                                   n_circuits=n_circuits, seed=seed,
                                   device=device, z=z_jac)
    # Moment covariance from samples at the FIT, survivor-selected the same
    # way fake-truth datasets are (keep circuits whose every condition
    # converged): the covariance the estimator actually faced.
    out = sample_at(gen_cfg, Jf, Df, Sf, max(n_circuits, 128), seed + 1,
                    device, z=z_cov)
    tc = survivor_tc(gen_cfg, out)
    n_ok = int(out.converged.all(dim=-1).sum())
    rep: dict = {
        "fitted_params": {k: np.asarray(v).tolist()
                          for k, v in fitted.items()},
        "n_circuits": int(n_circuits),
        "n_surviving_circuits": n_ok,
        "frac_converged": float(out.converged.float().mean()),
    }
    if n_ok < 8:
        # Near-total divergence at the endpoint: C is garbage from <8
        # circuits. Report the diagnosis instead of meaningless intervals.
        rep["error"] = ("fitted params sit in the divergent region "
                        f"({n_ok} surviving circuits) — moment "
                        "covariance undefined; no error bars")
        return rep
    C = bootstrap_moment_cov(tc, n_boot=n_boot, seed=seed)
    rep["expected_precision"] = expected_precision(jac, C, n_data)
    if true is not None:
        rep["true_params"] = {k: np.asarray(v).tolist()
                              for k, v in true.items()}
        rep["calibration"] = calibration(fitted, true,
                                         rep["expected_precision"])
        rep["fit_decomposition"] = subspace_errors(jac, fitted, true)
    return rep


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def make_parser():
    import argparse

    from tcgan_torch.run import common

    p = argparse.ArgumentParser(
        description="Error bars on a completed run's fitted circuit "
        "params (Fisher/Laplace at the endpoint) + truth calibration")
    common.add_ssn_flags(p)
    common.add_stimulus_flags(p)
    common.add_data_flags(p)
    p.add_argument("--run", type=str, required=True,
                   help="datastore of the fitted run")
    p.add_argument("--params-source", choices=("csv", "npz", "npz_ema"),
                   default="csv", help="endpoint params (as in run.eval)")
    p.add_argument("--n-circuits", type=int, default=256)
    p.add_argument("--n-boot", type=int, default=256)
    p.add_argument("--data-samples", type=int, default=0,
                   help="dataset size for the Fisher scaling; default = "
                        "the run's recorded truth-samples (or the dataset "
                        "row count when the run trained on --dataset)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' with no visible GPU is an "
                        "error, never a CPU fallback")
    p.add_argument("--output", "-o", type=str, default=None,
                   help="write the JSON report here as well as stdout")
    return p


def main(argv=None) -> int:
    from tcgan_torch.analysis.loaders import fitted_params
    from tcgan_torch.run import common

    parser = make_parser()
    args = parser.parse_args(argv)
    # The analysis is only meaningful on the run's own battery/readout:
    # always reconstruct from info.json (explicit flags still override,
    # loudly, as in run.eval).
    overrides = common.apply_run_config(args, parser, argv, args.run)
    device = common.resolve_device(args)
    gen_cfg = common.generator_config_from_args(args, solver="ift")
    fitted = fitted_params(args.run, args.params_source)

    n_data = args.data_samples
    if n_data <= 0 and args.dataset:
        dataset = common.load_or_generate_dataset(args, gen_cfg)
        n_data = int(dataset.num_samples)
    if n_data <= 0:
        n_data = int(args.truth_samples)

    true = None
    if not args.dataset:
        tj, td, ts = common.resolve_true_params(args)
        true = {"J": np.asarray(tj), "D": np.asarray(td),
                "S": np.asarray(ts)}

    rep = run_uncertainty(gen_cfg, fitted, n_data, true=true,
                          n_circuits=args.n_circuits, seed=args.seed,
                          n_boot=args.n_boot, device=device)
    rep["run"] = args.run
    rep["params_source"] = args.params_source
    rep["n_data"] = int(n_data)
    if overrides:
        rep["config_overrides"] = overrides
    text = json.dumps(rep, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    print(text)
    return 0 if "error" not in rep else 1


if __name__ == "__main__":
    sys.exit(main())
