"""Evaluate a fitted run: tuning-curve distribution parity + parameter
recovery.

Port of :mod:`tcgan_tpu.run.eval`, with the same flags (``--device`` and
``--solver-backend`` in the port's idiom) and result keys. It reads a run of
either package.

Usage:
    python -m tcgan_torch.run.eval --run runs/gan --datastore runs/gan_eval \\
        --device cuda --solver-backend cuda \\
        [--dataset data.npz | --true-J ... --true-D ... --true-S ...]

Loads the final generator parameters from the run's ``generator.csv`` (or
its ``disc_params.npz``), samples tuning curves with one forward solve (one
kernel launch under ``--solver-backend cuda``), and prints a JSON line with
W1 / sliced-W1 against the dataset, the per-condition W1 and relative
parameter-recovery errors against the true params (when known). The
training run's scientific config is read from its ``info.json``; explicit
flags override it, loudly. Every number is computed without matplotlib; the
PNGs are written only where it is installed, else the result records
``"plots": "skipped: matplotlib not installed"``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from tcgan_torch.run import common
from tcgan_torch.utils.plotting import PLOTS_SKIPPED, have_matplotlib


def _plot_tc_comparison(gen_tc: np.ndarray, data_tc: np.ndarray, out_path):
    """Mean tuning curve +/- std, generated vs data."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (a0, a1) = plt.subplots(1, 2, figsize=(11, 4))
    xs = np.arange(gen_tc.shape[1])
    for tc, label, color in ((data_tc, "data", "C0"),
                             (gen_tc, "generated", "C1")):
        m, s = tc.mean(0), tc.std(0)
        a0.plot(xs, m, color=color, label=label)
        a0.fill_between(xs, m - s, m + s, color=color, alpha=0.25)
    a0.set_xlabel("tuning-curve feature (condition index)")
    a0.set_ylabel("rate")
    a0.set_title("mean tuning curve ± std")
    a0.legend()
    # per-feature marginals at the most informative feature
    fidx = int(np.argmax(data_tc.std(0)))
    a1.hist(data_tc[:, fidx], bins=30, alpha=0.6, label="data", density=True)
    a1.hist(gen_tc[:, fidx], bins=30, alpha=0.6, label="generated",
            density=True)
    a1.set_title(f"marginal at feature {fidx}")
    a1.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_ssn_flags(p)
    common.add_stimulus_flags(p)
    common.add_data_flags(p)
    p.add_argument("--run", type=str, required=True,
                   help="datastore of the fitted run (reads generator.csv)")
    p.add_argument("--datastore", type=str, default=None,
                   help="optional dir to write eval artifacts")
    p.add_argument("--eval-samples", type=int, default=256,
                   help="generated circuits for the comparison")
    p.add_argument("--params-source", choices=("csv", "npz", "npz_ema"),
                   default="csv",
                   help="fitted params: final generator.csv row (csv), the "
                        "disc_params.npz export (npz), or its EMA-averaged "
                        "J_ema/D_ema/S_ema entries (npz_ema; requires a run "
                        "trained with --gen-ema)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", choices=("float32", "bfloat16", "float64"),
                   default="float32")
    p.add_argument("--no-run-config", action="store_true",
                   help="do NOT default-load the SSN/stimulus/data config "
                        "from the run's info.json (then every scientific "
                        "flag must be retyped to match the training run)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on; 'cuda' with no visible "
                        "GPU is an error, never a CPU fallback")
    return p


def main(argv=None):
    import torch

    from tcgan_torch.analysis.identifiability import survivor_tc
    from tcgan_torch.analysis.loaders import fitted_params, load_run
    from tcgan_torch.analysis.metrics import (param_recovery_error,
                                              sliced_w1, tc_w1)
    from tcgan_torch.analysis.tc_grid import per_condition_w1, plot_tc_grid
    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.ops.cuda import ssn_solve

    parser = make_parser()
    args = parser.parse_args(argv)
    # Default-load the training run's recorded scientific config so a bare
    # `eval --run <dir>` reproduces the training battery/readout/SSN setup
    # exactly; explicit CLI flags override (loudly).
    overrides = []
    if not args.no_run_config:
        overrides = common.apply_run_config(args, parser, argv, args.run)
    device = common.resolve_device(args)

    gen_cfg = common.generator_config_from_args(args, solver="ift")
    rec = load_run(args.run)
    # {"J","D","S"} 2x2 value-space
    fitted = fitted_params(args.run, args.params_source, rec=rec)
    params = gen_lib.init_params(
        gen_cfg, *(tuple(map(tuple, fitted[k])) for k in ("J", "D", "S")),
        device=device)
    with torch.inference_mode():
        out = gen_lib.sample_tuning_curves(
            gen_cfg, params, args.eval_samples,
            generator=torch.Generator(device).manual_seed(args.seed))
    gen_tc = survivor_tc(gen_cfg, out)
    frac_converged = float(out.converged.float().mean())

    if gen_tc.shape[0] == 0:
        # The fitted parameters sit in the divergent region: report that
        # instead of crashing inside np.quantile on a zero-row array.
        print(json.dumps({
            "n_gen": 0,
            "frac_converged": frac_converged,
            "fitted_params": {k: np.asarray(v).tolist()
                              for k, v in fitted.items()},
            "error": "no generated sample survived the run's survivor "
                     "selection — W1 metrics undefined",
        }))
        return 1

    launches0 = ssn_solve.launches
    dataset = common.load_or_generate_dataset(args, gen_cfg, device=device)
    truth_launches = ssn_solve.launches - launches0
    data_tc = dataset.tc.cpu().numpy()

    result = {
        "n_gen": int(gen_tc.shape[0]),
        "n_data": int(data_tc.shape[0]),
        "tc_w1": tc_w1(gen_tc, data_tc),
        "sliced_w1": sliced_w1(gen_tc, data_tc),
        "frac_converged": frac_converged,
        "fitted_params": {k: np.asarray(v).tolist()
                          for k, v in fitted.items()},
    }
    if overrides:
        result["config_overrides"] = overrides
    if not args.dataset:
        # Fake-truth run: the truth is known through the same fallback
        # chain dataset generation used.
        tj, td, ts = common.resolve_true_params(args)
        true = {"J": np.asarray(tj), "D": np.asarray(td),
                "S": np.asarray(ts)}
        result["param_recovery_error"] = param_recovery_error(
            {k: np.asarray(v) for k, v in fitted.items()}, true)

    if args.datastore:
        from tcgan_torch.train.datastore import DataStore

        store = DataStore(args.datastore)
        store.write_info({"entry": "eval", **vars(args)},
                         extra={"kernel_launches_fake_truth": truth_launches})
        np.savez(store.file("eval_tuning_curves.npz"), gen_tc=gen_tc,
                 data_tc=data_tc)
        w1s = per_condition_w1(gen_tc, data_tc)
        if have_matplotlib():
            _plot_tc_comparison(gen_tc, data_tc,
                                store.file("tc_comparison.png"))
            # labels only meaningful when each tc feature IS one condition
            labels = (gen_cfg.condition_features().tolist()
                      if gen_tc.shape[1] == gen_cfg.n_stim else None)
            plot_tc_grid(gen_tc, data_tc, labels, store.file("tc_grid.png"))
        else:
            result["plots"] = PLOTS_SKIPPED
        result["per_condition_w1"] = [round(float(w), 6) for w in w1s]
        store.finalize("finished", {"result": result})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
