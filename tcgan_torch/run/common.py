"""Shared CLI flag machinery of the forward and GAN entry points.

Port of :mod:`tcgan_tpu.run.common`: the same option strings, dests and
defaults, so a command line of ``tcgan_tpu.run.forward`` or
``tcgan_tpu.run.gan`` parses here too. ``--solver-backend`` takes the
port's ``torch`` and ``cuda`` and the reference's ``xla`` and ``pallas`` for
the same two, stored as the port's names; ``--device`` names the torch
device.

:func:`apply_run_config` lets the evaluation and analysis entry points
rebuild a training run's scientific configuration from its ``info.json``
(a run of either package), explicit flags overriding it loudly.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from tcgan_torch.models.generator import GeneratorConfig
from tcgan_torch.ops.ssn import (
    BACKEND_ALIASES,
    BACKENDS,
    DEFAULT_BANDWIDTHS,
    DEFAULT_CONTRASTS,
    DEFAULT_D,
    DEFAULT_J,
    DEFAULT_S,
    SSNConfig,
    canonical_backend,
)


def mat22(values: Sequence[float]):
    v = [float(x) for x in values]
    if len(v) != 4:
        raise argparse.ArgumentTypeError("expected 4 values (row-major 2x2)")
    return ((v[0], v[1]), (v[2], v[3]))


def add_ssn_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("SSN circuit")
    flat = lambda m: [x for row in m for x in row]  # noqa: E731
    g.add_argument("--J", type=float, nargs=4, default=flat(DEFAULT_J),
                   metavar="Jab",
                   help="2x2 mean connectivity, row-major (EE EI IE II)")
    g.add_argument("--D", type=float, nargs=4, default=flat(DEFAULT_D),
                   metavar="Dab", help="2x2 disorder (delta), row-major")
    g.add_argument("--S", type=float, nargs=4, default=flat(DEFAULT_S),
                   metavar="Sab", help="2x2 spatial range (sigma), row-major")
    g.add_argument("--N", type=int, default=51, help="sites per population")
    g.add_argument("--k", type=float, default=0.01, help="io gain")
    g.add_argument("--n", type=float, default=2.2, help="io exponent")
    g.add_argument("--tau-E", type=float, default=0.016,
                   help="E time constant (s)")
    g.add_argument("--tau-I", type=float, default=0.002,
                   help="I time constant (s)")
    g.add_argument("--dt", type=float, default=0.0005, help="Euler step (s)")
    g.add_argument("--seqlen", type=int, default=4000,
                   help="BPTT path: unrolled Euler steps")
    g.add_argument("--max-iter", type=int, default=10000,
                   help="fixed-point path: max Euler iterations")
    g.add_argument("--atol", type=float, default=1e-5,
                   help="fixed-point residual tolerance")
    g.add_argument("--rate-stop-at", type=float, default=200.0,
                   help="divergence ceiling on rates")
    g.add_argument("--io_type",
                   choices=("asym_power", "asym_tanh", "asym_linear"),
                   default="asym_power")
    g.add_argument("--rate-soft-bound", type=float, default=100.0)
    g.add_argument("--rate-hard-bound", type=float, default=200.0)
    g.add_argument("--smoothness", type=float, default=0.03125,
                   help="stimulus edge smoothness")
    g.add_argument("--solver-backend", type=canonical_backend,
                   choices=BACKENDS, default="torch",
                   metavar="{" + ",".join(BACKENDS + tuple(BACKEND_ALIASES))
                   + "}",
                   help="fixed-point forward: lockstep torch solve, or the "
                        "fused CUDA solver kernel (runs its plain torch "
                        "version on CPU tensors); the reference's xla and "
                        "pallas name the same two and are stored as torch "
                        "and cuda")
    g.add_argument("--check-every", type=int, default=32,
                   help="convergence-check stride (Euler steps); the solve "
                        "returns the same fixed points at the same atol, "
                        "only the stop check is strided")
    g.add_argument("--pallas-block-b", type=int, default=16,
                   help="circuits per TPU kernel tile; parsed for flag "
                        "parity, not read: the CUDA kernel's tile is one "
                        "circuit's chunk of rows (a block or a cluster), "
                        "the TPU kernel's tile at 1")
    g.add_argument("--pallas-two-phase", choices=("on", "off"), default="on",
                   help="the solver kernel's two-phase schedule: a first "
                        "phase of one TF32 pass per product down to "
                        "max(100 atol, 1e-2) within max-iter/2 substeps, "
                        "then every flag decided again at fp32 accuracy "
                        "(see --pallas-refine) to atol; off: 3xTF32 "
                        "throughout")
    g.add_argument("--pallas-refine", choices=("on", "off"), default="on",
                   help="the solver kernel's phase 2 in two phases: on, "
                        "the iterative-refinement tail (per check chunk a "
                        "3xTF32 anchor W r + I, then the substeps on the "
                        "correction from those rates in one TF32 pass); "
                        "off: 3xTF32 on every substep")
    g.add_argument("--pallas-reopen-margin", type=float, default=0.0,
                   help="two-phase schedule: rows whose phase-1 rates are "
                        "pinned above MARGIN * rate-stop-at keep their "
                        "divergence flag and phase-1 iters instead of "
                        "re-proving it in phase 2; 0 = reopen every row "
                        "(the reference's default), 2.0 the reference's "
                        "validated setting; must be finite and >= 0")
    g.add_argument("--init", choices=("zero", "feedforward"), default="zero",
                   help="fixed-point initial rates: zeros (reference) or "
                        "the feedforward estimate f(I)")
    g.add_argument("--stepper", choices=("euler", "expo"), default="euler",
                   help="euler: forward Euler; expo: exponential Euler "
                        "(exact leak integration, same fixed point)")
    g.add_argument("--accel", choices=("none", "anderson"), default="none",
                   help="fixed-point acceleration: Anderson(1) per check "
                        "chunk, same fixed point")


def add_stimulus_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("stimulus battery / readout")
    g.add_argument("--bandwidths", type=float, nargs="+",
                   default=list(DEFAULT_BANDWIDTHS))
    g.add_argument("--contrasts", type=float, nargs="+",
                   default=list(DEFAULT_CONTRASTS))
    g.add_argument("--sample-sites", type=int, default=1,
                   help="number of probe sites read out (center-out)")
    g.add_argument("--track_offset_identity", action="store_true",
                   help="concatenate probe sites into one sample instead of "
                        "treating each site as an independent sample")
    g.add_argument("--include-inhibitory-neurons", action="store_true",
                   help="also read out I cells at the probe sites")
    g.add_argument("--antithetic", action="store_true",
                   help="antithetic (+z, -z) quenched-noise pairs "
                        "(requires even --batch-size)")


def add_run_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("run plumbing")
    g.add_argument("--datastore", type=str, required=True,
                   help="run directory for recorder streams / checkpoints")
    g.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in the datastore")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--n-steps", type=int, default=1000)
    g.add_argument("--checkpoint-every", type=int, default=100)
    g.add_argument("--timing-every", type=int, default=0,
                   help="measure SSsolve_time/gradient_time columns every "
                        "k steps (0 = off)")
    g.add_argument("--tc-mean-every", type=int, default=50,
                   help="record the mean generated tuning curve every k "
                        "steps (0 = off)")
    g.add_argument("--divergence-abort", type=float, default=0.5)
    g.add_argument("--divergence-patience", type=int, default=20)
    g.add_argument("--parallel", choices=("none", "mesh"), default="none",
                   help="'mesh': shard the sample batch over all devices: "
                        "one rank per visible CUDA device (or per torchrun "
                        "process; one on the CPU)")
    g.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of the run here, "
                        "trace.json, and the program's counters of the "
                        "traced run (host syncs and their wait, the "
                        "solver's rows and substeps by phase), "
                        "counters.json (training entry points)")
    g.add_argument("--dtype", choices=("float32", "bfloat16", "float64"),
                   default="float32")
    g.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on; 'cuda' with no visible "
                        "GPU is an error, never a CPU fallback")


def add_gan_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("GAN")
    g.add_argument("--disc-layers", type=int, nargs="+", default=[128, 128],
                   help="critic MLP hidden layer sizes")
    g.add_argument("--batch-size", type=int, default=64,
                   help="circuits sampled per generator batch")
    g.add_argument("--WGAN_lambda", type=float, default=10.0,
                   dest="gp_lambda")
    g.add_argument("--WGAN_n_critic", type=int, default=5, dest="n_critic")
    g.add_argument("--WGAN_n_critic0", type=int, default=50,
                   dest="n_critic0")
    g.add_argument("--disc-learn-rate", type=float, default=1e-3,
                   dest="lr_critic")
    g.add_argument("--gen-learn-rate", type=float, default=1e-4,
                   dest="lr_gen")
    g.add_argument("--adam-beta1", type=float, default=0.5)
    g.add_argument("--adam-beta2", type=float, default=0.9)
    g.add_argument("--rate-cost", type=float, default=0.01)
    g.add_argument("--normalize-input", action="store_true",
                   help="scale critic inputs by 1/mean dataset tuning curve")
    g.add_argument("--normalize-input-mode", choices=("mean", "std"),
                   default=None,
                   help="per-feature scale for --normalize-input (implies "
                        "it): 'mean' = 1/|mean TC|, 'std' = 1/std with a "
                        "5%%-of-mean-|TC| degeneracy floor")
    g.add_argument("--normalize-per-condition", nargs="?", const="mean",
                   choices=("mean", "std"), default=None,
                   help="(conditional WGAN) per-(condition, probe) critic "
                        "input scale")
    g.add_argument("--contrast-weights", type=float, nargs="+", default=None,
                   help="(conditional WGAN) per-contrast loss weights in "
                        "--contrasts order")
    g.add_argument("--moment-anchor", type=float, default=0.0,
                   help="hybrid objective: per GAN step, extra Adam "
                        "update(s) on the survivor-masked EMA-averaged "
                        "moment residual with this learn rate (0 = off)")
    g.add_argument("--anchor-ema", type=float, default=0.995,
                   help="EMA decay for the anchor's generated moments")
    g.add_argument("--anchor-ema-late", type=float, default=0.0,
                   help="two-phase anchor gamma: switch the anchor EMA "
                        "decay to this value at --anchor-ema-switch-step "
                        "(0 = off)")
    g.add_argument("--anchor-ema-switch-step", type=int, default=0,
                   help="GAN step at which --anchor-ema-late takes over "
                        "(0 = off)")
    g.add_argument("--anchor-ema-switch-drift", type=float, default=0.0,
                   help="drift-latched late gamma (0 = off): engage "
                        "--anchor-ema-late when the max-over-components "
                        "ratio |EMA(delta)|/EMA(|delta|) of the generator "
                        "params first drops below this value; "
                        "--anchor-ema-switch-step arms it; recorded per "
                        "step as drift_ratio in learning.jsonl. Prefer "
                        "--anchor-ema-switch-vel: at production step noise "
                        "this ratio fires at the arming step")
    g.add_argument("--anchor-ema-switch-vel", type=float, default=0.0,
                   help="velocity-latched late gamma (0 = off; mutually "
                        "exclusive with --anchor-ema-switch-drift): engage "
                        "--anchor-ema-late when the max-over-components "
                        "smoothed relative parameter velocity first drops "
                        "below this value, in %%-per-1000-steps (try 1.0); "
                        "--anchor-ema-switch-step arms it; recorded per "
                        "step as drift_ratio in learning.jsonl")
    g.add_argument("--anchor-drift-ema", type=float, default=0.995,
                   help="decay for the drift detector's delta EMAs")
    g.add_argument("--anchor-updates", type=int, default=1,
                   help="anchor Adam updates per GAN step (fresh generator "
                        "batch each)")
    g.add_argument("--anchor-beta1", type=float, default=None,
                   help="beta1 for the anchor's own Adam (default: "
                        "--adam-beta1)")
    g.add_argument("--critic-lr-decay-steps", type=int, default=-1,
                   help="critic-side lr decay horizon: -1 = follow "
                        "--lr-decay-steps, 0 = constant critic lr")
    g.add_argument("--reject-unconverged", action="store_true",
                   help="drop non-converged fake samples from the critic "
                        "objective (the fake-truth dataset's survivor "
                        "selection)")
    g.add_argument("--clip-grad", type=float, default=0.0,
                   help="global-norm gradient clip for both nets (0 = off)")
    g.add_argument("--lr-decay-steps", type=int, default=0,
                   help="exponential lr decay horizon in steps (0 = off)")
    g.add_argument("--lr-decay-rate", type=float, default=0.5,
                   help="decay factor applied every --lr-decay-steps")
    g.add_argument("--gen-lr-floor", type=float, default=0.0,
                   help="critic-cooling endgame floor for the adversarial "
                        "generator lr")
    g.add_argument("--gen-lr-switch-step", "--phase-switch-at", type=int,
                   default=0, dest="gen_lr_switch_step",
                   help="hard-switch the adversarial generator lr to "
                        "--gen-lr-floor at this step (0 = off)")
    g.add_argument("--gen-lr-switch-residual", type=float, default=0.0,
                   help="latch the adversarial lr to --gen-lr-floor once "
                        "the anchor's debiased EMA residual first drops "
                        "below this value (requires --moment-anchor)")
    g.add_argument("--gen-lr-switch-min-step", type=int, default=0,
                   help="arm the residual trigger only from this step on")
    g.add_argument("--adaptive-max-iter", choices=("on", "off"),
                   default="on",
                   help="adaptive train-time solver budget: cap max_iter "
                        "at ~4x the healthy-step mean iteration count "
                        "(power-of-2 buckets)")
    g.add_argument("--adaptive-margin", type=float, default=4.0,
                   help="safety margin for --adaptive-max-iter")
    g.add_argument("--gen-ema", type=float, default=0.0,
                   help="EMA decay for generator params (0 = off); exported "
                        "to disc_params.npz as J_ema/D_ema/S_ema")


def add_data_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("data (real tuning curves)")
    g.add_argument("--dataset", type=str, default=None,
                   help=".npz/.npy/.mat tuning-curve dataset; if omitted, a "
                        "fake-truth dataset is generated from --true-J/D/S")
    g.add_argument("--true-J", type=float, nargs=4, default=None)
    g.add_argument("--true-D", type=float, nargs=4, default=None)
    g.add_argument("--true-S", type=float, nargs=4, default=None)
    g.add_argument("--truth-samples", type=int, default=1024,
                   help="fake-truth dataset size")
    g.add_argument("--truth-seed", type=int, default=42)
    g.add_argument("--truth-batch", type=int, default=64,
                   help="circuits per fake-truth solver batch")
    g.add_argument("--truth-tries-factor", type=int, default=4,
                   help="abort fake-truth generation below ~1/factor "
                        "per-circuit yield")


def critic_input_scales(args, gen_cfg, dataset, conditional):
    """Critic input-normalization scales from the dataset: honors
    ``--normalize-per-condition`` (conditional runs only) and
    ``--normalize-input`` / ``--normalize-input-mode`` (an explicit mode
    implies the switch; ``args`` is updated in place so info.json records
    what ran). Returns ``(input_scale, cond_input_scale)``, flat tuples or
    None."""
    if getattr(args, "normalize_input_mode", None) is not None:
        args.normalize_input = True
    per_cond = getattr(args, "normalize_per_condition", None)
    if per_cond is not None and not conditional:
        raise SystemExit(
            "--normalize-per-condition requires a conditional run; for the "
            "unconditional critic use --normalize-input "
            "[--normalize-input-mode std]")
    input_scale = None
    cond_input_scale = None
    tc = dataset.tc.detach().cpu().numpy()
    if conditional and per_cond is not None:
        tc = tc.reshape(dataset.num_samples, gen_cfg.n_stim, gen_cfg.n_probe)
        denom = tc.std(axis=0) if per_cond == "std" else \
            np.abs(tc.mean(axis=0))
        # floor at 5% of the global TC magnitude: near-silent conditions
        # would otherwise amplify pure noise
        floor = 0.05 * float(np.abs(tc).mean())
        sp_scale = 1.0 / np.maximum(denom, max(floor, 1e-6))
        feats = gen_cfg.condition_features().numpy()
        tag_scale = 1.0 / np.maximum(np.abs(feats).max(axis=0), 1e-6)
        cond_input_scale = tuple(
            float(s) for s in np.concatenate([sp_scale.ravel(), tag_scale]))
    elif getattr(args, "normalize_input", False):
        if getattr(args, "normalize_input_mode", "mean") == "std":
            floor = 0.05 * float(np.abs(tc).mean())
            scale = 1.0 / np.maximum(tc.std(axis=0), max(floor, 1e-6))
        else:
            scale = 1.0 / np.maximum(np.abs(tc.mean(axis=0)), 1e-6)
        if conditional:
            probe_scale = scale.reshape(gen_cfg.n_stim,
                                        gen_cfg.n_probe).mean(axis=0)
            scale = np.concatenate([probe_scale, np.ones(2)])
        input_scale = tuple(float(s) for s in scale)
    return input_scale, cond_input_scale


def contrast_cond_weight(args, conditional):
    """Per-condition loss weights from ``--contrast-weights`` (conditional
    runs), expanded across bandwidths in the battery's contrast-major
    order and normalized to mean 1; None otherwise."""
    if not (conditional and getattr(args, "contrast_weights", None)):
        return None
    cw = np.asarray(args.contrast_weights, dtype=np.float64)
    if cw.shape[0] != len(args.contrasts):
        raise SystemExit(
            f"--contrast-weights needs {len(args.contrasts)} values "
            f"(one per --contrasts entry), got {cw.shape[0]}")
    per_stim = np.repeat(cw, len(args.bandwidths))
    per_stim = per_stim / per_stim.mean()
    return tuple(float(w) for w in per_stim)


def explicit_dests(parser: argparse.ArgumentParser, argv) -> set:
    """Dests of options explicitly present on the command line (vs taking
    their parser default), with argparse's prefix-abbreviation rule: an
    unambiguous ``--contrast`` sets the ``contrasts`` dest, so it is
    explicit too."""
    argv = list(sys.argv[1:] if argv is None else argv)
    tokens = []
    for tok in argv:
        if tok == "--":  # argparse: everything after is positional
            break
        if tok.startswith("--"):
            tokens.append(tok.split("=", 1)[0])
    seen = set()
    for tok in tokens:
        exact = [a for a in parser._actions if tok in a.option_strings]
        if exact:
            seen.add(exact[0].dest)
            continue
        # unambiguous abbreviation: every prefix-matching option agrees on
        # one dest (argparse itself rejects an ambiguous prefix)
        dests = {a.dest for a in parser._actions
                 if any(o.startswith(tok) for o in a.option_strings
                        if o.startswith("--"))}
        if len(dests) == 1:
            seen.add(dests.pop())
    return seen


def run_config_dests() -> set:
    """Arg dests of a run's scientific configuration (SSN circuit, stimulus
    battery and readout, data and truth): what an evaluation must take from
    the training run's ``info.json`` to compute the right W1 and recovery
    numbers."""
    p = argparse.ArgumentParser(add_help=False)
    add_ssn_flags(p)
    add_stimulus_flags(p)
    add_data_flags(p)
    return {a.dest for a in p._actions if a.dest != "help"}


def apply_run_config(args, parser: argparse.ArgumentParser, argv,
                     run_dir) -> list:
    """Overlay the training run's recorded config (``info.json`` in
    ``run_dir``) onto ``args`` for every scientific-config dest the user
    did not set explicitly. An explicit flag wins, and a mismatch against
    the recorded value is reported (returned and printed to stderr). A
    recorded value is read through its option's type, as on a command line
    (the reference's ``--solver-backend pallas`` is ``cuda``); one this
    parser's option does not accept keeps the CLI's value, with a notice.

    Returns the notices (empty when the CLI agrees with the run's config or
    no info.json exists)."""
    info_path = Path(run_dir) / "info.json"
    if not info_path.exists():
        print(f"eval: no info.json under {run_dir} — relying on CLI flags "
              "for the run configuration", file=sys.stderr)
        return []
    run_cfg = json.loads(info_path.read_text()).get("config", {})
    explicit = explicit_dests(parser, argv)
    choices = {a.dest: a.choices for a in parser._actions if a.choices}
    types = {a.dest: a.type for a in parser._actions if callable(a.type)}
    notices = []
    for dest in sorted(run_config_dests()):
        if dest not in run_cfg:
            continue
        run_val = run_cfg[dest]
        if isinstance(run_val, str) and dest in types:
            run_val = types[dest](run_val)
        cur = getattr(args, dest, None)
        if dest in explicit:
            if cur != run_val:
                msg = (f"eval: --{dest.replace('_', '-')} overrides the "
                       f"run's recorded config (run: {run_val!r}, "
                       f"cli: {cur!r})")
                notices.append(msg)
                print(msg, file=sys.stderr)
        elif dest in choices and run_val not in choices[dest]:
            msg = (f"eval: the run's --{dest.replace('_', '-')} {run_val!r} "
                   f"is not an option here; using {cur!r}")
            notices.append(msg)
            print(msg, file=sys.stderr)
        else:
            setattr(args, dest, run_val)
    return notices


def resolve_device(args) -> torch.device:
    """``--device`` as a torch device (``cuda`` is the current CUDA device:
    a mesh rank's own); a CUDA device with none visible is an error, never
    a CPU fallback."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "visible (there is no CPU fallback; pass "
                           "--device cpu to run on the CPU)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def mesh_ranks(main, argv, args) -> int | None:
    """``--parallel mesh`` in a process that is not yet a rank: run
    ``main(argv)`` on every rank (:func:`tcgan_torch.parallel.launch.
    run_ranks`) and return the exit code; None when the entry point should
    run its body here (no mesh, or this process is a rank)."""
    from tcgan_torch.parallel import launch

    if args.parallel != "mesh" or launch.in_group():
        return None
    return launch.run_ranks(main, argv, resolve_device(args))


def make_mesh(args):
    """The run's mesh over every rank (``--parallel mesh``), else None."""
    if args.parallel != "mesh":
        return None
    from tcgan_torch.parallel import mesh

    return mesh.make_mesh()


def ssn_config_from_args(args) -> SSNConfig:
    return SSNConfig(
        N=args.N, k=args.k, n=args.n, tau_E=args.tau_E, tau_I=args.tau_I,
        dt=args.dt, io_type=args.io_type,
        rate_soft_bound=args.rate_soft_bound,
        rate_hard_bound=args.rate_hard_bound,
        smoothness=args.smoothness, max_iter=args.max_iter, atol=args.atol,
        rate_stop_at=args.rate_stop_at, seqlen=args.seqlen,
        backend=args.solver_backend, check_every=args.check_every,
        pallas_block_b=args.pallas_block_b,
        pallas_two_phase=(args.pallas_two_phase == "on"),
        pallas_refine=(args.pallas_refine == "on"),
        pallas_reopen_margin=args.pallas_reopen_margin,
        stepper=args.stepper,
        init=args.init,
        accel=args.accel,
    )


def generator_config_from_args(args, solver: str) -> GeneratorConfig:
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float64": torch.float64}[args.dtype]
    return GeneratorConfig(
        ssn=ssn_config_from_args(args),
        bandwidths=tuple(args.bandwidths),
        contrasts=tuple(args.contrasts),
        sample_sites=args.sample_sites,
        track_offset_identity=args.track_offset_identity,
        include_inhibitory_neurons=args.include_inhibitory_neurons,
        antithetic=args.antithetic,
        solver=solver,
        dtype=dtype,
    )


def as22(flat) -> tuple:
    return ((flat[0], flat[1]), (flat[2], flat[3]))


def resolve_true_params(args):
    tj = as22(args.true_J) if args.true_J else DEFAULT_J
    td = as22(args.true_D) if args.true_D else DEFAULT_D
    ts = as22(args.true_S) if args.true_S else DEFAULT_S
    return tj, td, ts


def load_or_generate_dataset(args, gen_cfg: GeneratorConfig, device=None):
    """Real tuning curves on ``device``: from file, or fake truth solved at
    the known params (``--true-J/D/S``) on that device."""
    from tcgan_torch.data.datasets import (
        TuningCurveDataset, generate_fake_truth, load_tuning_curves,
    )

    if args.dataset:
        arr = load_tuning_curves(args.dataset)
    else:
        tj, td, ts = resolve_true_params(args)
        arr = generate_fake_truth(
            gen_cfg, tj, td, ts, args.truth_samples, seed=args.truth_seed,
            batch=args.truth_batch, tries_factor=args.truth_tries_factor,
            device=device)
    return TuningCurveDataset.from_array(arr, device=device)
