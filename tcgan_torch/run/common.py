"""Shared CLI flag machinery (the subset the forward entry point needs).

Port of :mod:`tcgan_tpu.run.common`: the same option strings and dests, so a
command line of ``tcgan_tpu.run.forward`` parses here too, with two
differences: ``--solver-backend`` takes ``torch`` or ``cuda`` (for the
reference's ``xla`` and ``pallas``), and ``--device`` names the torch
device. The GAN and data flags come with the GAN slice.
"""

from __future__ import annotations

import argparse

import torch

from tcgan_torch.models.generator import GeneratorConfig
from tcgan_torch.ops.ssn import (
    BACKENDS,
    DEFAULT_BANDWIDTHS,
    DEFAULT_CONTRASTS,
    DEFAULT_D,
    DEFAULT_J,
    DEFAULT_S,
    SSNConfig,
)


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
    g.add_argument("--solver-backend", choices=BACKENDS, default="torch",
                   help="fixed-point forward: lockstep torch solve, or the "
                        "fused CUDA solver kernel (runs its plain torch "
                        "version on CPU tensors)")
    g.add_argument("--check-every", type=int, default=32,
                   help="convergence-check stride (Euler steps); the solve "
                        "returns the same fixed points at the same atol, "
                        "only the stop check is strided")
    g.add_argument("--pallas-block-b", type=int, default=16,
                   help="circuits per TPU kernel tile; parsed for flag "
                        "parity, not read by the CUDA kernel (one block "
                        "per circuit)")
    g.add_argument("--pallas-two-phase", choices=("on", "off"), default="on",
                   help="TPU kernel's fast-pass first loop; parsed for flag "
                        "parity, the CUDA kernel runs every substep in fp32")
    g.add_argument("--pallas-refine", choices=("on", "off"), default="on",
                   help="TPU kernel's iterative-refinement tail; parsed for "
                        "flag parity, not read by the CUDA kernel")
    g.add_argument("--pallas-reopen-margin", type=float, default=0.0,
                   help="TPU kernel's phase-2 divergence-reopen margin; "
                        "parsed for flag parity, not read by the CUDA kernel")
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
                   help="'mesh': shard the sample batch over all devices "
                        "(not ported yet)")
    g.add_argument("--profile-dir", type=str, default=None,
                   help="write a device trace of the run here (read by the "
                        "training entry points, not ported yet)")
    g.add_argument("--dtype", choices=("float32", "bfloat16", "float64"),
                   default="float32")
    g.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on; 'cuda' with no visible "
                        "GPU is an error, never a CPU fallback")


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
