"""C5: moment-matching fit.

Port of :mod:`tcgan_tpu.run.moments`, with the same flags. Each step solves
a generator batch (the CUDA kernel with ``--solver-backend cuda`` and
``--solver ift``, or the unrolled Euler loop with ``--solver bptt``) and
takes one Adam step on the normalized moment distance to the data.
``--parallel mesh`` shards the batch's circuits over the ranks (the
large-N sample-parallel configuration); under ``--fixed-z`` every rank
holds the whole z-set and solves its rows of it.

Usage:
    python -m tcgan_torch.run.moments --datastore runs/mm --n-steps 500 \
        --device cuda --solver-backend cuda
"""

from __future__ import annotations

import argparse
import sys

from tcgan_torch.run import common


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_ssn_flags(p)
    common.add_stimulus_flags(p)
    common.add_data_flags(p)
    common.add_run_flags(p)
    g = p.add_argument_group("moment matching")
    g.add_argument("--solver", choices=("ift", "bptt"), default="ift")
    g.add_argument("--batch-size", type=int, default=64)
    g.add_argument("--learn-rate", type=float, default=1e-3, dest="lr")
    g.add_argument("--adam-beta1", type=float, default=0.5)
    g.add_argument("--adam-beta2", type=float, default=0.9)
    g.add_argument("--mean-weight", type=float, default=1.0)
    g.add_argument("--cov-weight", type=float, default=1.0)
    g.add_argument("--rate-cost", type=float, default=0.01)
    g.add_argument("--moment-ema", type=float, default=0.0,
                   help="EMA decay for the generated moments (e.g. 0.99): "
                        "moment averaging across steps — effective "
                        "generator sample count ~batch/(1-decay)")
    g.add_argument("--moment-ema-late", type=float, default=0.0,
                   help="two-phase gamma: switch the moment-EMA decay to "
                        "this value at --moment-ema-switch-step (0 = off)")
    g.add_argument("--moment-ema-switch-step", type=int, default=0,
                   help="step at which --moment-ema-late takes over "
                        "(0 = off)")
    g.add_argument("--fixed-z", action="store_true",
                   help="common random numbers: one fixed quenched-noise "
                        "set every step (deterministic objective); the set "
                        "is kept in the checkpoint")
    g.add_argument("--no-survivor-mask", action="store_true",
                   help="disable the survivor-selection mask on generated "
                        "moments (the unmasked objective repels the truth "
                        "on batteries where circuits diverge)")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    rc = common.mesh_ranks(main, argv, args)
    if rc is not None:
        return rc
    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.models import moments as mm_lib
    from tcgan_torch.ops.cuda import ssn_solve
    from tcgan_torch.parallel import set_mesh, with_mesh_axes
    from tcgan_torch.train.checkpoint import CheckpointManager
    from tcgan_torch.train.datastore import DataStore
    from tcgan_torch.train.driver import DriverConfig, MomentMatchingDriver
    from tcgan_torch.utils.profiling import maybe_trace

    device = common.resolve_device(args)
    mesh = common.make_mesh(args)
    gen_cfg = common.generator_config_from_args(args, solver=args.solver)
    cfg = mm_lib.MomentMatchingConfig(
        gen=gen_cfg if mesh is None else with_mesh_axes(gen_cfg),
        batch_size=args.batch_size,
        lr=args.lr,
        beta1=args.adam_beta1,
        beta2=args.adam_beta2,
        mean_weight=args.mean_weight,
        cov_weight=args.cov_weight,
        rate_cost=args.rate_cost,
        seed=args.seed,
        fixed_z=args.fixed_z,
        moment_ema=args.moment_ema,
        moment_ema_late=args.moment_ema_late,
        moment_ema_switch_step=args.moment_ema_switch_step,
        survivor_mask=not args.no_survivor_mask,
    )
    launches0 = ssn_solve.launches
    dataset = common.load_or_generate_dataset(args, gen_cfg, device=device)
    extra = {"kernel_launches_fake_truth": ssn_solve.launches - launches0}
    if args.solver_backend == "cuda":
        extra["kernel_precision"] = ssn_solve.KERNEL_PRECISION
    store = DataStore(args.datastore)
    store.write_info({"entry": "moments", **vars(args)}, extra=extra)
    driver_cfg = DriverConfig(
        n_steps=args.n_steps,
        checkpoint_every=args.checkpoint_every,
        divergence_abort=args.divergence_abort,
        divergence_patience=args.divergence_patience,
        seed=args.seed,
    )
    state = mm_lib.init_state(cfg, gen_init=gen_lib.init_params(
        cfg.gen, common.as22(args.J), common.as22(args.D),
        common.as22(args.S), device=device))
    ckpt = CheckpointManager(store.subdir("ckpt"))
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
    driver = MomentMatchingDriver(cfg, driver_cfg, store, mm_lib.train_step,
                                  state, dataset.moments(), checkpoints=ckpt)
    with maybe_trace(args.profile_dir), set_mesh(mesh):
        driver.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
