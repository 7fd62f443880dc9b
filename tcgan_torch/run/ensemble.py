"""Ensemble (multi-start) fitting CLI: K independent fits stepped as one
(:mod:`tcgan_torch.models.ensemble`).

Port of :mod:`tcgan_tpu.run.ensemble`, with the same flags, estimators and
artifacts. Every solve of a step is one CUDA kernel launch for all K
members, so a step launches the kernel n_critic + 1 times (one for moment
matching), as one fit's step does. ``--parallel mesh`` splits the MEMBERS
over the ranks (``--ensemble`` divisible by their count): each steps its
K/P members with no collective across members, on the noise the unsharded
run would give them, and rank 0 gathers the members for the CSV, the
checkpoints and the final artifacts. Usage::

    python -m tcgan_torch.run.ensemble --datastore runs/ens \\
        --ensemble 8 --start-jitter 0.05 --batch-size 64 \\
        --device cuda --solver-backend cuda [gan flags...]

Artifacts, readable by ``tcgan_tpu.analysis.loaders.load_ensemble`` and by
the port's own copy: ``ensemble.csv`` (per-member learning and parameter
trajectory), ``ensemble_params.npz`` (final member-stacked J/D/S [+ EMA]),
``ensemble_summary.json`` (across-member mean/std + per-member recovery
errors when truth is known), checkpoints of the stacked state under
``ckpt/``.
"""

from __future__ import annotations

import json


def make_parser():
    from tcgan_torch.run.gan_common import make_gan_parser

    p = make_gan_parser(__doc__)
    g = p.add_argument_group("ensemble")
    g.add_argument("--ensemble", type=int, default=4,
                   help="number of member fits stepped as one")
    g.add_argument("--start-jitter", type=float, default=0.0,
                   help="log-space stddev of per-member start perturbation "
                        "(member 0 keeps the exact --J/--D/--S start)")
    g.add_argument("--record-every", type=int, default=10,
                   help="write ensemble.csv rows every k steps")
    g.add_argument("--conditional", action="store_true",
                   help="conditional WGAN members (cwgan semantics: "
                        "condition-tagged samples, within-condition GP)")
    g.add_argument("--estimator", choices=("wgan", "cwgan", "mm"),
                   default=None,
                   help="member estimator: wgan (default), cwgan (same as "
                        "--conditional), or mm — multi-start MOMENT "
                        "MATCHING (member-stacked state incl. moment-EMA "
                        "buffers)")
    g.add_argument("--mm-lr", type=float, default=1e-3,
                   help="(mm) member Adam learn rate")
    g.add_argument("--moment-ema", type=float, default=0.0,
                   help="(mm) EMA decay for generated moments per member")
    g.add_argument("--moment-ema-late", type=float, default=0.0,
                   help="(mm) two-phase gamma: switch the moment-EMA "
                        "decay to this value at --moment-ema-switch-step "
                        "(0 = off)")
    g.add_argument("--moment-ema-switch-step", type=int, default=0,
                   help="(mm) step at which --moment-ema-late takes over")
    g.add_argument("--fixed-z", action="store_true",
                   help="(mm) common-random-numbers quenched noise, one "
                        "z-set per member")
    g.add_argument("--data-seed-per-member", action="store_true",
                   help="(mm) give each member its OWN fake-truth dataset "
                        "(truth seed = --truth-seed + member index), so "
                        "the member spread includes SAMPLING variance and "
                        "is comparable to the CRLB. Default (shared "
                        "dataset) measures estimator-internal noise only. "
                        "Requires generated fake truth (incompatible with "
                        "--dataset).")
    g.add_argument("--mean-weight", type=float, default=1.0)
    g.add_argument("--cov-weight", type=float, default=1.0)
    return p


def main(argv=None) -> int:
    from tcgan_torch.run import common

    args = make_parser().parse_args(argv)
    gen_cfg = common.generator_config_from_args(args, solver="ift")
    if args.record_every < 1:
        raise SystemExit("--record-every must be >= 1 (ensemble.csv IS "
                         "the run's output stream)")
    # Contradictory flag combinations error loudly instead of resolving
    # silently (an unconditional mm or a cwgan recorded as 'wgan' would
    # otherwise train behind the user's back).
    if args.estimator == "wgan" and args.conditional:
        raise SystemExit("--estimator wgan contradicts --conditional; "
                         "use --estimator cwgan (or drop --conditional)")
    estimator = args.estimator or ("cwgan" if args.conditional else "wgan")
    if estimator == "cwgan":
        args.conditional = True
    if estimator == "mm":
        if args.conditional:
            raise SystemExit("--estimator mm has no conditional path; "
                             "drop --conditional")
        if args.parallel == "mesh":
            raise SystemExit("--estimator mm does not support --parallel "
                             "mesh (members are not sharded); drop the "
                             "flag to run single-device")
    rc = common.mesh_ranks(main, argv, args)
    if rc is not None:
        return rc
    device = common.resolve_device(args)
    if estimator == "mm":
        return _run_mm(args, gen_cfg, device)
    mesh = common.make_mesh(args)
    if mesh is not None and args.ensemble % mesh.size:
        raise SystemExit(f"--ensemble {args.ensemble} must be divisible by "
                         f"the {mesh.size}-device mesh")
    return _run(args, gen_cfg, device, mesh)


COLUMNS = {
    "wgan": ("d_loss", "g_loss", "wasserstein", "d_accuracy",
             "frac_converged", "frac_diverged", "mean_iters"),
    "mm": ("loss", "mean_err", "cov_err", "rate_penalty", "frac_converged",
           "frac_diverged"),
}


def _columns(estimator):
    pops = ("E", "I")
    return (["step", "member", *COLUMNS[estimator], "train_time"]
            + [f"{blk}_{a}{b}" for blk in ("J", "D", "S")
               for a in pops for b in pops])


def _member_param_columns(gen_cfg, gp_host, m):
    """Flattened J/D/S CSV columns of member ``m``."""
    from tcgan_torch.models import ensemble as ens_lib
    from tcgan_torch.train.recorders import flatten_gen_params

    return flatten_gen_params(ens_lib.member_params(gen_cfg, gp_host, m))


def _stack_member_params(gen_cfg, host_params, K, suffix=""):
    """K-member-stacked J/D/S arrays for ensemble_params.npz."""
    import numpy as np

    from tcgan_torch.models import ensemble as ens_lib

    vals = [ens_lib.member_params(gen_cfg, host_params, m) for m in range(K)]
    return {f"{name}{suffix}": np.stack([np.asarray(v[i]) for v in vals])
            for i, name in enumerate(("J", "D", "S"))}


def _true_params(args):
    import numpy as np

    from tcgan_torch.run import common

    if args.dataset:
        return None
    tj, td, ts = common.resolve_true_params(args)
    return {"J": np.asarray(tj), "D": np.asarray(td), "S": np.asarray(ts)}


def _loop(args, K, estimator, store, states, step_fn, gen_cfg, device,
          ema_of=None, mesh=None):
    """The step loop shared by the estimators: ``step_fn(step, states,
    generator)`` -> (states, metrics) of one step of every member (of this
    rank's members under ``mesh``). Records ensemble.csv rows every
    ``--record-every`` steps (and at the last), accounts for divergence
    every step, checkpoints, then writes the final artifacts."""
    import numpy as np

    from tcgan_torch.models import ensemble as ens_lib
    from tcgan_torch.train.checkpoint import CheckpointManager
    from tcgan_torch.train.datastore import PervasiveDivergenceError
    from tcgan_torch.train.driver import (_GracefulStop, _step_generator,
                                          _sync, device_get)
    from tcgan_torch.train.recorders import CSVRecorder
    from tcgan_torch.utils.stopwatch import StopWatch

    ckpt = CheckpointManager(store.subdir("ckpt"))
    if args.resume and ckpt.latest_step() is not None:
        states = ckpt.restore(states)
    gather = (lambda tree: tree) if mesh is None else mesh.gather_members
    if mesh is not None:
        states = mesh.member_shard(states)
    rec = CSVRecorder(store.file("ensemble.csv"), _columns(estimator))
    watch = StopWatch()
    start = int(states.step)
    if start > 0:
        # resume: drop the replayed window's rows (the stream flushes
        # every record but checkpoints are periodic)
        rec.truncate_from(start)
    generator = _step_generator(args.seed, start, device)
    fields = COLUMNS[estimator]
    divergence_strikes = 0
    status = "finished"
    stop = _GracefulStop()  # SIGTERM finishes the step, then falls
    stop.__enter__()        # through to the summary
    try:
        for step in range(start, start + args.n_steps):
            if stop.requested:
                status = "interrupted"
                break
            with watch.time("train"):
                states, metrics = step_fn(step, states, generator)
                _sync(device)
            record = (step % args.record_every == 0
                      or step == start + args.n_steps - 1)
            # ONE device->host copy per step (all K members on every rank)
            host, gp_host = device_get(gather((
                {f: getattr(metrics, f) for f in fields},
                states.gen_params if record else None)))
            if record:
                for m in range(K):
                    rec.record({"step": step, "member": m,
                                "train_time": watch.last("train"),
                                **{f: float(v[m]) for f, v in host.items()},
                                **_member_param_columns(gen_cfg, gp_host, m)})
            # divergence accounting every REAL step: a record-gated check
            # would abort record_every-fold later than a single fit's GANDriver
            fdiv = float(np.asarray(host["frac_diverged"]).mean())
            if fdiv > args.divergence_abort:
                divergence_strikes += 1
                if divergence_strikes >= args.divergence_patience:
                    raise PervasiveDivergenceError(
                        f"ensemble mean frac_diverged={fdiv:.2f} for "
                        f"{divergence_strikes} steps")
            else:
                divergence_strikes = 0
            if (args.checkpoint_every
                    and (step + 1) % args.checkpoint_every == 0):
                ckpt.save(step + 1, gather(states))
    except PervasiveDivergenceError as e:
        status = f"aborted: {e}"
    finally:
        rec.close()

    states = gather(states)
    ckpt.save(int(states.step), states)
    gp_host, ema_host = device_get((states.gen_params,
                                    None if ema_of is None
                                    else ema_of(states)))
    npz = _stack_member_params(gen_cfg, gp_host, K)
    if ema_host is not None:
        npz.update(_stack_member_params(gen_cfg, ema_host, K, suffix="_ema"))
    summary = ens_lib.ensemble_summary(gen_cfg, gp_host, _true_params(args))
    if store.writer:
        np.savez(store.file("ensemble_params.npz"), **npz)
        with open(store.file("ensemble_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        out = {"status": status, "n_members": K}
        if estimator == "mm":
            out["estimator"] = "mm"
        print(json.dumps({**out, "mean": summary["mean"],
                          "std": summary["std"]}))
    store.finalize(status)
    # Restore the SIGTERM handler only AFTER the summary/params/finalize
    # are on disk: a preemption landing during finalization is the window
    # the graceful stop exists for.
    stop.__exit__()


def _fake_truth(args, gen_cfg, device):
    """The run's dataset and the kernel launches its fake truth took."""
    from tcgan_torch.ops.cuda import ssn_solve
    from tcgan_torch.run import common

    launches0 = ssn_solve.launches
    dataset = common.load_or_generate_dataset(args, gen_cfg, device=device)
    return dataset, ssn_solve.launches - launches0


def _write_info(store, args, entry, K, truth_launches):
    from tcgan_torch.ops.cuda import ssn_solve

    extra = {"kernel_launches_fake_truth": truth_launches}
    if args.solver_backend == "cuda":
        extra["kernel_precision"] = ssn_solve.KERNEL_PRECISION
    store.write_info({"entry": entry, "n_members": K, **vars(args)},
                     extra=extra)


def _run_mm(args, gen_cfg, device) -> int:
    """Multi-start moment matching: K fits (moment-EMA buffers included)
    sharing one dataset's moments, or each with its own dataset
    (``--data-seed-per-member``)."""
    import copy

    import torch

    from tcgan_torch.models import ensemble as ens_lib
    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.models import moments as mm_lib
    from tcgan_torch.run import common
    from tcgan_torch.train.datastore import DataStore

    cfg = mm_lib.MomentMatchingConfig(
        gen=gen_cfg,
        batch_size=args.batch_size,
        lr=args.mm_lr,
        beta1=args.adam_beta1,
        beta2=args.adam_beta2,
        mean_weight=args.mean_weight,
        cov_weight=args.cov_weight,
        rate_cost=args.rate_cost,
        clip_grad=args.clip_grad,
        seed=args.seed,
        fixed_z=args.fixed_z,
        moment_ema=args.moment_ema,
        moment_ema_late=args.moment_ema_late,
        moment_ema_switch_step=args.moment_ema_switch_step,
    )
    K = args.ensemble
    if args.data_seed_per_member:
        # K independent fake-truth draws -> stacked moments (K, F) /
        # (K, F, F): member spread includes the data's sampling variance
        if args.dataset:
            raise SystemExit("--data-seed-per-member requires generated "
                             "fake truth, not --dataset")
        moments, truth = [], 0
        for m in range(K):
            args_m = copy.copy(args)
            args_m.truth_seed = args.truth_seed + m
            dataset, n = _fake_truth(args_m, gen_cfg, device)
            moments.append(dataset.moments())
            truth += n
        data_mean, data_second = (torch.stack(t) for t in zip(*moments))
    else:
        dataset, truth = _fake_truth(args, gen_cfg, device)
        data_mean, data_second = dataset.moments()

    store = DataStore(args.datastore)
    _write_info(store, args, "ensemble_mm", K, truth)
    gen_init = gen_lib.init_params(
        cfg.gen, common.as22(args.J), common.as22(args.D),
        common.as22(args.S), device=device)
    states = ens_lib.init_mm_ensemble(cfg, K, gen_init=gen_init,
                                      start_jitter=args.start_jitter)

    def step_fn(step, states, generator):
        return mm_lib.train_step_impl(cfg, states, data_mean, data_second,
                                      generator=generator)

    _loop(args, K, "mm", store, states, step_fn, cfg.gen, device)
    return 0


def _run(args, gen_cfg, device, mesh=None) -> int:
    import dataclasses

    import torch

    from tcgan_torch.models import cwgan as cwgan_lib
    from tcgan_torch.models import ensemble as ens_lib
    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.models import wgan as wgan_lib
    from tcgan_torch.parallel import make_sharded_ensemble_step
    from tcgan_torch.run import common
    from tcgan_torch.train.datastore import DataStore

    if args.moment_anchor:
        raise SystemExit(
            "--moment-anchor is not supported by the ensemble runner: the "
            "member-stacked state has no anchor Adam/EMA buffers, so members "
            "would silently train WITHOUT the anchor. Drop the flag, or run "
            "K separate tcgan_torch.run.bptt_wgan/bptt_cwgan fits.")

    conditional = bool(args.conditional)
    model = cwgan_lib if conditional else wgan_lib
    data_gen_cfg = (dataclasses.replace(gen_cfg, track_offset_identity=True)
                    if conditional else gen_cfg)
    dataset, truth = _fake_truth(args, data_gen_cfg, device)

    # the critic-input scaling and condition weighting of an
    # identically-flagged single run (the shared helpers of run.gan)
    input_scale, cond_input_scale = common.critic_input_scales(
        args, gen_cfg, dataset, conditional)
    extra_cfg = {}
    if conditional:
        extra_cfg = dict(cond_input_scale=cond_input_scale,
                         cond_weight=common.contrast_cond_weight(
                             args, conditional))
    mk_cfg = cwgan_lib.CWGANConfig if conditional else wgan_lib.WGANConfig
    cfg = mk_cfg(
        gen=gen_cfg,
        input_scale=input_scale,
        critic_lr_decay_steps=args.critic_lr_decay_steps,
        **extra_cfg,
        critic_layers=tuple(args.disc_layers),
        batch_size=args.batch_size,
        gp_lambda=args.gp_lambda,
        n_critic=args.n_critic,
        n_critic0=args.n_critic0,
        lr_gen=args.lr_gen,
        lr_critic=args.lr_critic,
        beta1=args.adam_beta1,
        beta2=args.adam_beta2,
        rate_cost=args.rate_cost,
        clip_grad=args.clip_grad,
        lr_decay_steps=args.lr_decay_steps,
        lr_decay_rate=args.lr_decay_rate,
        ema_decay=args.gen_ema,
        reject_unconverged=args.reject_unconverged,
        seed=args.seed,
    )
    K = args.ensemble

    store = DataStore(args.datastore)
    _write_info(store, args, "ensemble", K, truth)
    gen_init = gen_lib.init_params(
        cfg.gen, common.as22(args.J), common.as22(args.D),
        common.as22(args.S), device=device)
    states = ens_lib.init_ensemble(cfg, K, gen_init=gen_init,
                                   start_jitter=args.start_jitter,
                                   model=model)

    if conditional:
        n = dataset.num_samples
        tagged = cwgan_lib.tag_with_conditions(
            cfg, dataset.tc.reshape(n, cfg.gen.n_stim, cfg.gen.n_probe)
        ).reshape(n, cfg.gen.n_stim, -1)

        def sample_real(generator, n_stacks):
            idx = torch.randint(0, n, (n_stacks, cfg.batch_size),
                                generator=generator, device=tagged.device)
            return tagged[idx].reshape(
                n_stacks, cfg.batch_size * cfg.gen.n_stim, -1)
    else:
        def sample_real(generator, n_stacks):
            return dataset.sample_stack(generator, n_stacks,
                                        cfg.critic_batch)

    train_step = ens_lib.ensemble_train_step
    if mesh is not None:
        train_step = make_sharded_ensemble_step(train_step, mesh)

    def step_fn(step, states, generator):
        n_critic = cfg.n_critic0 if step == 0 else cfg.n_critic
        stacks = sample_real(generator, K * n_critic)
        real = stacks.reshape((K, n_critic) + stacks.shape[1:])
        return train_step(cfg, n_critic, states, real, model=model,
                          generator=generator)

    _loop(args, K, "wgan", store, states, step_fn, cfg.gen, device,
          ema_of=(lambda s: s.ema_params) if cfg.ema_decay > 0 else None,
          mesh=mesh)
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
