"""Shared main() logic of the WGAN-family entry points.

Port of :mod:`tcgan_tpu.run.gan_common`: load or generate the real data,
build the WGAN or conditional-WGAN config, init or resume the state and run
the driver, with the fixed-point (``ift``) or the unrolled Euler (``bptt``)
solver. Under ``--parallel mesh`` every rank runs this body: each makes the
same real data, the generator's circuits split over the ranks (the step's
mesh axes) and the run directory is rank 0's.
"""

from __future__ import annotations

import argparse

import torch

from tcgan_torch.run import common


def make_gan_parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_ssn_flags(p)
    common.add_stimulus_flags(p)
    common.add_gan_flags(p)
    common.add_data_flags(p)
    common.add_run_flags(p)
    return p


def run_gan(args, solver: str, conditional: bool) -> int:
    import dataclasses

    from tcgan_torch.models import cwgan as cwgan_lib
    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.models import wgan as wgan_lib
    from tcgan_torch.ops.cuda import ssn_solve
    from tcgan_torch.parallel import set_mesh, with_mesh_axes
    from tcgan_torch.train.checkpoint import CheckpointManager
    from tcgan_torch.train.datastore import DataStore
    from tcgan_torch.train.driver import DriverConfig, GANDriver
    from tcgan_torch.utils.profiling import maybe_trace

    device = common.resolve_device(args)
    mesh = common.make_mesh(args)
    gen_cfg = common.generator_config_from_args(args, solver=solver)
    if getattr(args, "bptt_checkpoint_chunk", 0):
        gen_cfg = dataclasses.replace(
            gen_cfg, bptt_checkpoint_chunk=args.bptt_checkpoint_chunk)
    model = cwgan_lib if conditional else wgan_lib

    # real data first (also needed for the input-normalization scale); the
    # conditional critic's data is the joint per-circuit layout
    data_gen_cfg = gen_cfg
    if conditional:
        data_gen_cfg = dataclasses.replace(gen_cfg,
                                           track_offset_identity=True)
    launches0 = ssn_solve.launches
    dataset = common.load_or_generate_dataset(args, data_gen_cfg,
                                              device=device)
    truth_launches = ssn_solve.launches - launches0
    input_scale, cond_input_scale = common.critic_input_scales(
        args, gen_cfg, dataset, conditional)
    extra_cfg = {}
    if conditional:
        extra_cfg = dict(cond_input_scale=cond_input_scale,
                         cond_weight=common.contrast_cond_weight(
                             args, conditional))
    mk_cfg = cwgan_lib.CWGANConfig if conditional else wgan_lib.WGANConfig
    cfg = mk_cfg(
        gen=gen_cfg if mesh is None else with_mesh_axes(gen_cfg),
        input_scale=input_scale,
        **extra_cfg,
        critic_lr_decay_steps=args.critic_lr_decay_steps,
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
        gen_lr_floor=args.gen_lr_floor,
        gen_lr_switch_step=args.gen_lr_switch_step,
        gen_lr_switch_residual=args.gen_lr_switch_residual,
        gen_lr_switch_min_step=args.gen_lr_switch_min_step,
        ema_decay=args.gen_ema,
        reject_unconverged=args.reject_unconverged,
        moment_anchor=args.moment_anchor,
        moment_ema=args.anchor_ema,
        anchor_ema_late=args.anchor_ema_late,
        anchor_ema_switch_step=args.anchor_ema_switch_step,
        anchor_ema_switch_drift=args.anchor_ema_switch_drift,
        anchor_ema_switch_vel=args.anchor_ema_switch_vel,
        anchor_drift_ema=args.anchor_drift_ema,
        anchor_beta1=args.anchor_beta1,
        anchor_updates=args.anchor_updates,
        seed=args.seed,
    )

    sampler = dataset.sample_stack
    if conditional:
        # tagged once; sampling keeps each circuit's condition block
        n = dataset.num_samples
        tagged = cwgan_lib.tag_with_conditions(
            cfg, dataset.tc.reshape(n, cfg.gen.n_stim, cfg.gen.n_probe)
        ).reshape(n, cfg.gen.n_stim, -1)

        def sampler(generator, n_stacks, _batch):
            idx = torch.randint(0, n, (n_stacks, cfg.batch_size),
                                generator=generator, device=tagged.device)
            return tagged[idx].reshape(
                n_stacks, cfg.batch_size * cfg.gen.n_stim, -1)

    store = DataStore(args.datastore)
    extra = {"kernel_launches_fake_truth": truth_launches}
    if args.solver_backend == "cuda":
        extra["kernel_precision"] = ssn_solve.KERNEL_PRECISION
    store.write_info({"entry": "cwgan" if conditional else "wgan",
                      "solver": solver, **vars(args)}, extra=extra)
    driver_cfg = DriverConfig(
        n_steps=args.n_steps,
        checkpoint_every=args.checkpoint_every,
        tc_mean_every=args.tc_mean_every,
        timing_every=args.timing_every,
        divergence_abort=args.divergence_abort,
        divergence_patience=args.divergence_patience,
        seed=args.seed,
        adaptive_max_iter=(args.adaptive_max_iter == "on"),
        adaptive_margin=args.adaptive_margin,
    )
    gen_init = gen_lib.init_params(
        cfg.gen, common.as22(args.J), common.as22(args.D),
        common.as22(args.S), device=device)
    state = model.init_state(
        cfg, gen_init=gen_init,
        data_moments=dataset.moments() if cfg.moment_anchor > 0 else None)
    ckpt = CheckpointManager(store.subdir("ckpt"))
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
    driver = GANDriver(cfg, driver_cfg, store, model.train_step, state,
                       sampler, checkpoints=ckpt,
                       gen_loss_fn=model.gen_loss_fn)
    with maybe_trace(args.profile_dir), set_mesh(mesh):
        driver.run()
    return 0
