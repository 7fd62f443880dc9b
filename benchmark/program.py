"""The system under test, ``tcgan_torch``, built the way its command-line
entry points build it: the cell's configuration and traffic become the
flags of ``run.forward`` or ``run.gan``, parsed by the entry point's own
parser, and the generator and GAN configurations and the state come from
the same calls the entry points make. Everything else is the parsers'
defaults, which are the CLI's default schedule (``--solver-backend cuda``,
two phases, the refinement tail).

Each function here checks that the configuration it made is the one the
cell's file states, so that the program and the reference run the same
circuit.
"""

from __future__ import annotations


def _circuit_flags(config: dict, traffic: dict, values: dict) -> list:
    c = config["circuit"]
    flags = ["--solver-backend", "cuda", "--N", c["N"], "--k", c["k"],
             "--n", c["n"], "--tau-E", c["tau_E"], "--tau-I", c["tau_I"],
             "--dt", c["dt"], "--io_type", c["io_type"],
             "--rate-soft-bound", c["rate_soft_bound"],
             "--rate-hard-bound", c["rate_hard_bound"],
             "--rate-stop-at", c["rate_stop_at"],
             "--smoothness", c["smoothness"],
             "--check-every", c["check_every"], "--atol", traffic["atol"],
             "--max-iter", traffic["max_iter"],
             "--bandwidths", *c["bandwidths"],
             "--contrasts", *traffic["contrasts"],
             "--batch-size", traffic["batch"]]
    for k in ("J", "D", "S"):
        flags += [f"--{k}", *values[k]]
    return [str(f) for f in flags]


def _check(config: dict, traffic: dict, gen_cfg) -> None:
    c, ssn = config["circuit"], gen_cfg.ssn
    want = dict(N=c["N"], k=c["k"], n=c["n"], tau_E=c["tau_E"],
                tau_I=c["tau_I"], dt=c["dt"], io_type=c["io_type"],
                rate_soft_bound=c["rate_soft_bound"],
                rate_stop_at=c["rate_stop_at"], L=c["L"],
                smoothness=c["smoothness"], check_every=c["check_every"],
                atol=traffic["atol"], max_iter=traffic["max_iter"],
                backend="cuda", stepper="euler", init="zero", accel="none")
    got = {k: getattr(ssn, k) for k in want}
    if got != want:
        raise ValueError(f"the program's circuit {got} is not the cell's "
                         f"{want}")
    if (tuple(gen_cfg.bandwidths) != tuple(c["bandwidths"])
            or tuple(gen_cfg.contrasts) != tuple(traffic["contrasts"])
            or gen_cfg.n_probe != 1 or gen_cfg.antithetic):
        raise ValueError("the program's battery or readout is not the cell's")


def forward(config: dict, traffic: dict, device):
    """(generator config, parameters) as ``run.forward`` builds them."""
    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.run import common
    from tcgan_torch.run import forward as forward_cli

    argv = ["--datastore", "unused", "--device", str(device),
            *_circuit_flags(config, traffic, config["truth"])]
    args = forward_cli.make_parser().parse_args(argv)
    gen_cfg = common.generator_config_from_args(args, solver=args.solver)
    _check(config, traffic, gen_cfg)
    params = gen_lib.init_params(gen_cfg, common.as22(args.J),
                                 common.as22(args.D), common.as22(args.S),
                                 device=device)
    return gen_cfg, params


def start_values(config: dict, traffic: dict) -> dict:
    """The generator's starting J, D, S: the truth times the mix's
    ``start_factor``."""
    f = traffic["start_factor"]
    return {k: [v * f[k] for v in config["truth"][k]] for k in ("J", "D", "S")}


def fit(config: dict, traffic: dict, device, tc_data, critic0: dict):
    """(WGAN config, state) as ``run.gan`` builds them from the round-2
    flags: the data ``tc_data`` (a host array) in the role of the fake
    truth, the critic's weights ``critic0`` (the benchmark's draw) in place
    of ``init_state``'s own."""
    from tcgan_torch.data.datasets import TuningCurveDataset
    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.models import wgan
    from tcgan_torch.run import common
    from tcgan_torch.run import gan as gan_cli

    argv = ["--datastore", "unused", "--device", str(device),
            *_circuit_flags(config, traffic, start_values(config, traffic)),
            "--WGAN_n_critic", str(traffic["n_critic"]),
            "--WGAN_lambda", str(traffic["gp_lambda"]),
            "--disc-learn-rate", str(traffic["lr_critic"]),
            "--gen-learn-rate", str(traffic["lr_gen"]),
            "--adam-beta1", str(traffic["beta1"]),
            "--adam-beta2", str(traffic["beta2"]),
            "--rate-cost", str(traffic["rate_cost"]),
            "--clip-grad", str(traffic["clip_grad"]),
            "--disc-layers", *(str(d) for d in config["critic_layers"])]
    if traffic["normalize_input"]:
        argv.append("--normalize-input")
    args = gan_cli.make_parser().parse_args(argv)
    gen_cfg = common.generator_config_from_args(args, solver="ift")
    _check(config, traffic, gen_cfg)
    dataset = TuningCurveDataset.from_array(tc_data, device=device)
    input_scale, _ = common.critic_input_scales(args, gen_cfg, dataset,
                                                conditional=False)
    # run_gan's WGANConfig, keyword for keyword
    cfg = wgan.WGANConfig(
        gen=gen_cfg,
        input_scale=input_scale,
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
    gen_init = gen_lib.init_params(cfg.gen, common.as22(args.J),
                                   common.as22(args.D), common.as22(args.S),
                                   device=device)
    state = wgan.init_state(cfg, gen_init=gen_init)
    critic = {k: v.clone() for k, v in critic0.items()}
    state = state._replace(
        critic_params=critic,
        critic_opt=wgan.make_optimizers(cfg)[1].init(critic))
    return cfg, state
