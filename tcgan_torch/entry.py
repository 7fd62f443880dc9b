"""Entry points of the compile check and the multichip dryrun: the port's
twin of ``__graft_entry__.py``.

- :func:`entry`: the flagship forward (the SSN tuning-curve generator at
  N=51, 32 circuits, fixed-point solve, then the WGAN critic's scores) and
  its example arguments.
- :func:`dryrun_multichip`: one WGAN-GP train step over an n-rank (batch x
  model) mesh on tiny shapes (N=8), the circuit batch over the batch axis
  and W's columns over a model axis of 2 when n is even and at least 4; it
  covers the moment anchor (2 updates) and the drift-latched late gamma
  under the mesh, and prints the reference's ``dryrun_multichip OK`` line.
  It runs one NCCL rank per card unless the caller asks for gloo ranks on
  the CPU.

Usage::

    python -c "from tcgan_torch.entry import dryrun_multichip; \\
        dryrun_multichip(4)"                  # 4 cards
    python -c "from tcgan_torch.entry import dryrun_multichip; \\
        dryrun_multichip(4, device='cpu')"    # 4 CPU processes
"""

from __future__ import annotations

import torch


def entry(device="cuda"):
    """(forward, example_args): ``forward(gen_params, critic_params,
    generator)`` -> (critic scores, tuning curves, converged flags) of one
    32-circuit batch on ``device`` (the card unless the caller asks for the
    CPU; no fallback)."""
    from tcgan_torch.models import critic as critic_lib
    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.models import wgan as wgan_lib
    from tcgan_torch.models.generator import GeneratorConfig
    from tcgan_torch.ops.ssn import SSNConfig

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device is visible (pass "
                           "device='cpu' to run on the CPU)")
    gen_cfg = GeneratorConfig(ssn=SSNConfig(N=51, max_iter=4000, atol=1e-5),
                              sample_sites=1, solver="ift")
    cfg = wgan_lib.WGANConfig(gen=gen_cfg, batch_size=32)
    state = wgan_lib.init_state(cfg, device=device)

    def forward(gen_params, critic_params, generator):
        out = gen_lib.sample_tuning_curves(cfg.gen, gen_params,
                                           cfg.batch_size,
                                           generator=generator)
        scores = critic_lib.apply(cfg.critic_cfg, critic_params, out.tc)
        return scores, out.tc, out.converged

    example_args = (state.gen_params, state.critic_params,
                    torch.Generator(device).manual_seed(0))
    return forward, example_args


def _dryrun_rank(n_model: int) -> dict:
    """One rank's step of :func:`dryrun_multichip`: the reference's tiny
    config (``__graft_entry__.py``) on a fresh mesh."""
    import torch.distributed as dist

    from tcgan_torch import parallel as par
    from tcgan_torch.models import wgan as wgan_lib
    from tcgan_torch.models.generator import GeneratorConfig
    from tcgan_torch.models.moments import data_moments
    from tcgan_torch.ops.ssn import SSNConfig

    n = dist.get_world_size()
    mesh = par.make_mesh(n_batch=n // n_model, n_model=n_model)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    gen_cfg = GeneratorConfig(
        ssn=SSNConfig(N=8, max_iter=200, atol=1e-4, dt=0.001),
        bandwidths=(0.25, 1.0), contrasts=(5.0,), sample_sites=1,
        solver="ift", mesh_axis=par.BATCH_AXIS,
        model_axis=par.MODEL_AXIS if n_model > 1 else None)
    cfg = wgan_lib.WGANConfig(
        gen=gen_cfg, critic_layers=(16, 16),
        batch_size=2 * (n // n_model),  # divisible by the batch axis
        n_critic=2, n_critic0=2,
        # the flagship's moment anchor with 2 updates under the mesh (the
        # batch moments come from the gathered batch, the EMA buffers are
        # replicated) and the drift-latched late gamma
        moment_anchor=1e-3, anchor_updates=2, anchor_ema_late=0.98,
        anchor_ema_switch_drift=0.25)
    step = par.make_sharded_gan_step(wgan_lib.train_step_impl, mesh)
    gen = torch.Generator(device).manual_seed(1)
    fake_tc = 0.1 * torch.randn((64, gen_cfg.tc_dim), generator=gen,
                                device=device) + 1.0
    state = wgan_lib.init_state(cfg, data_moments=data_moments(fake_tc),
                                device=device)
    gen = torch.Generator(device).manual_seed(0)
    real_stack = 0.1 * torch.randn(
        (cfg.n_critic, cfg.critic_batch, gen_cfg.tc_dim), generator=gen,
        device=device) + 1.0
    new_state, metrics = step(cfg, cfg.n_critic, state, real_stack,
                              generator=gen)
    return {"mesh": dict(mesh.shape), "step": new_state.step,
            "d_loss": float(metrics.d_loss), "g_loss": float(metrics.g_loss),
            "collectives": dict(mesh.counts)}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One sharded WGAN-GP step on ``n_devices`` ranks: one NCCL rank per
    card with ``device="cuda"`` (raises when fewer cards are visible), gloo
    ranks on the CPU with ``device="cpu"``. Raises unless every rank took
    step 1 with finite, equal losses; prints the OK line and returns rank
    0's result."""
    from tcgan_torch.parallel import launch

    n_model = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    if device == "cuda":
        visible = (torch.cuda.device_count() if torch.cuda.is_available()
                   else 0)
        if visible < n_devices:
            raise RuntimeError(
                f"dryrun_multichip: {n_devices} ranks need {n_devices} CUDA "
                f"devices, {visible} visible (pass device='cpu' for gloo "
                "ranks on the CPU)")
        kw = dict(backend="nccl",
                  devices=[f"cuda:{i}" for i in range(n_devices)])
    elif device == "cpu":
        kw = dict(backend="gloo")
    else:
        raise ValueError(f"dryrun_multichip: device {device!r} is not "
                         "'cuda' or 'cpu'")
    ranks = launch.spawn(_dryrun_rank, n_devices, (n_model,), **kw)
    first = ranks[0]
    if first["step"] != 1:
        raise RuntimeError(f"dryrun_multichip: step {first['step']}, not 1")
    for name in ("d_loss", "g_loss"):
        values = [r[name] for r in ranks]
        if not all(v == v and abs(v) != float("inf") for v in values):
            raise RuntimeError(f"dryrun_multichip: {name} {values}")
        if len(set(values)) != 1:
            raise RuntimeError(f"dryrun_multichip: ranks disagree on {name}"
                               f" {values}")
    print(f"dryrun_multichip OK: mesh={first['mesh']}, "
          f"d_loss={first['d_loss']:.4f}, g_loss={first['g_loss']:.4f}",
          flush=True)
    return first
