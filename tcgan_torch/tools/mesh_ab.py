"""``--parallel mesh`` across every visible card against one card.

Run from the repository root on a machine with several CUDA devices:

    python -m tcgan_torch.tools.mesh_ab [--steps 6] \
        [--batch-sizes 256 1024]

For each batch size, ``run.gan`` at the round-2 configuration (N=51, 8
bandwidths x contrasts 5 and 10, fake truth at the slice's J, D, S, the
start +30% J and -30% D, ``--normalize-input --clip-grad 1.0``, the CUDA
kernel) runs for ``--steps`` steps on one card, then with ``--parallel
mesh`` on every visible card (one spawned NCCL rank each, B/P circuits a
rank), the same seed. Printed: each run's ``train_time`` per step (the
median of steps 1 on) and wall time, the largest relative difference of
the two runs' learning rows (held to rtol 1e-4), with the cards' names and
power limit; then ``tcgan_torch.entry.dryrun_multichip`` on the cards
(NCCL, a batch x model mesh). One JSON line at the end.

With ``--model-axis`` (four cards), the library instead: ``--steps``
round-2 WGAN steps on the kernel at each batch size on a 2 x 2 (batch x
model) NCCL mesh (on the kernel the model group splits the circuits, as
the batch group does), then the same steps on card 0 alone on the same
noise: the generator forward's rates and flags (bit-equal), the final
generator parameters (rtol 1e-4), each run's host ms per step, and the
collectives per step.
"""

from __future__ import annotations

import argparse
import csv
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from tcgan_torch.tools.ssn_solve_ab import (BANDWIDTHS, SLICE_D, SLICE_J,
                                            SLICE_S, card)

RTOL = 1e-4
CLOCKS = {"train_time", "SSsolve_time", "gradient_time"}


def _argv(store: Path, steps: int, batch: int) -> list:
    flat = lambda v: [str(x) for x in v]  # noqa: E731
    return [
        "--device", "cuda", "--solver-backend", "cuda", "--seed", "0",
        "--datastore", str(store), "--N", "51",
        "--bandwidths", *flat(BANDWIDTHS), "--contrasts", "5", "10",
        "--batch-size", str(batch), "--normalize-input", "--clip-grad", "1.0",
        "--true-J", *flat(SLICE_J), "--true-D", *flat(SLICE_D),
        "--true-S", *flat(SLICE_S),
        "--J", *flat(round(1.3 * v, 6) for v in SLICE_J),
        "--D", *flat(round(0.7 * v, 6) for v in SLICE_D),
        "--S", *flat(SLICE_S), "--n-steps", str(steps),
    ]


def _run(argv: list) -> tuple[list, float]:
    from tcgan_torch.run import gan

    t0 = time.perf_counter()
    if gan.main(argv) != 0:
        raise RuntimeError(f"run.gan {' '.join(argv)} failed")
    seconds = time.perf_counter() - t0
    store = Path(argv[argv.index("--datastore") + 1])
    with open(store / "learning.csv", newline="") as f:
        return list(csv.DictReader(f)), seconds


def _model_axis_rank(steps: int, batch: int) -> dict:
    """One rank of the ``--model-axis`` mode (a 2 x 2 mesh of 4 NCCL ranks,
    one per card): ``steps`` round-2 WGAN steps on the kernel, the circuits
    split over both axes; rank 0 then runs them unsharded on its card and
    compares."""
    import dataclasses

    import torch.distributed as dist

    from tcgan_torch import parallel as par
    from tcgan_torch.models import generator as gen_lib
    from tcgan_torch.models import wgan
    from tcgan_torch.ops.cuda import ssn_solve
    from tcgan_torch.ops.ssn import SSNConfig

    dev = torch.device("cuda", torch.cuda.current_device())
    gcfg = gen_lib.GeneratorConfig(
        ssn=SSNConfig(N=51, max_iter=10000, atol=1e-5, check_every=32,
                      backend="cuda"),
        bandwidths=BANDWIDTHS, contrasts=(5.0, 10.0))
    cfg = wgan.WGANConfig(gen=gcfg, batch_size=batch, n_critic=5,
                          n_critic0=5, clip_grad=1.0)
    as22 = lambda v: ((v[0], v[1]), (v[2], v[3]))  # noqa: E731
    params = gen_lib.init_params(gcfg, as22(SLICE_J), as22(SLICE_D),
                                 as22(SLICE_S), device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    state0 = wgan.init_state(cfg, generator=gen, gen_init=params)
    real = 1.0 + 0.1 * torch.randn((5, cfg.critic_batch, gcfg.tc_dim),
                                   generator=gen, device=dev)
    noises = [wgan.draw_step_noise(cfg, 5, real, gen) for _ in range(steps)]
    mesh = par.make_mesh(n_batch=2, n_model=2)
    scfg = dataclasses.replace(cfg, gen=par.with_mesh_axes(gcfg, model=True))

    def run(step, c):
        state, ms = state0, []
        ssn_solve.launches = 0
        for noise in noises:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(c, 5, state, real, noise=noise)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return state, ms, ssn_solve.launches

    def forward(c):
        with torch.no_grad(), par.set_mesh(mesh):
            return gen_lib.sample_tuning_curves(c, params, batch,
                                                z=noises[0].gen_z)

    fwd = forward(scfg.gen)
    mesh.counts.clear()
    state, ms, launches = run(
        par.make_sharded_gan_step(wgan.train_step_impl, mesh), scfg)
    out = {"rank": dist.get_rank(), "mesh_ms": ms, "launches": launches,
           "collectives": {k: v / steps for k, v in mesh.counts.items()}}
    if dist.get_rank() == 0:
        ref = forward(gcfg)
        ref_state, out["one_card_ms"], out["one_card_launches"] = run(
            wgan.train_step_impl, cfg)
        out["max_dr"] = float((fwd.rates - ref.rates).abs().max())
        out["flags_equal"] = all(torch.equal(a, b)
                                 for a, b in zip(fwd[2:], ref[2:]))
        out["rel_params"] = max(
            float((state.gen_params[k] - v).abs().max()
                  / v.abs().max().clamp_min(1e-30))
            for k, v in ref_state.gen_params.items())
    dist.barrier()
    return out


def _model_axis(steps: int, batches) -> int:
    """The ``--model-axis`` mode on four cards; 0 when every check held."""
    from tcgan_torch.parallel import launch

    if torch.cuda.device_count() != 4:
        raise SystemExit("mesh_ab --model-axis needs 4 visible cards (a 2 x "
                         f"2 mesh); {torch.cuda.device_count()} are visible")
    out = {"cards": 4, "card": card(), "steps": steps, "batches": {}}
    ok = True
    for batch in batches:
        ranks = launch.spawn(_model_axis_rank, 4, (steps, batch),
                             backend="nccl",
                             devices=[f"cuda:{i}" for i in range(4)],
                             timeout=600, deadline=1800)
        r0 = ranks[0]
        res = out["batches"][str(batch)] = {
            "mesh_ms_median": statistics.median(r0["mesh_ms"][1:]),
            "one_card_ms_median": statistics.median(r0["one_card_ms"][1:]),
            **{k: r0[k] for k in ("max_dr", "flags_equal", "rel_params",
                                  "one_card_launches")},
            "ranks": ranks}
        for r in ranks:
            print(f"[mesh_ab] model axis B={batch}, rank {r['rank']} of a "
                  f"2 x 2 mesh: host ms per step "
                  f"{', '.join(f'{t:.1f}' for t in r['mesh_ms'])}; kernel "
                  f"launches {r['launches']}; collectives per step "
                  f"{json.dumps(r['collectives'])} ({out['card']})",
                  flush=True)
        print(f"[mesh_ab] model axis B={batch}: median host ms per step "
              f"(steps 1 on) {res['mesh_ms_median']:.1f} on 4 cards against "
              f"{res['one_card_ms_median']:.1f} on card 0 alone; forward "
              f"max |dr| {res['max_dr']}, flags equal {res['flags_equal']}; "
              f"generator parameters after {steps} steps: max rel "
              f"{res['rel_params']:.3e} (rtol {RTOL})", flush=True)
        ok = ok and res["max_dr"] == 0.0 and res["flags_equal"] \
            and res["rel_params"] <= RTOL
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[256, 1024])
    p.add_argument("--model-axis", action="store_true",
                   help="the library's round-2 step on a 2 x 2 mesh with "
                   "a model axis, against card 0 alone")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_ab: no CUDA device is visible")
    if args.model_axis:
        return _model_axis(args.steps, args.batch_sizes)
    from tcgan_torch.entry import dryrun_multichip

    n = torch.cuda.device_count()
    out = {"cards": n, "card": card(), "steps": args.steps, "batches": {}}
    worst = 0.0
    for batch in args.batch_sizes:
        res, runs = out["batches"].setdefault(str(batch), {}), {}
        with tempfile.TemporaryDirectory() as tmp:
            for name, extra in (("one_card", []),
                                ("mesh", ["--parallel", "mesh"])):
                rows, seconds = _run(_argv(Path(tmp) / name, args.steps,
                                           batch) + extra)
                train = [1e3 * float(r["train_time"]) for r in rows[1:]]
                runs[name] = rows
                res[name] = {"train_ms_median": statistics.median(train),
                             "train_ms": train, "seconds": seconds}
                print(f"[mesh_ab] B={batch} {name}: train_time steps "
                      f"1-{len(train)} "
                      f"{', '.join(f'{t:.1f}' for t in train)} ms, median "
                      f"{res[name]['train_ms_median']:.1f} ms; "
                      f"{seconds:.1f} s ({n} visible card(s): "
                      f"{out['card']})", flush=True)
        rel = 0.0
        for a, b in zip(runs["mesh"], runs["one_card"], strict=True):
            for k in a.keys() - CLOCKS:
                x, y = float(a[k]), float(b[k])
                if x != y:
                    rel = max(rel, abs(x - y) / max(abs(y), 1e-12))
        res["max_rel_d_row"] = rel
        worst = max(worst, rel)
        print(f"[mesh_ab] B={batch} learning rows, mesh of {n} against one "
              f"card: max rel difference {rel:.3e} (rtol {RTOL})",
              flush=True)
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_multichip(n)
    out["dryrun"]["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0 if worst <= RTOL else 1


if __name__ == "__main__":
    sys.exit(main())
