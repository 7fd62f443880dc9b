"""The fit traffic: the round-2 fixed-point WGAN-GP step, step after step.

Each step is ``tcgan_torch.models.wgan.train_step(cfg, n_critic, state,
real, noise=...)`` with ``cfg`` and ``state`` made as ``run.gan`` makes them
(:func:`benchmark.program.fit`), its real rows and noise drawn from the seed
(:meth:`benchmark.inputs.Draws.step`). A step's wall time is taken on the
host from the end of the previous step to the device sync that ends this
one (the training driver syncs each step the same way). ``step_ms`` is the
window's seconds over its steps, ``step_ms_p95`` the 95th percentile of
the steps' times.

The window's work does not depend on the program's speed: every
``window_cycle`` steps it starts again from the state set-up handed it,
with the same inputs, so a faster program runs more of the same cycle and
not further into the fit, where the critic matures and the adjoint needs
more iterations.

``correct``: set-up runs the first ``checked_steps`` steps through the same
call and feed (their real rows all differ), then more warm steps, and hands
the same state to the window. After the window the reference
(:mod:`benchmark.reference.wgan`) runs those first steps from the same
inputs, and the run reads (``limits/<cell>.json`` names those compared):

- ``w_gap0``: the first critic update's Wasserstein estimate, |program -
  reference| / |reference|;
- ``loss_gap``: every critic loss and generator loss of those steps, the
  widest |program - reference| against the larger of the reference's
  |loss| and the median |loss| (``loss_gap0``, ``loss_gap1``: the first
  loss, the first step's);
- ``grad_gap``: Adam's first moment after step 1, for the generator (1 -
  beta1) times its first clipped gradient, per leaf: the widest gap
  between the program's norm and the reference's, against the larger of
  the reference's norm of that leaf and of the median leaf, generator and
  critic leaves each against their own median;
- ``change_gap``: the same of each leaf's change over the checked steps
  (Adam's updates themselves: their step size, bias correction and second
  moment; being a norm, not their sign).

Leaves whose reference moment is under a thousandth of their group's
median leaf (the critic's output bias, whose gradient cancels) are left
out of both.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import count, inputs, trace
from benchmark import program as program_lib
from benchmark.reference import ssn
from benchmark.reference import wgan as ref_wgan

CACHE = Path(__file__).resolve().parent / "_cache"
LEAF_FLOOR = 1e-3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _truth_key(config, traffic, device) -> str:
    key = json.dumps([config["circuit"], config["truth"],
                      traffic["contrasts"], traffic["atol"],
                      traffic["max_iter"], traffic["truth_circuits"],
                      traffic["truth_seed"], traffic["truth_block"],
                      torch.device(device).type], sort_keys=True)
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def truth_data(config, traffic, device, cache=None, write=True):
    """(the real data, seconds the reference spent solving it): the data,
    (truth_circuits, S), are tuning curves of circuits at the
    configuration's true J, D, S, solved by the reference (noise from
    ``truth_seed``), circuits with any unconverged condition dropped; kept
    in ``cache`` after the first run, which alone solves (0 seconds
    after)."""
    path = Path(cache or CACHE) / f"truth-{_truth_key(config, traffic, device)}.npy"
    if path.exists():
        return np.load(path), 0.0
    t0 = time.perf_counter()
    ssn.full_fp32()
    circuit, M = config["circuit"], traffic["truth_circuits"]
    block = traffic["truth_block"]
    draws = inputs.Draws(traffic["truth_seed"], device)
    rows, n, b = [], 0, 0
    with torch.no_grad():
        while n < M:
            if b > 4 * M // block + 20:
                raise RuntimeError(f"the true circuit gave {n} of {M} "
                                   "converged circuits")
            z = draws.circuit_z(block, circuit["N"], "truth", b)
            W, I = ssn.circuit_inputs(circuit, *(config["truth"][k] for k
                                                 in ("J", "D", "S")),
                                      z, traffic["contrasts"])
            r, conv, _, _ = ssn.solve(circuit, W, I, atol=traffic["atol"],
                                      max_iter=traffic["max_iter"],
                                      check_every=circuit["check_every"])
            good = ssn.tuning_curves(circuit, r)[conv.all(dim=-1)]
            rows.append(good.cpu())
            n += good.shape[0]
            b += 1
    data = torch.cat(rows)[:M].numpy()
    seconds = time.perf_counter() - t0
    if write:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            np.save(f, data)
        os.replace(tmp, path)
    return data, seconds


def _dims(config, traffic):
    S = len(config["circuit"]["bandwidths"]) * len(traffic["contrasts"])
    return [S, *config["critic_layers"], 1]


def program_run(cell, seed, seconds, traced, device, t0, plant=None):
    """The program's side: set-up, the checked steps, the traced slice, the
    window. Returns a dict of what the run measured and kept."""
    from tcgan_torch.models import wgan
    from tcgan_torch.ops import ift
    from tcgan_torch.ops.cuda import ssn_solve

    config, traffic = cell.config, cell.traffic
    N, n_critic = config["circuit"]["N"], traffic["n_critic"]
    tc_data, truth_s = truth_data(config, traffic, device)
    if truth_s:
        print(f"[bench] the reference solved the real data: {truth_s:.1f} s "
              "(not set-up)", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    draws = inputs.Draws(seed, device)
    critic0 = inputs.Draws(traffic["critic_seed"], device).critic_init(
        _dims(config, traffic))
    cfg, state = program_lib.fit(config, traffic, device, tc_data, critic0)
    tc_dev = torch.as_tensor(tc_data, device=device)

    def step(state, t):
        real, cz, eps, gz = draws.step(t, traffic, N, tc_dev)
        return wgan.train_step(cfg, n_critic, state, real,
                               noise=wgan.StepNoise(cz, eps, gz))

    kept = {"init": state, "losses": [], "ws": []}
    times, per_layer = [], None
    with (plant or contextlib.nullcontext)():
        for t in range(traffic["checked_steps"]):
            state, m = step(state, t)
            kept["losses"] += [m.d_loss_iters, m.g_loss.reshape(1)]
            kept["ws"].append(m.wasserstein_iters)
            if t == 0:
                kept["step1"] = state
        kept["last"] = state
        t = traffic["checked_steps"]
        for _ in range(traffic["warm_steps"]):
            state, _ = step(state, t)
            t += 1
        _sync(device)
        if traced:
            snaps = []
            counts0 = (ift.adjoint_iterations, ssn_solve.launches)
            with trace.profiler() as prof:
                with torch.profiler.record_function(trace.SLICE):
                    for _ in range(traffic["traced_steps"]):
                        snaps.append((t, state.gen_params))
                        state, _ = step(state, t)
                        t += 1
                    _sync(device)
            t_sum = time.perf_counter()
            per_layer = {
                "kind": "fit", "steps": len(snaps),
                "slice": trace.summarize(
                    prof, spans=("ift.adjoint", "wgan.critic_update")),
                "counters": {
                    "adjoint_iterations": ift.adjoint_iterations - counts0[0],
                    "launches": ssn_solve.launches - counts0[1]},
                "snaps": snaps}
            print(f"[bench] the trace's summary: "
                  f"{time.perf_counter() - t_sum:.1f} s", file=sys.stderr)
        base, t_base, cycle = state, t, traffic["window_cycle"]
        start = last = time.perf_counter()
        while last - start < seconds:
            i = len(times) % cycle
            state, _ = step(base if i == 0 else state, t_base + i)
            _sync(device)
            now = time.perf_counter()
            times.append(now - last)
            last = now
        end = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return {"kept": kept, "times": times, "start": start, "end": end,
            "truth_s": truth_s, "peak": peak, "per_layer": per_layer, "tc_data": tc_data,
            "critic0": critic0, "cfg": cfg}


def e2e_metrics(res, t0):
    times = res["times"]
    if not times:
        raise RuntimeError("the window completed no step")
    return {"setup_s": res["start"] - t0 - res["truth_s"],
            "step_ms": 1e3 * (res["end"] - res["start"]) / len(times),
            "step_ms_p95": 1e3 * float(np.percentile(times, 95))}


def reference_steps(config, traffic, seed, device, tc_data, critic0,
                    precision="fp32"):
    """The reference's first ``checked_steps`` steps from the benchmark's
    inputs: (losses, Wasserstein estimates, state after step 1, state after
    the last, state 0)."""
    ssn.full_fp32()
    circuit, N = config["circuit"], config["circuit"]["N"]
    fit = dict(traffic)
    draws = inputs.Draws(seed, device)
    x = ssn.site_positions(N, circuit["L"], device)
    I = ssn.battery(circuit["bandwidths"], traffic["contrasts"], x,
                    circuit["smoothness"])
    tc = torch.as_tensor(tc_data, device=device)
    scale = ref_wgan.input_scale(tc) if traffic["normalize_input"] else None
    st0 = st = ref_wgan.init_state(program_lib.start_values(config, traffic),
                                   critic0)
    losses, ws, st1 = [], [], None
    for t in range(traffic["checked_steps"]):
        real, cz, eps, gz = draws.step(t, traffic, N, tc)
        st, ls, w, _ = ref_wgan.step(circuit, fit, st, real, (cz, eps, gz),
                                     I, scale, precision)
        losses += [float(v) for v in ls]
        ws += [float(v) for v in w]
        if t == 0:
            st1 = st
    return losses, ws, st1, st, st0


def _leaf_gaps(prog: dict, ref: dict, keep) -> list:
    """|program's leaf norm - reference's| against the larger of the
    reference's norm of the leaf and of the median leaf, for each leaf of
    ``keep``."""
    pn, rn = ref_wgan.leaf_norms(prog), ref_wgan.leaf_norms(ref)
    med = statistics.median(rn[k] for k in keep)
    return [abs(pn[k] - rn[k]) / max(rn[k], med) for k in keep]


def _loss_gap(pl, rl) -> float:
    if len(pl) != len(rl):
        return math.inf
    med = statistics.median(abs(v) for v in rl)
    return max(abs(p - r) / max(abs(r), med) for p, r in zip(pl, rl))


def compare(prog: dict, ref: dict, per_step: int) -> dict:
    """The readings of ``correct`` from the two sides' ``losses`` (list of
    floats, ``per_step`` a step), ``moment1`` and ``change`` ({"gen": {leaf:
    tensor}, "critic": {...}}), ``ws`` (the critic updates' Wasserstein
    estimates): ``w_gap0`` of the first estimate and ``loss_gap0`` of the
    first critic loss (before any update), ``loss_gap1`` over the first
    step's losses,
    ``loss_gap`` over every checked step's, ``grad_gap``, ``change_gap``
    (the worst leaf) and ``change_gap_median`` (the median leaf)."""
    pl, rl = prog["losses"], ref["losses"]
    out = {"w_gap0": abs(prog["ws"][0] - ref["ws"][0]) / abs(ref["ws"][0]),
           "loss_gap0": abs(pl[0] - rl[0]) / abs(rl[0]),
           "loss_gap1": _loss_gap(pl[:per_step], rl[:per_step]),
           "loss_gap": _loss_gap(pl, rl)}
    grad, change, change_med = [], [], []
    for group in ("gen", "critic"):
        norms = ref_wgan.leaf_norms(ref["moment1"][group])
        med = statistics.median(norms.values())
        keep = [k for k, v in norms.items() if v >= LEAF_FLOOR * med]
        grad.append(max(_leaf_gaps(prog["moment1"][group],
                                   ref["moment1"][group], keep)))
        gaps = _leaf_gaps(prog["change"][group], ref["change"][group], keep)
        change.append(max(gaps))
        change_med.append(statistics.median(gaps))
    out.update(grad_gap=max(grad), change_gap=max(change),
               change_gap_median=max(change_med))
    return out


def program_side(kept) -> dict:
    """The program's losses, first moments and changes from what the run
    kept."""
    losses = [float(v) for v in torch.cat(
        [t.reshape(-1).double() for t in kept["losses"]]).cpu()]
    init, step1, last = kept["init"], kept["step1"], kept["last"]
    ws = [float(v) for v in torch.cat(
        [t.reshape(-1).double() for t in kept["ws"]]).cpu()]
    return {"losses": losses, "ws": ws,
            "moment1": {"gen": step1.gen_opt.mu, "critic": step1.critic_opt.mu},
            "change": {"gen": {k: last.gen_params[k] - init.gen_params[k]
                               for k in init.gen_params},
                       "critic": {k: last.critic_params[k]
                                  - init.critic_params[k]
                                  for k in init.critic_params}}}


def reference_side(losses, ws, st1, st, st0) -> dict:
    return {"losses": losses, "ws": ws,
            "moment1": {"gen": st1.gen_opt.mu, "critic": st1.critic_opt.mu},
            "change": {"gen": {k: st.gen[k] - st0.gen[k] for k in st0.gen},
                       "critic": {k: st.critic[k] - st0.critic[k]
                                  for k in st0.critic}}}


def check(cell, seed, device, res, precision="fp32") -> dict:
    config, traffic = cell.config, cell.traffic
    ref = reference_side(*reference_steps(config, traffic, seed, device,
                                          res["tc_data"], res["critic0"],
                                          precision))
    return compare(program_side(res["kept"]), ref,
                   traffic["n_critic"] + 1)


def traced_count(cell, seed, device, snaps):
    """Operations of the profiled steps from the reference's substeps on
    the same inputs: (ops of the solves, least seconds of them)."""
    ssn.full_fp32()
    config, traffic = cell.config, cell.traffic
    circuit, N = config["circuit"], config["circuit"]["N"]
    n2 = 2 * N
    S = len(circuit["bandwidths"]) * len(traffic["contrasts"])
    draws = inputs.Draws(seed, device)
    x = ssn.site_positions(N, circuit["L"], device)
    I = ssn.battery(circuit["bandwidths"], traffic["contrasts"], x,
                    circuit["smoothness"])
    ops = least = 0.0
    with torch.no_grad():
        for t, gen in snaps:
            J, D, S_ = (torch.exp(gen[k].float()) for k in ("J", "D", "S"))
            zs = [draws.circuit_z(traffic["batch"], N, "critic", t, i)
                  for i in range(traffic["n_critic"])]
            zs.append(draws.circuit_z(traffic["batch"], N, "gen", t))
            for z in zs:
                W = ssn.weights(J, D, S_, z, x)
                iters = ssn.solve(circuit, W, I, atol=traffic["atol"],
                                  max_iter=traffic["max_iter"],
                                  check_every=circuit["check_every"])[-1]
                o = count.solve_ops(n2, float(iters.double().sum()))
                ops += o
                least += count.least_seconds(
                    o, count.solve_bytes(z.shape[0], S, n2))
    return ops, least


def shared_ops(cell, steps: int) -> float:
    """Operations of the profiled steps outside the forward solves: the
    implicit backward and the critic's work."""
    config, traffic = cell.config, cell.traffic
    n2 = 2 * config["circuit"]["N"]
    S = len(config["circuit"]["bandwidths"]) * len(traffic["contrasts"])
    dims, B = _dims(config, traffic), traffic["batch"]
    per = (count.adjoint_ops(B * S, n2)
           + traffic["n_critic"] * count.critic_update_ops(B, dims)
           + count.generator_loss_ops(B, dims))
    return steps * per


def run(cell, seed, seconds, traced, device, t0, plant=None):
    """Set up, measure, check; returns (e2e, per-layer trace or None,
    readings, attempted, memory peak)."""
    res = program_run(cell, seed, seconds, traced, device, t0, plant)
    e2e = e2e_metrics(res, t0)
    per_layer = res["per_layer"]
    snaps = per_layer.pop("snaps") if per_layer else None
    t = time.perf_counter()
    readings = check(cell, seed, device, res)
    print(f"[bench] the reference's steps: {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    if per_layer:
        t = time.perf_counter()
        ops, least = traced_count(cell, seed, device, snaps)
        print(f"[bench] the traced count: {time.perf_counter() - t:.1f} s",
              file=sys.stderr)
        per_layer.update(least_s=least,
                         ops=ops + shared_ops(cell, len(snaps)))
    return e2e, per_layer, readings, len(res["times"]), res["peak"]
