"""The forward traffic: ``run.forward``'s serving loop.

Batches of ``batch`` circuits go through
``tcgan_torch.models.generator.sample_tuning_curves(gen_cfg, params, B,
z=...)`` back to back under ``torch.inference_mode()``, the call
``run.forward`` loops on, each with its own noise from the seed; one sync
closes the window. ``circuits_per_s`` is every circuit issued in the window
(all finished by that sync) over the window's seconds.

``correct``: a sample of the window's batches, drawn from the seed
(reservoir sampling over the batches as they are issued), is solved again
by the reference after the window, and compared row by row:

- ``flags_differ``: rows whose converged or diverged flag differs;
- ``resid_ratio``: the largest float64 residual max_i |f(W r + I)_i - r_i|
  of a row the program calls converged, at the program's rates, over atol;
- ``tc_gap``: the widest gap between the program's and the reference's
  tuning curves, over rows both call converged, as a share of the largest
  reference tuning-curve value.
"""

from __future__ import annotations

import contextlib
import random
import time

import torch

from benchmark import count, inputs, trace
from benchmark import program as program_lib
from benchmark.reference import ssn


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        plant=None):
    """Set up, measure, check; returns (e2e metrics, per-layer trace or
    None, readings, attempted, memory peak). ``plant`` (tests and
    calibration): a context manager that breaks the program while it runs."""
    config, traffic = cell.config, cell.traffic
    circuit = config["circuit"]
    B, N = traffic["batch"], circuit["N"]
    gen_cfg, params = program_lib.forward(config, traffic, device)
    from tcgan_torch.models import generator as gen_lib

    draws = inputs.Draws(seed, device)

    def batch(*keys):
        return gen_lib.sample_tuning_curves(
            gen_cfg, params, B, z=draws.circuit_z(B, N, *keys))

    keep = traffic["checked_batches"]
    sample = random.Random(inputs.derive(seed, "sample"))
    kept, summary = [], None
    with torch.inference_mode(), (plant or contextlib.nullcontext)():
        for i in range(traffic["warm_batches"]):
            batch("warm", i)
        _sync(device)
        if traced:
            n_traced = traffic["traced_batches"]
            with trace.profiler() as prof:
                with torch.profiler.record_function(trace.SLICE):
                    for i in range(n_traced):
                        batch("trace", i)
                    _sync(device)
            summary = trace.summarize(prof)
        start = time.perf_counter()
        n = 0
        while time.perf_counter() - start < seconds:
            out = batch("window", n)
            if n < keep:
                kept.append((n, out))
            else:
                j = sample.randrange(n + 1)
                if j < keep:
                    kept[j] = (n, out)
            n += 1
        _sync(device)
        end = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    e2e = {"setup_s": start - t0, "circuits_per_s": n * B / (end - start)}
    del out
    readings = check(config, traffic, seed, device, kept)
    del kept
    per_layer = None
    if traced:
        per_layer = {"kind": "forward", "slice": summary,
                     "batches": n_traced,
                     **traced_count(config, traffic, seed, device,
                                    [("trace", i) for i in range(n_traced)])}
    return e2e, per_layer, readings, n, peak


def _reference(config, traffic, draws, keys_list):
    """The reference's (W, I, rates, converged, diverged, iters) of the
    batches drawn under each of ``keys_list``, solved together."""
    circuit, B = config["circuit"], traffic["batch"]
    z = torch.cat([draws.circuit_z(B, circuit["N"], *k) for k in keys_list])
    W, I = ssn.circuit_inputs(circuit, *(config["truth"][k]
                                         for k in ("J", "D", "S")),
                              z, traffic["contrasts"])
    del z
    out = ssn.solve(circuit, W, I, atol=traffic["atol"],
                    max_iter=traffic["max_iter"],
                    check_every=circuit["check_every"])
    return (W, I) + tuple(out)


def check(config, traffic, seed, device, kept, block: int = 4):
    """The readings of ``correct`` over the kept batches ``[(index,
    output)]``, the reference solving ``block`` batches at a time."""
    ssn.full_fp32()
    circuit, B = config["circuit"], traffic["batch"]
    draws = inputs.Draws(seed, device)
    flags = 0
    resid = gap = 0.0
    with torch.no_grad():
        for lo in range(0, len(kept), block):
            part = kept[lo:lo + block]
            W, I, r, conv, div, _ = _reference(
                config, traffic, draws, [("window", i) for i, _ in part])
            out_r = torch.cat([o.rates for _, o in part]).float()
            out_c = torch.cat([o.converged for _, o in part])
            out_d = torch.cat([o.diverged for _, o in part])
            out_tc = torch.cat([o.tc for _, o in part]).float()
            out_tc = out_tc.reshape(len(part) * B, -1)
            flags += int(((out_c != conv) | (out_d != div)).sum())
            res = ssn.residual64(circuit, W, I, out_r)
            if bool(out_c.any()):
                resid = max(resid, float(res[out_c].max()) / traffic["atol"])
            both = out_c & conv
            ref_tc = ssn.tuning_curves(circuit, r)
            scale = float(ref_tc.abs().max())
            if bool(both.any()) and scale > 0:
                gap = max(gap, float((out_tc - ref_tc).abs()[both].max())
                          / scale)
            del W, I, r
    return {"flags_differ": flags, "resid_ratio": resid, "tc_gap": gap}


def traced_count(config, traffic, seed, device, keys_list, block: int = 8):
    """ops, bytes and least seconds of the solves of the batches drawn
    under ``keys_list``, from the reference's substeps on those inputs."""
    ssn.full_fp32()
    circuit, B = config["circuit"], traffic["batch"]
    n2, S = 2 * circuit["N"], len(circuit["bandwidths"]) * len(
        traffic["contrasts"])
    draws = inputs.Draws(seed, device)
    ops = nbytes = least = 0.0
    with torch.no_grad():
        for lo in range(0, len(keys_list), block):
            part = keys_list[lo:lo + block]
            iters = _reference(config, traffic, draws, part)[-1]
            for b in range(len(part)):
                o = count.solve_ops(n2, float(iters[b * B:(b + 1) * B]
                                              .double().sum()))
                m = count.solve_bytes(B, S, n2)
                ops, nbytes = ops + o, nbytes + m
                least += count.least_seconds(o, m)
    return {"ops": ops, "bytes": nbytes, "least_s": least}
