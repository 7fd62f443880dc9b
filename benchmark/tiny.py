"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
the benchmark's own tests: the same files with a small batch and, unless
``widths`` is kept, a small circuit, battery and critic. Their limits stay
the cell's."""

from __future__ import annotations

import copy

from benchmark import harness


def cell(name: str, batch: int | None = None, widths: bool = False):
    c = harness.Cell(name)
    config, traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    if not widths:
        config["circuit"]["N"] = 8
        config["circuit"]["bandwidths"] = [0.5, 1.0]
        config["critic_layers"] = [8, 8]
        traffic["max_iter"] = 2000
    if traffic["kind"] == "fit":
        traffic["batch"] = batch or 4
        traffic["truth_circuits"] = 3 * traffic["n_critic"] * traffic["batch"]
        traffic["truth_block"] = 32
        traffic["traced_steps"] = 1
    else:
        traffic["batch"] = batch or 4
        traffic["checked_batches"] = 2
        traffic["traced_batches"] = 2
    c.config, c.traffic = config, traffic
    return c
