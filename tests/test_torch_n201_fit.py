"""The round-2 WGAN-GP fit at the paper's width, N=201 (2N=402), on the CPU.

The benchmark's cell ``n201_gan_round2`` cut to 2 circuits, its widths kept
(N=201, 8 bandwidths, contrasts 5 and 10, the critic (128, 128)): the
port's fit step, through the solver kernel's plain version and the plain
adjoint loop, against the plain reference (``benchmark/reference/``) on
seeded random weights, under the cell's own limits. Then the program's
record of one fit step at this width and at N=51: each adjoint's rows,
circuits and 2N, and the solves by the plan's cluster size (8 at 2N=402,
one block at 2N=102).
"""

import numpy as np
import pytest
import torch

from benchmark import fit, inputs, program, tiny
from benchmark.run import measure
from tcgan_torch.models import wgan
from tcgan_torch.utils import profiling

CPU = torch.device("cpu")


def test_fit_at_the_paper_width_matches_the_reference():
    cell = tiny.cell("n201_gan_round2", batch=2, widths=True)
    assert cell.config["circuit"]["N"] == 201
    assert cell.config["critic_layers"] == [128, 128]
    line = measure(cell, 2200000018, 0.5, False, CPU)[0]
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    assert line["attempted"] >= 1


@pytest.mark.parametrize("name,n2,cluster", [("n201_gan_round2", 402, 8),
                                             ("n51_gan_round2", 102, 1)])
def test_fit_step_records_the_adjoint_and_the_cluster(name, n2, cluster):
    cell = tiny.cell(name, batch=2, widths=True)
    config, traffic = cell.config, cell.traffic
    S = len(config["circuit"]["bandwidths"]) * len(traffic["contrasts"])
    data = np.random.default_rng(0).uniform(1.0, 20.0, (32, S)).astype(
        np.float32)
    critic0 = inputs.Draws(traffic["critic_seed"], CPU).critic_init(
        fit._dims(config, traffic))
    cfg, state = program.fit(config, traffic, CPU, data, critic0)
    real, cz, eps, gz = inputs.Draws(5, CPU).step(
        0, traffic, config["circuit"]["N"], torch.as_tensor(data))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        wgan.train_step(cfg, traffic["n_critic"], state, real,
                        noise=wgan.StepNoise(cz, eps, gz))
    counts = profiling.counters()
    # one adjoint a step, the generator's: 2 circuits of S=16 rows
    assert counts[f"ift.adjoint_rows.{n2}"] == 2 * S == 32
    assert counts[f"ift.adjoint_circuits.{n2}"] == 2
    assert sorted(k for k in counts if k.startswith(
        ("ift.adjoint_rows.", "ift.adjoint_circuits."))) == [
        f"ift.adjoint_circuits.{n2}", f"ift.adjoint_rows.{n2}"]
    # n_critic critic solves and the generator's, all on the plan's cluster
    solves = {k: v for k, v in counts.items()
              if k.startswith("ssn_solve.launches_cluster.")}
    assert solves == {f"ssn_solve.launches_cluster.{cluster}":
                      traffic["n_critic"] + 1}
    # no kernel runs on the CPU
    assert "ift.adjoint_w_device_launches" not in counts
