"""The harness on the CPU at tiny sizes: no card, no result; no JAX; a sound
run passes its limits; the control and each fault the cell can have come
out not correct."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import faults, harness, tiny
from benchmark.run import measure

CPU = torch.device("cpu")


def _python(code: str):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "n51_forward",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_harness_and_reference_load_no_jax():
    """A run of the harness (forward and fit, tiny, on the CPU) loads no
    module of JAX or of the JAX package; the reference alone loads nothing
    of the program either."""
    run = _python(
        "import json, sys, torch\n"
        "from benchmark import tiny\n"
        "from benchmark.run import measure\n"
        "for name in ('n51_forward', 'n51_gan_round2'):\n"
        "    measure(tiny.cell(name), 5, 0.2, False, torch.device('cpu'))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert run.returncode == 0, run.stderr[-3000:]
    top = set(json.loads(run.stdout.splitlines()[-1]))
    assert "tcgan_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "tcgan_tpu"}
    ref = _python(
        "import json, sys, torch\n"
        "from benchmark.reference import ssn, wgan\n"
        "z = torch.randn(2, 8, 8)\n"
        "c = dict(N=4, k=0.01, n=2.2, tau_E=0.016, tau_I=0.002, dt=5e-4,\n"
        "         rate_stop_at=200.0, L=1.0, smoothness=0.03, check_every=4,\n"
        "         bandwidths=[0.0, 0.5], rate_soft_bound=100.0)\n"
        "W, I = ssn.circuit_inputs(c, [.1] * 4, [.2] * 4, [.2] * 4, z, [5.])\n"
        "ssn.solve(c, W, I, atol=1e-4, max_iter=500, check_every=4)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert ref.returncode == 0, ref.stderr[-3000:]
    top = set(json.loads(ref.stdout.splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "tcgan_tpu", "tcgan_torch"}


@pytest.mark.parametrize("name", ["n51_forward", "n201_forward"])
def test_sound_forward_run_is_correct(name):
    line = measure(tiny.cell(name), 11, 0.3, False, CPU)[0]
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["metrics"]["circuits_per_s"]["value"] > 0


def test_sound_fit_run_is_correct():
    line = measure(tiny.cell("n51_gan_round2"), 12, 0.3, False, CPU)[0]
    assert line["correct"], line["checks"]
    assert line["metrics"]["step_ms"]["value"] > 0


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_forward_fault_is_caught(fault):
    line = measure(tiny.cell("n51_forward"), 13, 0.3, False, CPU,
                   plant=faults.PLANTS[fault])[0]
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch",
                                   "state_unchanged", "gen_lr_doubled"])
def test_fit_fault_is_caught(fault):
    line = measure(tiny.cell("n51_gan_round2"), 14, 0.3, False, CPU,
                   plant=faults.PLANTS[fault])[0]
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", ["n51_forward", "n201_forward"])
def test_control_fails_forward(name):
    """The reference in TF32 in the program's place is not correct, at the
    cell's widths and a small batch."""
    from benchmark.calibrate import forward_control

    cell = tiny.cell(name, batch=16, widths=True)
    readings = forward_control(cell, 16, CPU, 1)
    assert not harness.judge(readings, cell.limits)[0], readings


def test_control_fails_fit():
    from benchmark.calibrate import fit_control

    cell = tiny.cell("n51_gan_round2", batch=16, widths=True)
    readings = fit_control(cell, 17, CPU)
    assert not harness.judge(readings, cell.limits)[0], readings
