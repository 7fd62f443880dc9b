"""The benchmark on the card: each one-card cell runs a short window and
comes out correct, and the control at the cells' own size does not. Marked
``cuda``; skips where no card is visible (decided in the fixture)."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["n51_forward", "n51_gan_round2",
                                  "n201_forward"])
def test_short_run_is_correct(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("name", ["n51_forward", "n201_forward"])
def test_forward_control_fails_at_size(card, name):
    from benchmark.calibrate import forward_control

    cell = harness.Cell(name)
    readings = forward_control(cell, 5, card, cell.traffic["checked_batches"])
    assert not harness.judge(readings, cell.limits)[0], readings


def test_fit_control_fails_at_size(card):
    from benchmark.calibrate import fit_control

    cell = harness.Cell("n51_gan_round2")
    readings = fit_control(cell, 5, card)
    assert not harness.judge(readings, cell.limits)[0], readings
