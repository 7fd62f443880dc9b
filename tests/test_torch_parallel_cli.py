"""``--parallel mesh`` through the port's entry points on 4 gloo ranks,
against the unsharded runs of the same command lines in this process: the
reference's TINY flags (``tests/test_parallel.py:150-175``) on the CPU.

The ranks are spawned once for the module (``parallel.launch.spawn``);
each runs the entry points' ``main`` in turn, as ``torchrun`` or a plain
``python -m ... --parallel mesh`` on several GPUs would. Only rank 0
writes the run directory, so a stream with a row per rank would show it.

Tolerances (float32 runs): learning and generator rows to rtol 1e-4 (the
sharded step's, ``tests/test_torch_parallel.py``); the forward solve's
flags and iters equal, its rates to rtol 1e-6, because the lockstep
solve's batched mat-vec rounds by the batch it is given (2 circuits a
rank against 8) — the CUDA kernel solves each circuit alone; ensemble
rows to rtol 1e-6 (members share nothing, the critic's batched matmuls
over 1 member a rank against 4 may round apart).
"""

import csv
import json

import numpy as np
import pytest

from tcgan_torch.parallel import launch
from tcgan_torch.run import bptt_cwgan as tbc
from tcgan_torch.run import bptt_moments as tbm
from tcgan_torch.run import bptt_wgan as tbw
from tcgan_torch.run import ensemble as tens
from tcgan_torch.run import forward as tforward
from tcgan_torch.run import gan as tgan
from tcgan_torch.run import moments as tmm

BASE = [
    "--N", "6", "--max-iter", "1500", "--atol", "1e-5",
    "--J", "0.02", "0.016", "0.02", "0.012",
    "--D", "0.05", "0.04", "0.05", "0.04",
    "--S", "0.25", "0.1", "0.25", "0.1",
    "--contrasts", "5", "--bandwidths", "0.25", "1.0",
    "--batch-size", "8", "--device", "cpu",
]
TRUTH = ["--truth-samples", "8"]
GAN = TRUTH + ["--n-steps", "2", "--WGAN_n_critic", "2",
               "--WGAN_n_critic0", "2", "--disc-layers", "8"]
BPTT = ["--seqlen", "200", "--dt", "0.001"]
RUNS = {
    "forward": (tforward.main, BASE + ["--total-samples", "16"]),
    "gan": (tgan.main, BASE + GAN),
    "bptt_wgan": (tbw.main, BASE + GAN + BPTT),
    "bptt_cwgan": (tbc.main, BASE + GAN + BPTT),
    "moments": (tmm.main, BASE + TRUTH + ["--n-steps", "2", "--fixed-z"]),
    "bptt_moments": (tbm.main, BASE + TRUTH + ["--n-steps", "2"] + BPTT),
    "ensemble": (tens.main, BASE + GAN + ["--ensemble", "4", "--batch-size",
                                          "4", "--start-jitter", "0.05"]),
}
RANKS = 4
# columns a rank's clock writes
CLOCKS = {"train_time", "SSsolve_time", "gradient_time"}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    for name, (main, argv) in RUNS.items():
        assert main(argv + ["--datastore", str(root / "plain" / name)]) == 0
    calls = [(main, (argv + ["--parallel", "mesh", "--datastore",
                             str(root / "mesh" / name)],), {})
             for name, (main, argv) in RUNS.items()]
    # a fit resumed for 1 step after 2, sharded and not
    for where, extra in (("plain", []), ("mesh", ["--parallel", "mesh"])):
        for more in ([], ["--resume", "--n-steps", "1"]):
            argv = (BASE + GAN + more + extra
                    + ["--datastore", str(root / where / "gan_resumed")])
            if where == "mesh":
                calls.append((tgan.main, (argv,), {}))
            else:
                assert tgan.main(argv) == 0
    ranks = launch.spawn(launch.call_each, RANKS, (calls,), timeout=240,
                         deadline=360)
    assert all(rc == [0] * len(calls) for rc in ranks)
    return root


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _close_rows(mesh, plain, rtol, what):
    assert [r.keys() for r in mesh] == [r.keys() for r in plain], what
    assert len(mesh) == len(plain), what
    for a, b in zip(mesh, plain):
        for k in a.keys() - CLOCKS:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=rtol,
                                       atol=1e-9, err_msg=f"{what} {k}")


def test_forward_npz_matches_unsharded(stores):
    mesh = np.load(stores / "mesh" / "forward" / "tuning_curves.npz")
    plain = np.load(stores / "plain" / "forward" / "tuning_curves.npz")
    assert mesh.files == plain.files
    for k in ("converged", "diverged", "iters"):
        np.testing.assert_array_equal(mesh[k], plain[k], err_msg=k)
    for k in ("tuning_curves", "rates"):
        np.testing.assert_allclose(mesh[k], plain[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    info = json.loads((stores / "mesh" / "forward" / "info.json")
                      .read_text())
    assert info["summary"]["n_devices"] == RANKS
    assert info["summary"]["n_samples"] == 16


@pytest.mark.parametrize("name", ["gan", "bptt_wgan", "bptt_cwgan",
                                  "moments", "bptt_moments"])
def test_fit_rows_match_unsharded(stores, name):
    """One row per step (rank 0's alone), the unsharded run's values."""
    mesh, plain = stores / "mesh" / name, stores / "plain" / name
    for stream in ("learning.csv", "generator.csv"):
        rows = _rows(mesh / stream)
        assert [int(r["step"]) for r in rows] == [0, 1], stream
        _close_rows(rows, _rows(plain / stream), 1e-4, f"{name} {stream}")
    info = json.loads((mesh / "info.json").read_text())
    assert info["status"] == "finished"
    assert info["config"]["parallel"] == "mesh"
    assert (mesh / "ckpt" / "2.pt").exists()


def test_resumed_fit_continues_on_every_rank(stores):
    """``--resume`` of a sharded 2-step fit: every rank restores step 2
    (a rank that did not would feed other parameters' circuits into the
    gathered batch), so step 2 is the unsharded resume's."""
    rows = _rows(stores / "mesh" / "gan_resumed" / "learning.csv")
    assert [int(r["step"]) for r in rows] == [0, 1, 2]
    _close_rows(rows, _rows(stores / "plain" / "gan_resumed" /
                            "learning.csv"), 1e-4, "resumed")
    assert (stores / "mesh" / "gan_resumed" / "ckpt" / "3.pt").exists()


def test_ensemble_members_over_ranks_match_unsharded(stores):
    mesh, plain = stores / "mesh" / "ensemble", stores / "plain" / "ensemble"
    rows = _rows(mesh / "ensemble.csv")
    assert [(int(r["step"]), int(r["member"])) for r in rows] == \
        [(s, m) for s in range(2) for m in range(4)]
    _close_rows(rows, _rows(plain / "ensemble.csv"), 1e-6, "ensemble")
    a = np.load(mesh / "ensemble_params.npz")
    b = np.load(plain / "ensemble_params.npz")
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    assert (mesh / "ckpt" / "2.pt").exists()


def test_ensemble_members_must_split_over_ranks(tmp_path):
    """``--ensemble`` not divisible by the ranks exits with the
    reference's message (``tcgan_tpu/run/ensemble.py:121-125``)."""
    main, argv = RUNS["ensemble"]
    argv = argv + ["--ensemble", "3", "--parallel", "mesh", "--datastore",
                   str(tmp_path / "x")]
    with pytest.raises(RuntimeError,
                       match="must be divisible by the 2-device mesh"):
        launch.spawn(main, 2, (argv,), timeout=60,
                     deadline=120)
