"""``tcgan_torch.run.ensemble`` end to end on the CPU at the tiny circuit of
``tests/test_ensemble.py`` (``TINY_CLI``): all three estimators, the
artifacts against the reference CLI's for the same flags (CSV header, npz
keys and shapes, summary keys), the reference's loader reading the port's
datastore, ``--resume`` truncation, and the flag contradictions."""

import json

import numpy as np
import pytest

from tcgan_tpu.analysis.loaders import load_ensemble
from tcgan_tpu.run import ensemble as jens_cli
from tcgan_torch.run import ensemble as tens_cli
from tests.test_ensemble import TINY_CLI

PORT_CPU = ["--device", "cpu"]
FLAGS = {
    "wgan": ["--batch-size", "3", "--WGAN_n_critic", "2",
             "--WGAN_n_critic0", "2", "--disc-layers", "8",
             "--start-jitter", "0.05", "--gen-ema", "0.9"],
    "cwgan": ["--estimator", "cwgan", "--batch-size", "3",
              "--WGAN_n_critic", "2", "--WGAN_n_critic0", "2",
              "--disc-layers", "8", "--start-jitter", "0.05",
              "--normalize-input"],
    "mm": ["--estimator", "mm", "--batch-size", "4", "--moment-ema", "0.9",
           "--start-jitter", "0.05", "--fixed-z", "--data-seed-per-member"],
}


def _argv(d, estimator, n_steps=2, *extra):
    return (["--datastore", str(d), *TINY_CLI, "--truth-samples", "8",
             "--n-steps", str(n_steps), "--ensemble", "2",
             "--record-every", "1", *FLAGS[estimator], *extra])


def _rows(d):
    lines = (d / "ensemble.csv").read_text().strip().split("\n")
    return lines[0], [dict(zip(lines[0].split(","), r.split(",")))
                      for r in lines[1:]]


@pytest.mark.parametrize("estimator", ["wgan", "mm"])
def test_artifacts_match_the_reference_cli(tmp_path, estimator):
    d_t, d_j = tmp_path / "torch", tmp_path / "jax"
    assert tens_cli.main(_argv(d_t, estimator) + PORT_CPU) == 0
    assert jens_cli.main(_argv(d_j, estimator)) == 0
    (h_t, rows_t), (h_j, _) = _rows(d_t), _rows(d_j)
    assert h_t == h_j
    assert [(r["step"], r["member"]) for r in rows_t] == [
        ("0", "0"), ("0", "1"), ("1", "0"), ("1", "1")]
    assert all(np.isfinite(float(v)) for r in rows_t for v in r.values())
    npz_t = np.load(d_t / "ensemble_params.npz")
    npz_j = np.load(d_j / "ensemble_params.npz")
    assert sorted(npz_t.files) == sorted(npz_j.files)
    for k in npz_j.files:
        assert npz_t[k].shape == npz_j[k].shape == (2, 2, 2)
    s_t = json.loads((d_t / "ensemble_summary.json").read_text())
    s_j = json.loads((d_j / "ensemble_summary.json").read_text())
    assert s_t.keys() == s_j.keys() and s_t["n_members"] == 2
    assert s_t["members"][0].keys() == s_j["members"][0].keys()
    info_t = json.loads((d_t / "info.json").read_text())
    info_j = json.loads((d_j / "info.json").read_text())
    assert info_t["status"] == info_j["status"] == "finished"
    assert info_t["config"]["entry"] == info_j["config"]["entry"]
    # the reference's loader reads the port's datastore
    rec = load_ensemble(d_t)
    assert rec.n_members == 2
    assert rec.member_trajectory(1, "J").shape == (2, 2, 2)
    # member 0 began at the exact --J: one Adam step away at step 0
    j_ee = float(rows_t[0]["J_EE"])
    assert abs(j_ee - 0.02) < 5e-3


def test_conditional_ensemble_and_resume(tmp_path):
    d = tmp_path / "cens"
    argv = _argv(d, "cwgan", 2, "--checkpoint-every", "2") + PORT_CPU
    assert tens_cli.main(argv) == 0
    (d / "ensemble.csv").open("a").write(
        "2,0," + ",".join(["9"] * 20) + "\n")  # a row past the checkpoint
    assert tens_cli.main(argv + ["--resume"]) == 0
    _, rows = _rows(d)
    assert [(int(r["step"]), int(r["member"])) for r in rows] == [
        (s, m) for s in range(4) for m in range(2)]
    assert all(np.isfinite(float(r["d_loss"])) for r in rows)
    assert float(rows[4]["d_loss"]) != 9.0
    info = json.loads((d / "info.json").read_text())
    assert info["status"] == "finished"
    assert (d / "ckpt" / "4.pt").exists()


@pytest.mark.parametrize("extra,err", [
    (["--estimator", "wgan", "--conditional"], SystemExit),
    (["--estimator", "mm", "--conditional"], SystemExit),
    (["--estimator", "mm", "--parallel", "mesh"], SystemExit),
    (["--record-every", "0"], SystemExit),
    (["--moment-anchor", "1e-3"], SystemExit),
    (["--estimator", "mm", "--data-seed-per-member", "--dataset", "x.npz"],
     SystemExit),
])
def test_flag_contradictions_raise(tmp_path, extra, err):
    argv = ["--datastore", str(tmp_path / "x"), *TINY_CLI, "--batch-size",
            "4", "--truth-samples", "8", "--n-steps", "1", *PORT_CPU, *extra]
    with pytest.raises(err) as info:
        tens_cli.main(argv)
    if "--moment-anchor" in extra:
        assert "--moment-anchor" in str(info.value)
