"""``tcgan_torch.run.eval`` and the port's copies of the NumPy analysis
modules (``metrics``, ``loaders``, ``tc_grid``) against ``tcgan_tpu``'s:
the copies give exactly the reference's numbers on the same arrays and run
directory; ``run.eval --device cpu`` on a tiny port ``run.gan`` datastore
writes the reference's result keys, with the plots left out (and said so)
where matplotlib is missing; ``apply_run_config`` overlays and reports as
the reference's does."""

import json

import numpy as np
import pytest

from tcgan_tpu.analysis import loaders as jloaders
from tcgan_tpu.analysis import metrics as jmetrics
from tcgan_tpu.analysis import tc_grid as jtc_grid
from tcgan_tpu.run import common as jcommon
from tcgan_tpu.run import eval as jeval
from tcgan_torch.analysis import loaders as tloaders
from tcgan_torch.analysis import metrics as tmetrics
from tcgan_torch.analysis import tc_grid as ttc_grid
from tcgan_torch.run import common as tcommon
from tcgan_torch.run import eval as teval
from tcgan_torch.run import gan as tgan
from tests.test_ensemble import TINY_CLI

PORT_CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def gan_run(tmp_path_factory):
    """A tiny port ``run.gan`` datastore (fake truth, --gen-ema)."""
    d = tmp_path_factory.mktemp("gan") / "run"
    assert tgan.main(["--datastore", str(d), *TINY_CLI, "--batch-size", "3",
                      "--n-steps", "2", "--WGAN_n_critic", "2",
                      "--WGAN_n_critic0", "2", "--truth-samples", "8",
                      "--disc-layers", "8", "--gen-ema", "0.9",
                      *PORT_CPU]) == 0
    return d


def test_metric_copies_equal_the_reference():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(40, 5)), rng.normal(0.3, 1.2, size=(25, 5))
    assert tmetrics.tc_w1(a, b) == jmetrics.tc_w1(a, b)
    assert tmetrics.sliced_w1(a, b) == jmetrics.sliced_w1(a, b)
    np.testing.assert_array_equal(tmetrics.w1_per_feature(a, b),
                                  jmetrics.w1_per_feature(a, b))
    np.testing.assert_array_equal(ttc_grid.per_condition_w1(a, b),
                                  jtc_grid.per_condition_w1(a, b))
    fit = {k: rng.uniform(0.1, 1, (2, 2)) for k in "JDS"}
    true = {k: rng.uniform(0.1, 1, (2, 2)) for k in "JDS"}
    assert tmetrics.param_recovery_error(fit, true) == \
        jmetrics.param_recovery_error(fit, true)


def test_loader_copies_read_a_run_as_the_reference(gan_run):
    t, j = tloaders.load_run(gan_run), jloaders.load_run(gan_run)
    assert t.info == j.info
    for name in ("learning", "generator", "disc_stats"):
        tt, jj = getattr(t, name), getattr(j, name)
        assert tt.keys() == jj.keys()
        for k in jj:
            np.testing.assert_array_equal(tt[k], jj[k])
    assert t.tc_mean == j.tc_mean
    for source in ("csv", "npz", "npz_ema"):
        tp = tloaders.fitted_params(gan_run, source)
        jp = jloaders.fitted_params(gan_run, source)
        for k in "JDS":
            np.testing.assert_array_equal(tp[k], jp[k])


def _eval(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().split("\n")[-1])


def test_eval_writes_the_reference_keys(gan_run, tmp_path, capsys):
    rc_t, res_t = _eval(teval.main, ["--run", str(gan_run), "--datastore",
                                     str(tmp_path / "t"), "--eval-samples",
                                     "16", "--solver-backend", "torch",
                                     *PORT_CPU], capsys)
    rc_j, res_j = _eval(jeval.main, ["--run", str(gan_run), "--datastore",
                                     str(tmp_path / "j"), "--eval-samples",
                                     "16", "--solver-backend", "xla"],
                        capsys)
    assert rc_t == rc_j == 0
    # the port's run recorded its own backend; each CLI overrode it
    res_t.pop("config_overrides", None)
    res_j.pop("config_overrides")
    assert res_t.keys() == res_j.keys()
    assert res_t["n_gen"] == 16 and res_t["n_data"] == res_j["n_data"] == 8
    assert res_t["param_recovery_error"].keys() == {"J", "D", "S"}
    assert len(res_t["per_condition_w1"]) == len(res_j["per_condition_w1"])
    for k in ("tc_w1", "sliced_w1"):
        assert np.isfinite(res_t[k])
    # the same fitted parameters: the same recovery errors
    assert res_t["param_recovery_error"] == res_j["param_recovery_error"]
    npz_t = np.load(tmp_path / "t" / "eval_tuning_curves.npz")
    npz_j = np.load(tmp_path / "j" / "eval_tuning_curves.npz")
    assert npz_t.files == npz_j.files
    assert npz_t["gen_tc"].shape == npz_j["gen_tc"].shape
    np.testing.assert_array_equal(npz_t["data_tc"].shape,
                                  npz_j["data_tc"].shape)
    assert (tmp_path / "t" / "tc_grid.png").exists()
    info = json.loads((tmp_path / "t" / "info.json").read_text())
    assert info["result"]["tc_w1"] == res_t["tc_w1"]


def test_eval_without_matplotlib(gan_run, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(teval, "have_matplotlib", lambda: False)
    rc, res = _eval(teval.main, ["--run", str(gan_run), "--datastore",
                                 str(tmp_path / "e"), "--eval-samples", "16",
                                 "--params-source", "npz_ema", *PORT_CPU],
                    capsys)
    assert rc == 0
    assert res["plots"] == teval.PLOTS_SKIPPED
    assert len(res["per_condition_w1"]) == 2
    assert not list((tmp_path / "e").glob("*.png"))


def test_apply_run_config_matches_the_reference(gan_run, capsys):
    argv = ["--run", str(gan_run), "--contrast", "5", "10", "--N", "6"]
    t_args = teval.make_parser().parse_args(argv)
    j_args = jeval.make_parser().parse_args(argv)
    t_notes = tcommon.apply_run_config(t_args, teval.make_parser(), argv,
                                       gan_run)
    j_notes = jcommon.apply_run_config(j_args, jeval.make_parser(), argv,
                                       gan_run)
    assert t_notes == j_notes and len(t_notes) == 1
    assert "--contrasts overrides" in t_notes[0]
    assert tcommon.run_config_dests() == jcommon.run_config_dests()
    assert tcommon.explicit_dests(teval.make_parser(), argv) == \
        jcommon.explicit_dests(jeval.make_parser(), argv)
    for dest in tcommon.run_config_dests():
        assert getattr(t_args, dest) == getattr(j_args, dest), dest
    assert t_args.contrasts == [5.0, 10.0] and t_args.max_iter == 1500
    assert tcommon.mat22([1, 2, 3, 4]) == jcommon.mat22([1, 2, 3, 4])
    capsys.readouterr()


def test_apply_run_config_keeps_options_this_parser_lacks(tmp_path):
    """A reference run records ``--solver-backend pallas``: the port reads
    it as ``cuda``, the kernel, with no notice. A recorded value no option
    here accepts keeps the CLI's value, with a notice."""
    (tmp_path / "info.json").write_text(json.dumps(
        {"config": {"solver_backend": "pallas", "N": 8}}))
    args = teval.make_parser().parse_args(["--run", str(tmp_path)])
    notes = tcommon.apply_run_config(args, teval.make_parser(),
                                     ["--run", str(tmp_path)], tmp_path)
    assert args.solver_backend == "cuda" and args.N == 8
    assert notes == []
    assert tcommon.ssn_config_from_args(args).backend == "cuda"
    (tmp_path / "info.json").write_text(json.dumps(
        {"config": {"io_type": "relu", "N": 8}}))
    args = teval.make_parser().parse_args(["--run", str(tmp_path)])
    notes = tcommon.apply_run_config(args, teval.make_parser(),
                                     ["--run", str(tmp_path)], tmp_path)
    assert args.io_type == "asym_power" and args.N == 8
    assert len(notes) == 1 and "'relu'" in notes[0]
    assert tcommon.apply_run_config(args, teval.make_parser(), [],
                                    tmp_path / "missing") == []
