"""The port's copies of the post-fit analysis modules (``fit_quality``,
``recovery_gate``, ``learning_curves``, ``compare``, ``ensemble_view``,
``report``) against ``tcgan_tpu.analysis``'s on one tiny port ``run.gan``
datastore and one tiny port ``run.ensemble`` datastore, written on the CPU:
the same summaries, report markdown, gate status and exit codes, and
``spread_vs_spectrum``; without matplotlib every CLI finishes with its
numbers and says that the figure was skipped. Both sides are NumPy, so the
comparisons are exact."""

import json

import numpy as np
import pytest

from tcgan_tpu.analysis import compare as jcompare
from tcgan_tpu.analysis import ensemble_view as jens_view
from tcgan_tpu.analysis import fit_quality as jfit
from tcgan_tpu.analysis import learning_curves as jcurves
from tcgan_tpu.analysis import loaders as jloaders
from tcgan_tpu.analysis import recovery_gate as jgate
from tcgan_tpu.analysis import report as jreport
from tcgan_torch import analysis as tanalysis
from tcgan_torch.analysis import compare as tcompare
from tcgan_torch.analysis import ensemble_view as tens_view
from tcgan_torch.analysis import fit_quality as tfit
from tcgan_torch.analysis import learning_curves as tcurves
from tcgan_torch.analysis import loaders as tloaders
from tcgan_torch.analysis import recovery_gate as tgate
from tcgan_torch.analysis import report as treport
from tcgan_torch.run import ensemble as tens_cli
from tcgan_torch.run import eval as teval
from tcgan_torch.run import gan as tgan
from tcgan_torch.utils import plotting
from tests.test_ensemble import TINY_CLI

PORT_CPU = ["--device", "cpu"]
TRUE = ["--true-J", "0.02", "0.016", "0.02", "0.012",
        "--true-D", "0.05", "0.04", "0.05", "0.04",
        "--true-S", "0.25", "0.1", "0.25", "0.1"]
MODULES = {"fit_quality": (jfit, tfit), "recovery_gate": (jgate, tgate),
           "learning_curves": (jcurves, tcurves),
           "compare": (jcompare, tcompare),
           "ensemble_view": (jens_view, tens_view),
           "report": (jreport, treport)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A port ``run.gan`` datastore (fake truth at TRUE, 3 steps), its
    ``run.eval`` datastore, a port ``run.ensemble`` datastore (2 WGAN
    members) and a moment Jacobian (12 parameters, 8 moments)."""
    root = tmp_path_factory.mktemp("runs")
    gan, ev, ens = root / "gan", root / "gan_eval", root / "ens"
    assert tgan.main(["--datastore", str(gan), *TINY_CLI, *TRUE,
                      "--batch-size", "3", "--n-steps", "3",
                      "--WGAN_n_critic", "2", "--WGAN_n_critic0", "2",
                      "--truth-samples", "8", "--disc-layers", "8",
                      *PORT_CPU]) == 0
    assert teval.main(["--run", str(gan), "--datastore", str(ev),
                       "--eval-samples", "16", *PORT_CPU]) == 0
    assert tens_cli.main(["--datastore", str(ens), *TINY_CLI, *TRUE,
                          "--truth-samples", "8", "--n-steps", "2",
                          "--ensemble", "2", "--record-every", "1",
                          "--batch-size", "3", "--WGAN_n_critic", "2",
                          "--WGAN_n_critic0", "2", "--disc-layers", "8",
                          "--start-jitter", "0.05", *PORT_CPU]) == 0
    jac = root / "jac.npz"
    np.savez(jac, jacobian=np.random.default_rng(0).normal(size=(8, 12)))
    return dict(gan=gan, eval=ev, ens=ens, jac=jac)


def _json(main, argv, capsys):
    """(exit code, the last JSON line printed) of one CLI run."""
    rc = main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def _cli_argv(name, runs, out):
    gan, jac = str(runs["gan"]), str(runs["jac"])
    return {
        "fit_quality": [gan, "--eval", str(runs["eval"]), "--jacobian", jac,
                        "-o", str(out)],
        "learning_curves": [gan, "-o", str(out), *TRUE],
        "compare": [gan, gan, "--labels", "a", "b", "-o", str(out), *TRUE],
        "ensemble_view": [str(runs["ens"]), "--jacobian", jac, "-o",
                          str(out)],
    }[name]


@pytest.mark.parametrize("name", ["fit_quality", "learning_curves",
                                  "compare", "ensemble_view"])
def test_figure_clis_print_the_reference_summary(runs, name, tmp_path,
                                                 capsys, monkeypatch):
    """Each figure CLI prints the reference's JSON (all but the figure's
    path); without matplotlib the same numbers, and the figure skipped."""
    jmod, tmod = MODULES[name]
    rc_j, ref = _json(jmod.main, _cli_argv(name, runs, tmp_path / "j.png"),
                      capsys)
    rc_t, got = _json(tmod.main, _cli_argv(name, runs, tmp_path / "t.png"),
                      capsys)
    assert rc_j == rc_t == 0
    assert ref.pop("plot") == str(tmp_path / "j.png")
    assert got.pop("plot") == str(tmp_path / "t.png")
    assert (tmp_path / "t.png").exists()
    assert got == ref
    monkeypatch.setattr(tmod, "have_matplotlib", lambda: False)
    rc, bare = _json(tmod.main, _cli_argv(name, runs, tmp_path / "n.png"),
                     capsys)
    assert rc == 0 and bare.pop("plot") == plotting.PLOTS_SKIPPED
    assert bare == ref and not (tmp_path / "n.png").exists()
    if name == "fit_quality":
        assert {"param_recovery_error", "tc_w1", "sliced_w1",
                "subspace"} <= ref.keys()
    if name == "ensemble_view":
        assert "spread_spectrum_spearman" in ref


def test_truth_and_spread_match_the_reference(runs):
    for d in ("gan", "ens"):
        info = json.loads((runs[d] / "info.json").read_text())
        t, j = tfit.true_params_from_info(info), jfit.true_params_from_info(
            info)
        assert t.keys() == j.keys() == set("JDS")
        for k in "JDS":
            np.testing.assert_array_equal(t[k], j[k])
    assert tfit.true_params_from_info({"config": {"dataset": "x.npz"}}) is \
        None
    jac = np.load(runs["jac"])["jacobian"]
    for jacobian in (jac, jac[:5]):  # a moment-deficient battery too
        s_t, sp_t = tens_view.spread_vs_spectrum(
            tloaders.load_ensemble(runs["ens"]), jacobian)
        s_j, sp_j = jens_view.spread_vs_spectrum(
            jloaders.load_ensemble(runs["ens"]), jacobian)
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_array_equal(sp_t, sp_j)
        assert s_t.shape == sp_t.shape == (12,)
    t = tcompare.summarize(tanalysis.load_runs([runs["gan"]]))
    j = jcompare.summarize(jcompare.load_runs([runs["gan"]]))
    assert t == j


@pytest.mark.parametrize("flags", [
    [],  # the gate cannot clear before min-step 15000
    ["--min-step", "0", "--window", "1", "--gate", "100"],
    ["--min-step", "0", "--window", "1", "--gate", "1e-9"],
    ["--min-step", "0", "--window", "50"],  # longer than the run
    ["--min-step", "0", "--window", "1", "--true-J", "1", "1", "1", "1"],
])
def test_recovery_gate_matches_the_reference(runs, flags, capsys):
    argv = [str(runs["gan"]), *flags]
    rc_j, ref = _json(jgate.main, argv, capsys)
    rc_t, got = _json(tgate.main, argv, capsys)
    assert rc_t == rc_j and got == ref
    assert rc_t == (0 if "100" in flags else 1)
    status = tgate.gate_status(runs["gan"], [0.02, 0.016, 0.02, 0.012],
                               [0.05, 0.04, 0.05, 0.04], 0.07, 0, 1)
    assert status == jgate.gate_status(
        runs["gan"], [0.02, 0.016, 0.02, 0.012], [0.05, 0.04, 0.05, 0.04],
        0.07, 0, 1)


def test_recovery_gate_without_recorded_truth_exits_2(runs, tmp_path,
                                                      capsys):
    d = tmp_path / "run"
    d.mkdir()
    (d / "generator.csv").write_text(
        (runs["gan"] / "generator.csv").read_text())
    (d / "info.json").write_text(json.dumps({"config": {"dataset": None}}))
    assert tgate.main([str(d)]) == jgate.main([str(d)]) == 2
    assert tgate.main([str(d / "none"), "--true-J", "1", "1", "1", "1",
                       "--true-D", "1", "1", "1", "1"]) == 1
    capsys.readouterr()


def test_report_markdown_matches_the_reference(runs, tmp_path, capsys):
    ev_json = tmp_path / "eval.json"
    ev_json.write_text(json.dumps(json.loads(
        (runs["eval"] / "info.json").read_text())["result"]))
    same = lambda t: t.replace("tcgan_torch.", "tcgan_tpu.")  # noqa: E731
    got = treport.render_report(tloaders.load_run(runs["gan"]), ev_json)
    ref = jreport.render_report(jloaders.load_run(runs["gan"]), ev_json)
    assert same(got) == ref and "## Eval" in got and "| J_EE |" in got
    got = treport.render_ensemble_report(tloaders.load_ensemble(runs["ens"]))
    ref = jreport.render_ensemble_report(jloaders.load_ensemble(runs["ens"]))
    assert same(got) == ref and "Members recovered" in got
    for d, head in (("gan", "# Run report"), ("ens", "# Ensemble report")):
        out_t, out_j = tmp_path / f"{d}_t.md", tmp_path / f"{d}_j.md"
        assert treport.main([str(runs[d]), "-o", str(out_t),
                             "--eval-json", str(ev_json)]) == 0
        assert jreport.main([str(runs[d]), "-o", str(out_j),
                             "--eval-json", str(ev_json)]) == 0
        assert same(out_t.read_text()) == out_j.read_text()
        assert out_t.read_text().startswith(head)
    assert treport.main([str(tmp_path / "none")]) == \
        jreport.main([str(tmp_path / "none")]) == 2
    capsys.readouterr()
