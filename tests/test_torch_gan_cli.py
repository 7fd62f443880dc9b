"""The port's ``run.gan`` CLI against ``tcgan_tpu.run.gan``: the same flags,
and a tiny CPU fit whose datastore the reference's analysis reads with the
same columns as a tiny reference fit."""

import argparse
import json

import numpy as np
import pytest

from tcgan_tpu.analysis.loaders import load_run
from tcgan_tpu.run import gan as jgan
from tcgan_torch.run import gan as tgan

TINY_GAN = [
    "--N", "6", "--max-iter", "1500", "--atol", "1e-5",
    "--J", "0.02", "0.016", "0.02", "0.012",
    "--D", "0.05", "0.04", "0.05", "0.04",
    "--S", "0.25", "0.1", "0.25", "0.1",
    "--contrasts", "5", "--bandwidths", "0.25", "1.0",
    "--batch-size", "3", "--n-steps", "2", "--WGAN_n_critic", "2",
    "--WGAN_n_critic0", "2", "--truth-samples", "8", "--disc-layers", "8",
]


def _actions(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_parser_matches_jax_flags():
    j, t = _actions(jgan.make_parser()), _actions(tgan.make_parser())
    assert set(t) == set(j) | {"device"}
    for dest, ja in j.items():
        ta = t[dest]
        assert ta.option_strings == ja.option_strings, dest
        if dest == "solver_backend":
            # the reference's names are read as the port's
            assert ja.choices == ("xla", "pallas")
            assert ta.choices == ("torch", "cuda")
            assert tuple(map(ta.type, ja.choices)) == ta.choices
            continue
        assert ta.nargs == ja.nargs and ta.type == ja.type, dest
        assert ta.default == ja.default, dest
        assert ta.choices == ja.choices, dest
    assert tgan.make_parser().format_help()


def _steps(path):
    return [int(line.split(",")[0]) for line in
            (path / "learning.csv").read_text().splitlines()[1:]]


def test_tiny_cpu_fit_reads_like_a_jax_run_and_resumes(tmp_path):
    port = tmp_path / "port"
    rc = tgan.main(TINY_GAN + ["--device", "cpu", "--datastore", str(port),
                               "--checkpoint-every", "1",
                               "--timing-every", "2"])
    assert rc == 0
    assert jgan.main(TINY_GAN + ["--datastore", str(tmp_path / "jax")]) == 0
    t, j = load_run(port), load_run(tmp_path / "jax")
    for name in ("learning", "generator", "disc_stats"):
        assert list(getattr(t, name)) == list(getattr(j, name)), name
    assert [sorted(r) for r in t.tc_mean] == [sorted(r) for r in j.tc_mean]
    assert len(t.tc_mean[0]["tc_mean"]) == 2
    assert t.info["status"] == "finished" and t.info["config"]["entry"] == \
        "wgan"
    for col in ("d_loss", "g_loss", "wasserstein", "gp"):
        assert np.isfinite(t.learning[col]).all(), col
    # the first generator row is the passed --J after one small step
    np.testing.assert_allclose(t.final_gen_params()["J"].ravel(),
                               [0.02, 0.016, 0.02, 0.012], rtol=1e-2)
    assert abs(t.generator["J_EE"][0] - 0.02) < 1e-3
    # the timing probes run on step 0 only; other steps record NaN
    assert np.isfinite(t.learning["SSsolve_time"][0]) and \
        np.isfinite(t.learning["gradient_time"][0])
    assert np.isnan(t.learning["SSsolve_time"][1])
    assert (port / "disc_params.npz").exists()
    assert sorted(p.name for p in (port / "ckpt").iterdir()) == \
        ["1.pt", "2.pt"]

    rc = tgan.main(TINY_GAN + ["--device", "cpu", "--datastore", str(port),
                               "--resume", "--n-steps", "1",
                               "--profile-dir", str(tmp_path / "prof")])
    assert rc == 0
    assert _steps(port) == [0, 1, 2]
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    counts = json.loads((tmp_path / "prof" / "counters.json").read_text())
    assert counts["host_syncs.generator.battery"] > 0
    assert json.loads((port / "info.json").read_text())["status"] == \
        "finished"


def test_unported_options_raise(tmp_path):
    """The options that raised before they were ported now run as the
    reference does, one step each: the velocity-latched late gamma records
    ``drift_ratio`` in learning.jsonl, and the conditional path
    (``run_gan(..., conditional=True)``) writes an ``entry: cwgan`` run;
    the streams' columns and keys equal those of ``tcgan_tpu`` on the same
    command line. (``--parallel mesh``, which raised here too, runs in
    ``tests/test_torch_parallel.py``.)"""
    base = TINY_GAN + ["--n-steps", "1"]

    def columns(path):
        rows = [json.loads(line) for line in
                (path / "learning.jsonl").read_text().splitlines()]
        return (path / "learning.csv").read_text().splitlines()[0], rows

    latch = ["--moment-anchor", "1e-3", "--anchor-ema-late", "0.9",
             "--anchor-ema-switch-vel", "1.0"]
    assert tgan.main(base + latch + ["--device", "cpu", "--datastore",
                                     str(tmp_path / "t9")]) == 0
    assert jgan.main(base + latch + ["--datastore",
                                     str(tmp_path / "j9")]) == 0
    (t_head, t_rows), (j_head, j_rows) = (columns(tmp_path / "t9"),
                                          columns(tmp_path / "j9"))
    assert t_head == j_head and sorted(t_rows[0]) == sorted(j_rows[0])
    assert np.isfinite(t_rows[0]["drift_ratio"])
    assert np.isfinite(j_rows[0]["drift_ratio"])

    from tcgan_tpu.run import gan_common as jgan_common
    from tcgan_torch.run import gan_common

    args = tgan.make_parser().parse_args(
        base + ["--device", "cpu", "--datastore", str(tmp_path / "t14")])
    assert gan_common.run_gan(args, solver="ift", conditional=True) == 0
    jargs = jgan.make_parser().parse_args(
        base + ["--datastore", str(tmp_path / "j14")])
    assert jgan_common.run_gan(jargs, solver="ift", conditional=True) == 0
    (t_head, t_rows), (j_head, j_rows) = (columns(tmp_path / "t14"),
                                          columns(tmp_path / "j14"))
    assert t_head == j_head and sorted(t_rows[0]) == sorted(j_rows[0])
    info = json.loads((tmp_path / "t14" / "info.json").read_text())
    assert info["config"]["entry"] == "cwgan" and info["status"] == "finished"


@pytest.mark.parametrize("flags,conditional", [
    (dict(normalize_input=True), False),
    (dict(normalize_input_mode="std"), False),
    (dict(normalize_input=True), True),
    (dict(normalize_per_condition="mean"), True),
    (dict(normalize_per_condition="std", contrast_weights=[1.0, 3.0]),
     True),
])
def test_critic_input_scales_and_weights_match_jax(flags, conditional):
    from tcgan_tpu.data.datasets import TuningCurveDataset as JData
    from tcgan_tpu.models.generator import GeneratorConfig as JGen
    from tcgan_tpu.run import common as jcommon
    from tcgan_torch.data.datasets import TuningCurveDataset as TData
    from tcgan_torch.models.generator import GeneratorConfig as TGen
    from tcgan_torch.run import common as tcommon

    gen = dict(bandwidths=(0.0, 1.0), contrasts=(5.0, 10.0), sample_sites=2,
               track_offset_identity=True)
    tc = np.abs(np.random.default_rng(0).normal(1.0, 0.5, (12, 8)))
    base = dict(normalize_input=False, normalize_input_mode=None,
                normalize_per_condition=None, contrast_weights=None,
                contrasts=[5.0, 10.0], bandwidths=[0.0, 1.0])
    out = []
    for common, gcls, dcls in ((jcommon, JGen, JData),
                               (tcommon, TGen, TData)):
        args = argparse.Namespace(**{**base, **flags})
        out.append((common.critic_input_scales(
            args, gcls(**gen), dcls.from_array(tc), conditional),
            common.contrast_cond_weight(args, conditional),
            args.normalize_input))
    (j_scale, j_w, j_on), (t_scale, t_w, t_on) = out
    assert j_on == t_on and (j_w is None) == (t_w is None)
    np.testing.assert_allclose(t_w or [], j_w or [], rtol=1e-12)
    for a, b in zip(t_scale, j_scale):
        assert (a is None) == (b is None)
        np.testing.assert_allclose(a or [], b or [], rtol=1e-6)


def test_reference_command_line_with_pallas_reaches_the_kernel(
        tmp_path, monkeypatch):
    """A ``tcgan_tpu.run.gan`` command line with ``--solver-backend pallas``
    parses unchanged in ``tcgan_torch.run.gan`` and runs every solve
    through the kernel wrapper (its plain version on CPU tensors); the run
    records ``cuda``."""
    from tcgan_torch.ops.cuda import ssn_solve

    argv = TINY_GAN + ["--n-steps", "1", "--solver-backend", "pallas"]
    assert jgan.make_parser().parse_args(
        argv + ["--datastore", "x"]).solver_backend == "pallas"
    calls = []
    real = ssn_solve.solve_fixed_point_cuda

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ssn_solve, "solve_fixed_point_cuda", spy)
    store = tmp_path / "port"
    assert tgan.main(argv + ["--device", "cpu", "--datastore",
                             str(store)]) == 0
    info = json.loads((store / "info.json").read_text())
    assert info["config"]["solver_backend"] == "cuda"
    assert info["kernel_precision"] == ssn_solve.KERNEL_PRECISION
    # the fake truth (8 samples in one batch of 64), then n_critic0 + 1
    # solves and the tc_mean snapshot of step 0
    assert len(calls) == 1 + 2 + 1 + 1
