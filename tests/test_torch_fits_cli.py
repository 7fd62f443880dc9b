"""The port's fit entry points ``run.bptt_wgan``, ``run.bptt_cwgan``,
``run.moments`` and ``run.bptt_moments`` against ``tcgan_tpu``'s: the same
flags, and tiny CPU fits (N=6, 2 stimuli, batch 3-4, seqlen 200) whose
``learning.csv`` / ``generator.csv`` columns and ``learning.jsonl`` keys are
those the reference's CLI writes for the same command line, with
``--resume`` continuing the step count.

The noise draws of the two packages differ, so values are compared in the
model tests (``tests/test_torch_{euler,cwgan,moments_fit}.py``); here the
port's losses must be finite.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from tcgan_tpu.run import bptt_cwgan as jcw
from tcgan_tpu.run import bptt_moments as jbm
from tcgan_tpu.run import bptt_wgan as jbw
from tcgan_tpu.run import moments as jmm
from tcgan_torch.run import bptt_cwgan as tcw
from tcgan_torch.run import bptt_moments as tbm
from tcgan_torch.run import bptt_wgan as tbw
from tcgan_torch.run import moments as tmm

TINY = [
    "--N", "6", "--max-iter", "1500", "--atol", "1e-5",
    "--J", "0.02", "0.016", "0.02", "0.012",
    "--D", "0.05", "0.04", "0.05", "0.04",
    "--S", "0.25", "0.1", "0.25", "0.1",
    "--contrasts", "5", "--bandwidths", "0.25", "1.0",
    "--truth-samples", "8", "--seqlen", "200", "--dt", "0.001",
]
TINY_GAN = TINY + ["--batch-size", "3", "--n-steps", "2",
                   "--WGAN_n_critic", "2", "--WGAN_n_critic0", "2",
                   "--disc-layers", "8"]
TINY_MM = TINY + ["--batch-size", "4", "--n-steps", "2"]
CPU = ["--device", "cpu"]


def _actions(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("jmod,tmod", [(jbw, tbw), (jcw, tcw), (jmm, tmm),
                                       (jbm, tbm)])
def test_parsers_match_jax_flags(jmod, tmod):
    j, t = _actions(jmod.make_parser()), _actions(tmod.make_parser())
    assert set(t) == set(j) | {"device"}
    for dest, ja in j.items():
        ta = t[dest]
        assert ta.option_strings == ja.option_strings, dest
        if dest == "solver_backend":
            # the reference's names are read as the port's
            assert ta.choices == ("torch", "cuda")
            assert tuple(map(ta.type, ja.choices)) == ta.choices
            continue
        assert ta.nargs == ja.nargs and ta.type == ja.type, dest
        assert ta.default == ja.default and ta.choices == ja.choices, dest
    assert tmod.make_parser().format_help()


def _columns(path):
    """(learning.csv header, generator.csv header, learning.jsonl keys)."""
    header = lambda f: (path / f).read_text().splitlines()[0]  # noqa: E731
    rows = [json.loads(line) for line in
            (path / "learning.jsonl").read_text().splitlines()]
    return header("learning.csv"), header("generator.csv"), \
        [sorted(r) for r in rows]


def _learning(path):
    lines = (path / "learning.csv").read_text().splitlines()
    cols = lines[0].split(",")
    return [dict(zip(cols, map(float, line.split(","))))
            for line in lines[1:]]


def _fit_and_resume(tmod, jmod, argv, tmp_path, losses):
    """A 2-step port fit, a 1-step ``--resume``, and one reference fit of
    the same command line; returns the port's datastore."""
    port = tmp_path / "port"
    assert tmod.main(argv + CPU + ["--datastore", str(port)]) == 0
    assert jmod.main(argv + ["--n-steps", "1", "--datastore",
                             str(tmp_path / "jax")]) == 0
    t_cols, j_cols = _columns(port), _columns(tmp_path / "jax")
    assert t_cols[:2] == j_cols[:2]
    assert t_cols[2][0] == j_cols[2][0]
    assert tmod.main(argv + CPU + ["--datastore", str(port), "--resume",
                                   "--n-steps", "1"]) == 0
    rows = _learning(port)
    assert [int(r["step"]) for r in rows] == [0, 1, 2]
    gen = (port / "generator.csv").read_text().splitlines()[1:]
    assert [int(line.split(",")[0]) for line in gen] == [0, 1, 2]
    for r in rows:
        for k in losses:
            assert np.isfinite(r[k]), (k, r)
    info = json.loads((port / "info.json").read_text())
    assert info["status"] == "finished"
    assert info["kernel_launches_fake_truth"] == 0  # CPU tensors
    return port, info


def test_bptt_wgan_fits_and_resumes(tmp_path):
    port, info = _fit_and_resume(
        tbw, jbw, TINY_GAN + ["--bptt-checkpoint-chunk", "100"], tmp_path,
        ("d_loss", "g_loss", "wasserstein", "gp"))
    assert info["config"]["entry"] == "wgan"
    assert info["config"]["solver"] == "bptt"
    assert all(r["mean_iters"] == 200 for r in _learning(port))
    assert sorted(p.name for p in (port / "ckpt").iterdir()) == \
        ["2.pt", "3.pt"]


def test_bptt_cwgan_fits_and_resumes(tmp_path):
    port, info = _fit_and_resume(
        tcw, jcw, TINY_GAN + ["--normalize-per-condition",
                              "--contrast-weights", "2"],
        tmp_path, ("d_loss", "g_loss", "wasserstein", "gp"))
    assert info["config"]["entry"] == "cwgan"
    assert info["config"]["solver"] == "bptt"  # the entry point's default
    # the conditional critic: probe + (bandwidth, contrast) inputs
    export = np.load(port / "disc_params.npz")
    assert export["w0"].shape == (3, 8)


def test_moments_fixed_z_fits_and_resumes(tmp_path):
    argv = TINY_MM + ["--fixed-z", "--moment-ema", "0.9",
                      "--checkpoint-every", "1"]
    port, info = _fit_and_resume(tmm, jmm, argv, tmp_path,
                                 ("loss", "mean_err", "cov_err"))
    assert info["config"]["entry"] == "moments"
    # the z-set survives the resume: every checkpoint holds the same one
    zs = [torch.load(p, weights_only=True)["fixed_z"]
          for p in sorted((port / "ckpt").iterdir())]
    assert len(zs) == 3 and zs[0].shape == (4, 12, 12)
    assert all(torch.equal(z, zs[0]) for z in zs)
    counts = [torch.load(p, weights_only=True)["ema_count"]
              for p in sorted((port / "ckpt").iterdir())]
    assert [float(c) for c in counts] == [1.0, 2.0, 3.0]


def test_bptt_moments_runs_the_bptt_solver(tmp_path):
    port, info = _fit_and_resume(tbm, jbm, TINY_MM, tmp_path,
                                 ("loss", "mean_err", "cov_err"))
    assert info["config"]["solver"] == "bptt"
    assert info["config"]["entry"] == "moments"


def test_mesh_still_raises(tmp_path):
    """``--parallel mesh`` runs these fits (``tests/test_torch_parallel.py``),
    with a model axis too (``tests/test_torch_model_axis.py``); what still
    raises, before any collective, is a config with mesh axes sampled
    outside an active mesh, and a model axis that does not split 2N."""
    import collections

    from tcgan_torch import parallel as par
    from tcgan_torch.models import generator as tgen
    from tcgan_torch.parallel import mesh as tmesh
    from tcgan_torch.run import common

    for mod, argv in ((tmm, TINY_MM + ["--solver", "bptt"]),
                      (tbw, TINY_GAN)):
        args = mod.make_parser().parse_args(
            argv + CPU + ["--parallel", "mesh", "--datastore", "x"])
        solver = getattr(args, "solver", "bptt")
        cfg = par.with_mesh_axes(
            common.generator_config_from_args(args, solver=solver),
            model=True)
        with pytest.raises(ValueError, match="set_mesh"):
            tgen.sample_tuning_curves(cfg, tgen.init_params(cfg), 4,
                                      z=np.zeros((4, 12, 12)))
    axis = tmesh.ModelAxis(0, 5, None, collections.Counter())
    with pytest.raises(ValueError, match="does not split over a model axis"):
        axis.cols(12)
