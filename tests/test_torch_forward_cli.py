"""The port's serving entry point, ``python -m tcgan_torch.run.forward``,
against ``tcgan_tpu.run.forward``: flag parity, artifacts, and the rules
that keep the device and the kernel from being hidden (no jax import, no CPU
fallback for ``--device cuda``, no kernel launches on CPU tensors)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tcgan_tpu.run import forward as jforward
from tcgan_torch.ops.cuda import ssn_solve
from tcgan_torch.run import forward as tforward

# the TINY flags of tests/test_cli.py
TINY = [
    "--N", "6", "--max-iter", "1500", "--atol", "1e-5",
    "--J", "0.02", "0.016", "0.02", "0.012",
    "--D", "0.05", "0.04", "0.05", "0.04",
    "--S", "0.25", "0.1", "0.25", "0.1",
    "--contrasts", "5", "--bandwidths", "0.25", "1.0",
    "--batch-size", "3",
]
PORT_CPU = ["--device", "cpu", "--solver-backend", "cuda"]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.choices)
            for a in parser._actions}


def test_parser_matches_reference_flags():
    ref = _options(jforward.make_parser())
    port = _options(tforward.make_parser())
    assert port.pop("device")[0] == ("--device",)
    assert ref.keys() == port.keys()
    for dest, (opts, choices) in ref.items():
        assert port[dest][0] == opts
        if dest != "solver_backend":
            assert port[dest][1] == choices, dest
    # the port's names, and the reference's for the same two backends,
    # stored as the port's
    assert port["solver_backend"][1] == ("torch", "cuda")
    assert ref["solver_backend"][1] == ("xla", "pallas")
    for ref_name, port_name in zip(ref["solver_backend"][1],
                                   port["solver_backend"][1]):
        args = tforward.make_parser().parse_args(
            ["--datastore", "x", "--solver-backend", ref_name])
        assert args.solver_backend == port_name


def _run(main, argv, path):
    rc = main(argv + ["--datastore", str(path)])
    assert rc == 0
    info = json.loads((path / "info.json").read_text())
    assert info["status"] == "finished"
    data = np.load(path / "tuning_curves.npz")
    return info, {k: data[k] for k in data.files}


@pytest.mark.parametrize("readout", [[], ["--track_offset_identity",
                                          "--sample-sites", "2"]])
def test_artifacts_match_reference(tmp_path, readout):
    j_info, j_data = _run(jforward.main, TINY + readout, tmp_path / "jax")
    before = ssn_solve.launches
    t_info, t_data = _run(tforward.main, TINY + readout + PORT_CPU,
                          tmp_path / "torch")
    assert t_data.keys() == j_data.keys()
    for k in j_data:
        assert t_data[k].shape == j_data[k].shape, k
        assert t_data[k].dtype == j_data[k].dtype, k
    assert t_data["converged"].all()
    t_sum, j_sum = t_info["summary"], j_info["summary"]
    assert set(t_sum) == set(j_sum) | {"kernel_launches"}
    for k in ("n_samples", "tc_dim", "n_devices"):
        assert t_sum[k] == j_sum[k]
    # on CPU tensors the wrapper runs its plain version: nothing launched
    assert t_sum["kernel_launches"] == 0 and ssn_solve.launches == before
    assert t_info["kernel_precision"] == ssn_solve.KERNEL_PRECISION == "3xtf32"
    assert t_info["config"]["solver_backend"] == "cuda"
    assert "torch" in t_info["library_versions"]


def test_serving_mode_draws_one_batch_each(tmp_path):
    info, data = _run(tforward.main, TINY + PORT_CPU + [
        "--batch-size", "4", "--total-samples", "10", "--seed", "3"],
        tmp_path / "fwd")
    assert data["tuning_curves"].shape == (12, 2)  # ceil(10/4) batches
    rates = data["rates"]
    assert not np.array_equal(rates[:4], rates[4:8])
    assert info["summary"]["stim_solves_per_sec"] > 0
    # the same seed gives the same data
    _, again = _run(tforward.main, TINY + PORT_CPU + [
        "--batch-size", "4", "--total-samples", "10", "--seed", "3"],
        tmp_path / "fwd2")
    np.testing.assert_array_equal(again["rates"], rates)


def test_device_cuda_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        tforward.main(TINY + ["--device", "cuda", "--datastore",
                              str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("flags,item", [
    (["--parallel", "mesh"], "parallel/mesh.py"),
    (["--solver", "bptt"], "ops/euler.py"),
])
def test_unported_modes_raise(tmp_path, flags, item):
    """Both modes are ported now. ``--parallel mesh`` (``parallel/mesh.py``)
    from a plain process on the CPU is one gloo rank: the same arrays as
    the unsharded run, bit for bit, and ``n_devices`` 1 (several ranks:
    ``tests/test_torch_parallel.py``). ``--solver bptt`` (ported, in
    ``ops/euler.py``) writes the reference's artifacts: the same arrays
    with the same shapes and dtypes, iters equal to ``--seqlen``, no kernel
    launch (the noise draws differ, so values are compared in
    ``tests/test_torch_generator.py``)."""
    if item == "parallel/mesh.py":
        info, mesh = _run(tforward.main, TINY + PORT_CPU + flags,
                          tmp_path / "mesh")
        _, plain = _run(tforward.main, TINY + PORT_CPU, tmp_path / "plain")
        assert info["summary"]["n_devices"] == 1
        assert mesh.keys() == plain.keys()
        for k in plain:
            np.testing.assert_array_equal(mesh[k], plain[k], err_msg=k)
        return
    argv = TINY + flags + ["--seqlen", "300", "--dt", "0.001"]
    _, j_data = _run(jforward.main, argv, tmp_path / "jax")
    t_info, t_data = _run(tforward.main, argv + PORT_CPU, tmp_path / "torch")
    assert t_data.keys() == j_data.keys()
    for k in j_data:
        assert t_data[k].shape == j_data[k].shape, k
        assert t_data[k].dtype == j_data[k].dtype, k
    assert (t_data["iters"] == 300).all()
    assert t_info["summary"]["kernel_launches"] == 0
    assert t_info["config"]["solver"] == "bptt"


def test_port_never_imports_jax():
    """Every module of the port, and ``chip_smoke``, imports neither JAX
    nor anything of the JAX package."""
    code = (
        "import pkgutil, sys, tcgan_torch\n"
        "for m in pkgutil.walk_packages(tcgan_torch.__path__, "
        "'tcgan_torch.'):\n"
        "    __import__(m.name)\n"
        "import tcgan_torch.run.forward\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules "
        "if k.startswith('jax'))\n"
        "assert not [k for k in sys.modules if k.startswith('tcgan_tpu')]\n"
        "print('ok')\n")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
