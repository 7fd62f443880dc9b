"""``tcgan_torch.analysis.identifiability`` against
``tcgan_tpu.analysis.identifiability`` in float64 on a tiny battery (N=6,
4 stimuli, 8 moments): the moment map and its Jacobian with the reference's
noise injected (rtol 1e-6, set by the adjoint's bwd_atol 1e-6), chunked
and unchunked (the chunk is one adjoint solve with a stop rule per
cotangent, so chunking changes nothing but roundoff); the NumPy parts
exactly; the CLI's JSON keys."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.analysis import identifiability as jidf
from tcgan_tpu.models import generator as jgen
from tcgan_tpu.ops import ssn as jssn
from tcgan_tpu.ops import weights as jweights
from tcgan_torch.analysis import identifiability as tidf
from tcgan_torch.models import generator as tgen
from tcgan_torch.ops import ssn as tssn

SSN = dict(N=6, k=0.005, n=2.0, dt=0.001, max_iter=3000, atol=1e-8,
           check_every=8)
GEN = dict(bandwidths=(0.25, 1.0), contrasts=(5.0, 10.0))
J = ((0.02, 0.016), (0.02, 0.012))
D = ((0.05, 0.04), (0.05, 0.04))
S = ((0.25, 0.1), (0.25, 0.1))
N_CIRCUITS = 6


def _cfgs(**gen_kw):
    jg = jgen.GeneratorConfig(ssn=jssn.SSNConfig(**SSN), dtype=jnp.float64,
                              **{**GEN, **gen_kw})
    tg = tgen.GeneratorConfig(ssn=tssn.SSNConfig(**SSN), dtype=torch.float64,
                              **{**GEN, **gen_kw})
    return jg, tg


def _z(seed=0, n=N_CIRCUITS):
    return np.array(jweights.sample_z(jax.random.PRNGKey(seed), (n,),
                                      SSN["N"], dtype=jnp.float64))


@pytest.fixture(scope="module")
def reference_jacobian():
    jg, _ = _cfgs()
    return jidf.moment_jacobian(jg, J, D, S, n_circuits=N_CIRCUITS, seed=0)


def test_moment_fn_matches_reference():
    jg, tg = _cfgs(sample_sites=2, include_inhibitory_neurons=True)
    theta = np.log(np.concatenate([np.ravel(p) for p in (J, D, S)]))
    jm = jidf.moment_fn(jg, jnp.asarray(theta), jnp.asarray(_z()))
    tm = tidf.moment_fn(tg, torch.tensor(theta), _z())
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-10)


@pytest.mark.parametrize("chunk", [None, 3])
def test_moment_jacobian_matches_reference(reference_jacobian, chunk):
    jjac, jmom = reference_jacobian
    _, tg = _cfgs()
    tjac, tmom = tidf.moment_jacobian(tg, J, D, S, chunk=chunk, z=_z())
    assert tjac.shape == jjac.shape == (8, 12)
    np.testing.assert_allclose(tmom, jmom, rtol=1e-10)
    np.testing.assert_allclose(tjac, jjac, rtol=1e-6,
                               atol=1e-6 * np.abs(jjac).max())


def test_chunking_changes_only_roundoff():
    _, tg = _cfgs()
    a, _ = tidf.moment_jacobian(tg, J, D, S, chunk=None, z=_z(1))
    b, _ = tidf.moment_jacobian(tg, J, D, S, chunk=3, z=_z(1))
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


def test_battery_score_and_numpy_parts_equal_reference(reference_jacobian):
    jac, moments = reference_jacobian
    jg, tg = _cfgs()
    jrep = jidf.battery_score(jg, J, D, S, n_circuits=N_CIRCUITS, seed=0,
                              jac=jac, moments=moments)
    trep = tidf.battery_score(tg, J, D, S, n_circuits=N_CIRCUITS, seed=0,
                              jac=jac, moments=moments, z=_z())
    assert trep == jrep
    rng = np.random.default_rng(3)
    tc = rng.normal(1.0, 0.3, (40, 4))
    C_t = tidf.bootstrap_moment_cov(tc, n_boot=32, seed=1)
    C_j = jidf.bootstrap_moment_cov(tc, n_boot=32, seed=1)
    np.testing.assert_array_equal(C_t, C_j)
    assert tidf.expected_precision(jac, C_t, 512) == \
        jidf.expected_precision(jac, C_j, 512)
    fit = {k: np.asarray(v) * 1.1 for k, v in zip("JDS", (J, D, S))}
    true = {k: np.asarray(v) for k, v in zip("JDS", (J, D, S))}
    assert tidf.subspace_errors(jac, fit, true) == \
        jidf.subspace_errors(jac, fit, true)
    traj = {k: np.stack([v, v * 1.05]) for k, v in fit.items()}
    for a, b in zip(tidf.subspace_trajectory(jac, traj, true).values(),
                    jidf.subspace_trajectory(jac, traj, true).values()):
        np.testing.assert_array_equal(a, b)
    assert tidf.identifiability_report(jac) == \
        jidf.identifiability_report(jac)
    for fn in ("mean_rectified_strength", "var_rectified_strength",
               "dale_ridge_direction"):
        np.testing.assert_array_equal(getattr(tidf, fn)(J, D),
                                      getattr(jidf, fn)(J, D))
    assert tidf.PARAM_NAMES == jidf.PARAM_NAMES


def test_cli_writes_the_reference_keys(tmp_path, capsys):
    common = ["--N", "6", "--k", "0.005", "--n", "2.0", "--dt", "0.001",
              "--max-iter", "3000", "--J", *map(str, np.ravel(J)),
              "--D", *map(str, np.ravel(D)), "--S", *map(str, np.ravel(S)),
              "--bandwidths", "0.25", "1.0", "--n-circuits", "4",
              "--contrast-sets", "5;5,10", "--data-samples", "64",
              "--fitted-J", *map(str, 1.1 * np.ravel(J)),
              "--fitted-D", *map(str, np.ravel(D)),
              "--fitted-S", *map(str, np.ravel(S)), "--dtype", "float64"]
    assert tidf.main(common + ["--device", "cpu", "--output",
                               str(tmp_path / "t.json"), "--save-jacobian",
                               str(tmp_path / "t.npz")]) == 0
    assert jidf.main(common + ["--device", "cpu", "--output",
                               str(tmp_path / "j.json"), "--save-jacobian",
                               str(tmp_path / "j.npz")]) == 0
    capsys.readouterr()
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    assert t.keys() == j.keys()
    assert t["analytic_dale_ridge"] == j["analytic_dale_ridge"]
    assert len(t["batteries"]) == len(j["batteries"]) == 2
    for bt, bj in zip(t["batteries"], j["batteries"]):
        assert bt.keys() == bj.keys()
        assert bt["contrasts"] == bj["contrasts"]
        assert all(np.isfinite(bt[k]) for k in ("sigma_min",
                                                 "condition_number",
                                                 "circuit_yield"))
    assert np.load(tmp_path / "t.npz").files == \
        np.load(tmp_path / "j.npz").files
