"""``tcgan_torch.analysis.uncertainty`` against
``tcgan_tpu.analysis.uncertainty``: ``calibration`` exactly, and
``run_uncertainty`` in float64 at a fitted point with the reference's noise
injected (the Jacobian's circuits and the covariance sample), rtol 1e-5 on
the error bars (the Jacobian agrees to ~1e-6, set by the adjoint's
bwd_atol); then the CLI on a tiny port ``run.gan`` datastore, against the
reference CLI's keys on the same run."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgan_tpu.analysis import uncertainty as junc
from tcgan_tpu.ops import weights as jweights
from tcgan_torch.analysis import uncertainty as tunc
from tests.test_torch_eval_cli import gan_run  # noqa: F401 (fixture)
from tests.test_torch_identifiability import D, J, S, SSN, _cfgs

N_CIRCUITS = 6


def _draw(seed, n):
    return np.array(jweights.sample_z(jax.random.PRNGKey(seed), (n,),
                                      SSN["N"], dtype=jnp.float64))


def _close_tree(a, b, rtol, path=""):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _close_tree(a[k], b[k], rtol, f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close_tree(x, y, rtol, f"{path}[{i}]")
    elif isinstance(b, (bool, str)) or b is None:
        assert a == b, path
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol, err_msg=path)


def test_run_uncertainty_matches_reference():
    jg, tg = _cfgs()
    fitted = {"J": np.asarray(J) * 1.05, "D": np.asarray(D) * 0.97,
              "S": np.asarray(S)}
    true = {k: np.asarray(v) for k, v in zip("JDS", (J, D, S))}
    kw = dict(true=true, n_circuits=N_CIRCUITS, seed=2, n_boot=32)
    jrep = junc.run_uncertainty(jg, fitted, 1024, **kw)
    trep = tunc.run_uncertainty(tg, fitted, 1024, **kw,
                                z_jac=_draw(2, N_CIRCUITS),
                                z_cov=_draw(3, 128))
    assert trep["n_surviving_circuits"] == jrep["n_surviving_circuits"]
    assert trep["frac_converged"] == jrep["frac_converged"]
    # per-direction components are signed eigenvectors: compare the
    # sign-free parts, then the calibration's verdict
    for key in ("fitted_params", "true_params", "n_circuits"):
        assert trep[key] == jrep[key]
    tp, jp = trep["expected_precision"], jrep["expected_precision"]
    assert tp["n_constrained_directions"] == jp["n_constrained_directions"]
    _close_tree(tp["per_param_std"], jp["per_param_std"], 1e-5)
    _close_tree([d["std"] for d in tp["directions"]],
                [d["std"] for d in jp["directions"]], 1e-5)
    tc, jc = trep["calibration"], jrep["calibration"]
    _close_tree(tc["z_scores"], jc["z_scores"], 1e-5)
    _close_tree(tc["max_abs_z_constrained"], jc["max_abs_z_constrained"],
                1e-5)
    assert tc["verdict"] == jc["verdict"]
    _close_tree({k: trep["fit_decomposition"][k] for k in
                 ("identifiable_error", "unidentifiable_error", "raw_error",
                  "n_identifiable")},
                {k: jrep["fit_decomposition"][k] for k in
                 ("identifiable_error", "unidentifiable_error", "raw_error",
                  "n_identifiable")}, 1e-5)


def test_calibration_equals_reference():
    rng = np.random.default_rng(0)
    names = junc.PARAM_NAMES
    V = np.linalg.qr(rng.normal(size=(12, 12)))[0]
    precision = {
        "per_param_std": {n: float(v) for n, v in
                          zip(names, rng.uniform(0.01, 0.5, 12))},
        "directions": [{"std": float(s), "direction": dict(zip(names, v))}
                       for s, v in zip([0.02, 0.1, np.inf] + [0.3] * 9,
                                       V.T)]}
    precision["per_param_std"]["S_II"] = float("inf")
    fit = {k: rng.uniform(0.05, 0.5, (2, 2)) for k in "JDS"}
    true = {k: rng.uniform(0.05, 0.5, (2, 2)) for k in "JDS"}
    assert tunc.calibration(fit, true, precision) == \
        junc.calibration(fit, true, precision)


def test_cli_writes_the_reference_keys(gan_run, tmp_path, capsys):  # noqa
    common = ["--run", str(gan_run), "--n-circuits", "16", "--n-boot", "16"]
    rc_t = tunc.main(common + ["--device", "cpu", "-o",
                               str(tmp_path / "t.json")])
    rc_j = junc.main(common + ["--solver-backend", "xla", "-o",
                               str(tmp_path / "j.json")])
    capsys.readouterr()
    assert rc_t == rc_j == 0
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    t.pop("config_overrides", None)
    j.pop("config_overrides", None)
    assert t.keys() == j.keys()
    assert t["n_data"] == j["n_data"] == 8
    assert t["fitted_params"] == j["fitted_params"]
    assert t["calibration"].keys() == j["calibration"].keys()


def test_cli_refuses_a_missing_card(gan_run):  # noqa: F811
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tunc.main(["--run", str(gan_run)])
