"""The port's binding of the native CPU baseline (``tcgan_torch.ops.native``,
built from ``csrc/ssnode.cpp`` into ``tcgan_torch/_build/``) against the
reference's (``tcgan_tpu.ops.native``) on the problem of
``tests/test_native.py``: the same C source, so bit for bit; and against the
port's lockstep solver in float64 (rtol 1e-6, atol 1e-7, as the reference's
cross-implementation test)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.ops import native as jnative
from tcgan_tpu.ops import ssn as jssn
from tcgan_tpu.ops import stimulus as jstim
from tcgan_tpu.ops import weights as jweights
from tcgan_torch.ops import fixed_point as tfp
from tcgan_torch.ops import native as tnative
from tcgan_torch.ops import ssn as tssn

SSN = dict(N=8, k=0.01, n=2.2, dt=0.001, max_iter=20000, atol=1e-8)


def _problem():
    cfg = jssn.SSNConfig(**SSN)
    J = jnp.array([[0.05, 0.04], [0.05, 0.03]], dtype=jnp.float64) * 0.5
    D = jnp.array([[0.1, 0.08], [0.1, 0.08]], dtype=jnp.float64)
    Ssp = jnp.array([[0.25, 0.1], [0.25, 0.1]], dtype=jnp.float64)
    x = cfg.site_pos(dtype=jnp.float64)
    z = jweights.sample_z(jax.random.PRNGKey(7), (4,), cfg.N,
                          dtype=jnp.float64)
    W = jweights.build_weight(J, D, Ssp, z, x)
    I = jstim.stimulus_battery((0.25, 1.0), (5.0,), x, cfg.smoothness)
    return cfg, np.asarray(W), np.asarray(I)


def test_binding_equals_the_reference_bit_for_bit():
    if not jnative.available():
        pytest.skip("the reference's native solver did not build")
    jcfg, W, I = _problem()
    ref = jnative.solve_fixed_point_native(jcfg, W, I)
    out = tnative.solve_fixed_point_native(tssn.SSNConfig(**SSN), W, I)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert out.converged.all()
    assert tnative.num_threads() == jnative.num_threads() >= 1


def test_binding_agrees_with_the_lockstep_solver():
    _, W, I = _problem()
    cfg = tssn.SSNConfig(**SSN)
    out = tnative.solve_fixed_point_native(cfg, torch.tensor(W),
                                           torch.tensor(I))
    ref = tfp.solve_fixed_point(cfg, torch.tensor(W), torch.tensor(I))
    np.testing.assert_array_equal(out.converged, ref.converged.numpy())
    np.testing.assert_allclose(out.r, ref.r.numpy(), rtol=1e-6, atol=1e-7)


def test_divergence_shapes_and_guards():
    cfg = tssn.SSNConfig(N=4, k=0.05, n=2.0, dt=0.001, max_iter=5000,
                         rate_stop_at=100.0)
    W = 5.0 * np.abs(np.random.default_rng(0).normal(size=(1, 8, 8)))
    assert tnative.solve_fixed_point_native(
        cfg, W, 30.0 * np.ones((1, 1, 8))).diverged.all()
    cfg = tssn.SSNConfig(N=4, max_iter=100, atol=1e-4)
    W = np.zeros((3, 8, 8))
    with pytest.raises(ValueError, match="batch mismatch"):
        tnative.solve_fixed_point_native(cfg, W, np.zeros((2, 2, 8)))
    with pytest.raises(ValueError, match="width"):
        tnative.solve_fixed_point_native(cfg, W, np.zeros((3, 2, 10)))
    res = tnative.solve_fixed_point_native(cfg, W, np.zeros((1, 2, 8)))
    assert res.r.shape == (3, 2, 8) and res.iters.dtype == np.int32
    res = tnative.solve_fixed_point_native(cfg, np.zeros((8, 8)),
                                           np.zeros((5, 2, 8)))
    assert res.r.shape == (5, 2, 8)
    with pytest.raises(NotImplementedError, match="Euler"):
        tnative.solve_fixed_point_native(
            dataclasses.replace(cfg, stepper="expo"), W, np.zeros((2, 8)))


def test_build_is_keyed_and_falls_back(monkeypatch, tmp_path):
    built = tnative.build()
    assert built.path.exists() and built.path.parent == tnative.BUILD_DIR
    assert tnative.cpu_model() and tnative.num_threads() >= 1
    # a compiler without OpenMP is passed over for the next one; with no
    # other, the build raises with its output (never a single-threaded one)
    cxx = tmp_path / "cxx"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && '
                   '{ echo "no libgomp.spec" >&2; exit 1; }; done\n'
                   f'exec {tnative._compilers()[0]} "$@"\n')
    cxx.chmod(0o755)
    real = tnative._compilers()
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_compilers", lambda: [str(cxx), *real])
    tnative.build.cache_clear()
    try:
        second = tnative.build()
        assert second.compiler == real[0] and second.path.exists()
        assert second.path.name == built.path.name  # the same flags' key
        second.path.unlink()
        monkeypatch.setattr(tnative, "_compilers", lambda: [str(cxx)])
        tnative.build.cache_clear()
        with pytest.raises(RuntimeError, match="no libgomp.spec"):
            tnative.build()
        assert not list((tmp_path / "build").glob("*.so"))
        monkeypatch.setattr(tnative, "_compilers", lambda: [])
        tnative.build.cache_clear()
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            tnative.build()
    finally:
        tnative.build.cache_clear()
