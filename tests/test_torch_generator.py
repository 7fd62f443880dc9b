"""Port parity for the whole forward slice: ``sample_tuning_curves`` of
``tcgan_torch`` against ``tcgan_tpu`` on the same parameters and the same
NumPy noise z.

On the JAX side the noise is injected by patching
``tcgan_tpu.models.generator.weights.sample_z`` in the test; the port takes
``z`` as an argument. Parameters go through ``params_from_numpy``.

- lockstep backends (``xla`` against ``torch``) in f64: rtol 1e-10, flags
  and iters equal;
- kernel backends (``pallas`` in interpret mode, single phase, against
  ``cuda``, whose CPU path is the plain fp32 version) in f32: flags equal,
  rtol 1e-4, atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcgan_tpu.models.generator as jgen
from tcgan_tpu.ops import ssn as jssn
from tcgan_torch.models import generator as tgen
from tcgan_torch.ops import ssn as tssn

SSN = dict(N=6, max_iter=1500, atol=1e-5, check_every=4)
J = ((0.02, 0.016), (0.02, 0.012))
D = ((0.05, 0.04), (0.05, 0.04))
S = ((0.25, 0.1), (0.25, 0.1))
GEN = dict(bandwidths=(0.25, 1.0), contrasts=(5.0, 10.0))
B = 4
READOUTS = {
    "plain": {},
    "track_offset_identity": dict(track_offset_identity=True,
                                  sample_sites=2),
    "inhibitory": dict(include_inhibitory_neurons=True, sample_sites=2),
    "antithetic": dict(antithetic=True),
}
BACKENDS = {  # JAX backend -> (port backend, dtypes, rtol, atol)
    "xla": ("torch", (jnp.float64, torch.float64), 1e-10, 0.0),
    "pallas": ("cuda", (jnp.float32, torch.float32), 1e-4, 1e-5),
}


def _configs(jax_backend, readout):
    port_backend, (jdt, tdt), _, _ = BACKENDS[jax_backend]
    jcfg = jgen.GeneratorConfig(
        ssn=jssn.SSNConfig(**SSN, backend=jax_backend, pallas_two_phase=False,
                           pallas_block_b=4),
        dtype=jdt, **GEN, **READOUTS[readout])
    tcfg = tgen.GeneratorConfig(
        ssn=tssn.SSNConfig(**SSN, backend=port_backend,
                           pallas_two_phase=False), dtype=tdt, **GEN,
        **READOUTS[readout])
    return jcfg, tcfg


@pytest.mark.parametrize("readout", sorted(READOUTS))
@pytest.mark.parametrize("jax_backend", sorted(BACKENDS))
def test_sample_tuning_curves_matches_jax(monkeypatch, jax_backend, readout):
    jcfg, tcfg = _configs(jax_backend, readout)
    _, (jdt, tdt), rtol, atol = BACKENDS[jax_backend]
    n_draw = B // 2 if jcfg.antithetic else B
    z = np.random.default_rng(3).standard_normal(
        (n_draw, 2 * SSN["N"], 2 * SSN["N"]))
    monkeypatch.setattr(
        jgen.weights, "sample_z",
        lambda key, shape, N, dtype=jnp.float32: jnp.asarray(z, dtype))
    jparams = jgen.init_params(jcfg, J, D, S)
    ref = jgen.sample_tuning_curves(jcfg, jparams, jax.random.PRNGKey(0), B)

    tparams = tgen.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, dtype=tdt)
    with torch.no_grad():
        out = tgen.sample_tuning_curves(tcfg, tparams, B, z=z)

    assert tuple(out.tc.shape) == ref.tc.shape
    assert out.tc.shape[-1] == tcfg.tc_dim == jcfg.tc_dim
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.diverged.numpy(),
                                  np.asarray(ref.diverged))
    assert out.converged.all()
    if jax_backend == "xla":
        np.testing.assert_array_equal(out.iters.numpy(),
                                      np.asarray(ref.iters))
    for name in ("tc", "rates"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol)
    if jcfg.antithetic:  # (+z, -z) pairs
        assert not torch.equal(out.rates[:B // 2], out.rates[B // 2:])


def test_generator_draws_from_torch_generator():
    _, tcfg = _configs("xla", "plain")
    params = tgen.init_params(tcfg, J, D, S)
    with torch.no_grad():
        a = tgen.sample_tuning_curves(
            tcfg, params, B, generator=torch.Generator().manual_seed(1))
        b = tgen.sample_tuning_curves(
            tcfg, params, B, generator=torch.Generator().manual_seed(1))
    assert a.tc.shape == (B, tcfg.n_stim)
    assert torch.equal(a.rates, b.rates)


def test_params_config_and_penalty_match_jax():
    jcfg, tcfg = _configs("xla", "plain")
    t_fields = [f.name for f in dataclasses.fields(tgen.GeneratorConfig)]
    j_fields = [f.name for f in dataclasses.fields(jgen.GeneratorConfig)]
    assert t_fields == j_fields
    for space in ("log", "raw"):
        jc = dataclasses.replace(jcfg, param_space=space)
        tc = dataclasses.replace(tcfg, param_space=space)
        jp = jgen.init_params(jc, J, D, S)
        tp = tgen.init_params(tc, J, D, S)
        for name in ("J", "D", "S"):
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                       rtol=1e-12)
        for t_v, j_v, n_v in zip(tgen.param_values(tc, tp),
                                 jgen.param_values(jc, jp),
                                 tgen.param_values_np(tc, tp)):
            np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v),
                                       rtol=1e-12)
            np.testing.assert_allclose(n_v, np.asarray(j_v), rtol=1e-12)
    np.testing.assert_array_equal(
        tgen.GeneratorConfig(include_inhibitory_neurons=True,
                             sample_sites=3).probe_indices().numpy(),
        np.asarray(jgen.GeneratorConfig(include_inhibitory_neurons=True,
                                        sample_sites=3).probe_indices()))
    rates = np.random.default_rng(4).uniform(0.0, 250.0, (3, 2, 12))
    np.testing.assert_allclose(
        tgen.rate_penalty(tcfg, torch.tensor(rates)).item(),
        float(jgen.rate_penalty(jcfg, jnp.asarray(rates))), rtol=1e-12)


def test_gradients_flow_through_the_fixed_point():
    """solver="ift": the parameters get gradients through the implicit
    solve (parity with the reference: tests/test_torch_wgan.py)."""
    _, tcfg = _configs("xla", "plain")
    params = {k: v.clone().requires_grad_() for k, v in
              tgen.init_params(tcfg, J, D, S).items()}
    z = np.random.default_rng(5).standard_normal((B, 12, 12))
    out = tgen.sample_tuning_curves(tcfg, params, B, z=z)
    out.tc.sum().backward()
    for v in params.values():
        assert torch.isfinite(v.grad).all() and v.grad.abs().max() > 0


def test_unported_paths_raise(monkeypatch):
    """Mesh axes outside an active mesh raise (sharding itself runs in
    ``tests/test_torch_parallel.py``); solver="bptt" (ported) matches the
    reference's Euler unroll in f64 at rtol 1e-10, flags equal."""
    jcfg, tcfg = _configs("xla", "plain")
    params = tgen.init_params(tcfg, J, D, S)
    z = np.random.default_rng(6).standard_normal((B, 12, 12))
    monkeypatch.setattr(
        jgen.weights, "sample_z",
        lambda key, shape, N, dtype=jnp.float32: jnp.asarray(z, dtype))
    bptt = dict(solver="bptt", ssn=dataclasses.replace(tcfg.ssn, seqlen=120))
    ref = jgen.sample_tuning_curves(
        dataclasses.replace(jcfg, solver="bptt", ssn=dataclasses.replace(
            jcfg.ssn, seqlen=120)),
        jgen.init_params(jcfg, J, D, S), jax.random.PRNGKey(0), B)
    with torch.no_grad():
        out = tgen.sample_tuning_curves(dataclasses.replace(tcfg, **bptt),
                                        params, B, z=z)
    np.testing.assert_allclose(out.tc.numpy(), np.asarray(ref.tc),
                               rtol=1e-10)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    assert (out.iters == 120).all()
    with pytest.raises(ValueError, match="set_mesh"):
        tgen.sample_tuning_curves(dataclasses.replace(tcfg, mesh_axis="b"),
                                  params, B, z=z)
    with pytest.raises(ValueError, match="even batch"):
        tgen.sample_tuning_curves(
            dataclasses.replace(tcfg, antithetic=True), params, 3,
            z=np.zeros((1, 12, 12)))
