"""Port parity: io functions, SSN config, weight builder and stimulus battery
of ``tcgan_torch`` against ``tcgan_tpu`` on identical NumPy inputs (f64,
rtol 1e-10: the same formulas, differing only in rounding order; atol
1e-12 because 1 - tanh**2 and 0.5 * (tanh + 1) cancel, which makes their
rounding absolute, ~1e-15)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.ops import io_funs as jio
from tcgan_tpu.ops import ssn as jssn
from tcgan_tpu.ops import stimulus as jstim
from tcgan_tpu.ops import weights as jw
from tcgan_torch.ops import io_funs as tio
from tcgan_torch.ops import ssn as tssn
from tcgan_torch.ops import stimulus as tstim
from tcgan_torch.ops import weights as tw

F64 = torch.float64
RTOL = 1e-10
ATOL = 1e-12


def _t(a):
    return torch.tensor(np.array(a, copy=True), dtype=F64)


def _close(t_out, j_out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("io_type", jio.IO_TYPES)
def test_io_fun_and_deriv_match(io_type):
    # u spans the rectified, power-law and saturating / linear branches
    u = np.random.default_rng(0).uniform(-5.0, 140.0, size=(3, 257))
    args = dict(k=0.01, n=2.2, r0=20.0, r1=60.0)
    _close(tio.make_io_fun(io_type, **args)(_t(u)),
           jio.make_io_fun(io_type, **args)(jnp.asarray(u)))
    _close(tio.make_io_deriv(io_type, **args)(_t(u)),
           jio.make_io_deriv(io_type, **args)(jnp.asarray(u)))


def test_rate_to_volt_matches():
    r = np.random.default_rng(1).uniform(-1.0, 300.0, size=64)
    _close(tio.rate_to_volt(_t(r), 0.01, 2.2),
           jio.rate_to_volt(jnp.asarray(r), 0.01, 2.2))


@pytest.mark.parametrize("stepper", ["euler", "expo"])
def test_step_gain_and_tau_match(stepper):
    kw = dict(N=5, dt=0.001, stepper=stepper)
    tcfg, jcfg = tssn.SSNConfig(**kw), jssn.SSNConfig(**kw)
    _close(tcfg.step_gain(dtype=F64), jcfg.step_gain(dtype=jnp.float64))
    _close(tcfg.tau_vector(dtype=F64), jcfg.tau_vector(dtype=jnp.float64))
    _close(tcfg.site_pos(dtype=F64), jcfg.site_pos(dtype=jnp.float64))


def test_ssn_config_fields_and_validation():
    t_fields = [f.name for f in tssn.SSNConfig.__dataclass_fields__.values()]
    j_fields = [f.name for f in jssn.SSNConfig.__dataclass_fields__.values()]
    assert t_fields == j_fields
    for bad in (dict(io_type="relu"), dict(init="warm"),
                dict(accel="broyden"), dict(backend="tpu"),
                dict(io_type="asym_tanh", rate_soft_bound=5.0,
                     rate_hard_bound=5.0)):
        with pytest.raises(ValueError):
            tssn.SSNConfig(**bad)
    # the reference's backend names are stored as the port's
    assert tssn.SSNConfig(backend="pallas").backend == "cuda"
    assert tssn.SSNConfig(backend="xla").backend == "torch"


def test_recurrent_drive_matches():
    rng = np.random.default_rng(2)
    W = rng.normal(size=(3, 10, 10))
    r = rng.uniform(size=(3, 4, 10))
    I = rng.uniform(size=(4, 10))
    _close(tssn.recurrent_drive(_t(W), _t(r), _t(I)),
           jssn.recurrent_drive(jnp.asarray(W), jnp.asarray(r),
                                jnp.asarray(I)))


def test_build_weight_matches():
    rng = np.random.default_rng(3)
    N, B = 6, 4
    J = np.array([[0.045, 0.04], [0.05, 0.035]])
    D = np.array([[0.1, 0.08], [0.1, 0.08]])
    S = np.array([[0.25, 0.1], [0.25, 0.1]])
    z = rng.standard_normal((B, 2 * N, 2 * N))
    x = np.linspace(-0.5, 0.5, N)
    W_t = tw.build_weight(_t(J), _t(D), _t(S), _t(z), _t(x))
    W_j = jw.build_weight(jnp.asarray(J), jnp.asarray(D), jnp.asarray(S),
                          jnp.asarray(z), jnp.asarray(x))
    _close(W_t, W_j)
    # Dale: E columns non-negative, I columns non-positive
    assert (W_t[..., :N] >= 0).all() and (W_t[..., N:] <= 0).all()
    _close(tw.presynaptic_sign(N, dtype=F64),
           jw.presynaptic_sign(N, dtype=jnp.float64))
    for t_m, j_m in zip(tw.block_matrices(_t(J), _t(D), _t(S), N),
                        jw.block_matrices(J, D, S, N)):
        _close(t_m, j_m)


def test_sample_z_shape_and_seed():
    g1 = torch.Generator("cpu").manual_seed(7)
    g2 = torch.Generator("cpu").manual_seed(7)
    z1 = tw.sample_z(g1, (3,), 4, device="cpu", dtype=F64)
    z2 = tw.sample_z(g2, (3,), 4, device="cpu", dtype=F64)
    assert z1.shape == (3, 8, 8) and z1.dtype == F64
    assert torch.equal(z1, z2)


def test_stimulus_battery_and_features_match():
    x = np.linspace(-0.5, 0.5, 7)
    bws, cs = (0.0, 0.25, 0.5, 1.0), (5.0, 10.0, 13.0)
    I_t = tstim.stimulus_battery(bws, cs, _t(x), 0.03125)
    I_j = jstim.stimulus_battery(bws, cs, jnp.asarray(x), 0.03125)
    assert I_t.shape == (12, 14)
    _close(I_t, I_j)
    _close(tstim.condition_features(bws, cs, dtype=F64),
           jstim.condition_features(bws, cs, dtype=jnp.float64))
    _close(tstim.smooth_box(_t(x), 0.3, 0.05),
           jstim.smooth_box(jnp.asarray(x), 0.3, 0.05))
