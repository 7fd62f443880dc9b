"""Port parity for the critic: ``tcgan_torch.models.critic`` against
``tcgan_tpu.models.critic`` with the reference's parameters carried across
(``params_from_numpy``), in f64: rtol 1e-12 (the same dense layers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.models import critic as jcritic
from tcgan_torch.models import critic as tcritic

SCALE = (1.0, 2.0, 0.5)


def _params():
    ccfg = jcritic.CriticConfig(in_dim=3, layers=(16, 16), input_scale=SCALE,
                                dtype=jnp.float64)
    jp = jcritic.init_params(ccfg, jax.random.PRNGKey(0))
    tp = tcritic.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   dtype=torch.float64)
    return ccfg, jp, tp


@pytest.mark.parametrize("act", ["relu", "tanh", "gelu"])
@pytest.mark.parametrize("scaled", [True, False])
def test_apply_matches_jax(act, scaled):
    ccfg, jp, tp = _params()
    scale = SCALE if scaled else None
    jc = dataclasses.replace(ccfg, activation=act, input_scale=scale)
    tc = tcritic.CriticConfig(in_dim=3, layers=(16, 16), activation=act,
                              input_scale=scale, dtype=torch.float64)
    x = np.random.default_rng(2).normal(size=(5, 3))
    out = tcritic.apply(tc, tp, torch.tensor(x))
    assert out.shape == (5,)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jcritic.apply(jc, jp,
                                                        jnp.asarray(x))),
                               rtol=1e-12)
    # fp32 inputs (the kernel's rates) promote to the params' f64, as
    # jnp's matmul does
    out32 = tcritic.apply(tc, tp, torch.tensor(x, dtype=torch.float32))
    assert out32.dtype == torch.float64
    np.testing.assert_allclose(out32.numpy(), out.numpy(), rtol=1e-6)


def test_param_stats_and_init_match_jax():
    ccfg, jp, tp = _params()
    stats = tcritic.param_stats(tp)
    assert list(stats) == list(jcritic.param_stats(jp))
    for k, v in jcritic.param_stats(jp).items():
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(v),
                                   rtol=1e-12, err_msg=k)
    # He init: the reference's shapes, zero biases, std sqrt(2 / fan_in)
    cfg = tcritic.CriticConfig(in_dim=3, layers=(64, 64))
    t0 = tcritic.init_params(cfg, torch.Generator().manual_seed(0))
    j0 = jcritic.init_params(jcritic.CriticConfig(in_dim=3, layers=(64, 64)),
                             jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in t0.items()} == \
        {k: v.shape for k, v in j0.items()}
    assert t0["w1"].dtype == torch.float32 and not t0["b0"].any()
    assert abs(float(t0["w1"].std()) / np.sqrt(2 / 64) - 1) < 0.1
