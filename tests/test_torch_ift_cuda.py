"""Implicit gradients through the SSN solver kernel on a CUDA device.

The gradient of the mean probe rate with respect to the log-space
(J, D, S), with the kernel forward against the plain forward (the lockstep
solve) under the same iterative adjoint, as ``chip_smoke.py`` phase 5 does
at 256 circuits. Every test carries the ``cuda`` marker and skips where no
CUDA device is visible; the file imports no jax:

    python -m pytest tests/test_torch_ift_cuda.py -m cuda -q

Tolerance: flags equal; gradients to 1e-2 of the largest entry (the
forward rates agree to rtol 1e-4, which the adjoint can amplify near
criticality; 2e-7 was measured at 256 circuits on an H100).
"""

import pytest
import torch

from tcgan_torch.models import generator as gen_lib
from tcgan_torch.ops import ift, weights
from tcgan_torch.ops.ssn import SSNConfig
from tcgan_torch.utils import profiling

TRUE = (((0.045, 0.04), (0.05, 0.035)), ((0.1, 0.08), (0.1, 0.08)),
        ((0.25, 0.1), (0.25, 0.1)))
GEN = dict(bandwidths=(0.0, 0.0625, 0.125, 0.1875, 0.25, 0.5, 0.75, 1.0),
           contrasts=(5.0, 10.0))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _grads(device, backend, B=16):
    cfg = gen_lib.GeneratorConfig(
        ssn=SSNConfig(N=51, max_iter=10000, atol=1e-5, check_every=32,
                      backend=backend), **GEN)
    params = {k: v.requires_grad_(True) for k, v in
              gen_lib.init_params(cfg, *TRUE, device=device).items()}
    z = weights.sample_z(torch.Generator(device).manual_seed(0), (B,), 51,
                         device=device)
    out = gen_lib.sample_tuning_curves(cfg, params, B, z=z)
    g = torch.autograd.grad(out.tc.mean(), list(params.values()))
    torch.cuda.synchronize()
    return out, torch.cat([t.reshape(-1) for t in g])


@pytest.mark.cuda
def test_kernel_forward_gradients_match_plain_forward(cuda_device):
    ift.adjoint_iterations = 0
    # the stop test's syncs are counted while a profiler runs
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out_k, g_k = _grads(cuda_device, "cuda")
    iters = ift.adjoint_iterations
    syncs = profiling.counters()["host_syncs.ift.stop_test"]
    out_p, g_p = _grads(cuda_device, "torch")
    assert out_k.rates.dtype == torch.float32
    assert torch.equal(out_k.converged, out_p.converged)
    assert out_k.converged.all()
    assert torch.isfinite(g_k).all() and g_k.abs().max() > 0
    assert float((g_k - g_p).abs().max()) <= 1e-2 * float(g_p.abs().max())
    assert iters > 0 and syncs == -(-iters // ift.DEFAULT_CHECK_STRIDE)


@pytest.mark.cuda
def test_adjoint_stride_does_not_change_gradient_on_card(cuda_device):
    cfg = SSNConfig(N=51, max_iter=10000, atol=1e-5, check_every=32,
                    backend="cuda")
    gcfg = gen_lib.GeneratorConfig(ssn=cfg, **GEN)
    z = weights.sample_z(torch.Generator(cuda_device).manual_seed(1), (8,),
                         51, device=cuda_device)
    with torch.no_grad():
        J, D, S = gen_lib.param_values(
            gcfg, gen_lib.init_params(gcfg, *TRUE, device=cuda_device))
        W = weights.build_weight(J, D, S, z, cfg.site_pos(device=cuda_device))
        I = gcfg.stimulus_battery(cuda_device)
    res = ift.solve_fixed_point_implicit(cfg, W, I)
    g = torch.randn(res.r.shape, generator=torch.Generator(
        cuda_device).manual_seed(2), device=cuda_device) * 1e-3
    saved = (W, I, res.r, res.converged)
    a = ift._bwd(cfg, "iterative", 20000, 1e-6, saved, g, check_stride=1)
    b = ift._bwd(cfg, "iterative", 20000, 1e-6, saved, g, check_stride=100)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
