"""The plain reference on tiny shapes on the CPU: the solve's semantics,
the implicit gradient against the gradient of a long unrolled Euler run,
Adam and the gradient penalty by hand."""

import math

import pytest
import torch

from benchmark.reference import ssn
from benchmark.reference import wgan as ref_wgan

CIRCUIT = dict(N=4, k=0.01, n=2.2, tau_E=0.016, tau_I=0.002, dt=0.0005,
               io_type="asym_power", rate_soft_bound=100.0,
               rate_stop_at=200.0, L=1.0, smoothness=0.03125,
               check_every=8, bandwidths=[0.0, 0.5])
TRUTH = ([0.2, 0.16, 0.2, 0.14], [0.4, 0.32, 0.4, 0.32], [0.25, 0.1, 0.25, 0.1])


def _problem(B=3, contrasts=(10.0,), seed=0):
    z = torch.randn((B, 8, 8), generator=torch.Generator().manual_seed(seed))
    return ssn.circuit_inputs(CIRCUIT, *TRUTH, z, contrasts)


def test_solve_converges_to_a_fixed_point():
    W, I = _problem()
    r, conv, div, iters = ssn.solve(CIRCUIT, W, I, atol=1e-5, max_iter=4000,
                                    check_every=8)
    assert bool(conv.all()) and not bool(div.any())
    assert bool((iters % 8 == 0).all())
    assert float(ssn.residual64(CIRCUIT, W, I, r).max()) < 3e-5


def test_a_row_does_not_depend_on_its_batch():
    """Lockstep with frozen resolved rows: a circuit solved alone gives the
    batch's rates, flags and iters bit for bit."""
    W, I = _problem(B=4, contrasts=(5.0, 20.0))
    whole = ssn.solve(CIRCUIT, W, I, atol=1e-5, max_iter=4000, check_every=8)
    alone = ssn.solve(CIRCUIT, W[2:3], I, atol=1e-5, max_iter=4000,
                      check_every=8)
    for a, b in zip(whole, alone):
        assert torch.equal(a[2:3], b)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    assert ssn.round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                          -3.0]


def test_implicit_gradient_matches_a_long_unroll():
    """d loss / d log(J, D, S) through the fixed point, against autograd
    through 6000 Euler steps from zero (past convergence)."""
    W0, I = _problem(B=2)
    z = torch.randn((2, 8, 8), generator=torch.Generator().manual_seed(0))
    critic = {"w0": torch.full((2, 1), 0.3), "b0": torch.zeros(1)}
    fit = dict(atol=2e-6, max_iter=20000, rate_cost=0.01, bwd_atol=1e-10,
               bwd_max_iter=50000)
    log = {k: torch.log(torch.tensor(v).reshape(2, 2))
           for k, v in zip("JDS", TRUTH)}
    loss, grad, _ = ref_wgan.generator_grad(CIRCUIT, fit, log, critic, z, I,
                                            None, "fp32")
    leaves = {k: v.clone().requires_grad_(True) for k, v in log.items()}
    x = ssn.site_positions(4, 1.0)
    W = ssn.weights(*ref_wgan.values(leaves), z, x)
    alpha = ssn.gain(CIRCUIT)
    r = torch.zeros((2, 2, 8))
    for _ in range(6000):
        r = r + alpha * (ssn.rate_fn(r @ W.transpose(-1, -2) + I, 0.01, 2.2)
                         - r)
    d = ref_wgan.critic_apply(critic, ssn.tuning_curves(CIRCUIT, r), None,
                              "fp32")
    unrolled = -d.mean() + 0.01 * (torch.relu(r - 100) ** 2).mean() / 1e4
    want = torch.autograd.grad(unrolled, list(leaves.values()))
    assert float(loss) == pytest.approx(float(unrolled.detach()), rel=1e-4)
    for k, w in zip(leaves, want):
        torch.testing.assert_close(grad[k], w, rtol=2e-3, atol=1e-7)


def test_adam_by_hand():
    p = {"a": torch.tensor([1.0, 2.0])}
    g = {"a": torch.tensor([3.0, 4.0])}
    new, st = ref_wgan.adam_update(p, g, ref_wgan.adam_init(p), lr=0.1,
                                   b1=0.5, b2=0.9, clip=1.0)
    gc = torch.tensor([0.6, 0.8])  # clipped to norm 1
    torch.testing.assert_close(st.mu["a"], 0.5 * gc)
    torch.testing.assert_close(st.nu["a"], 0.1 * gc ** 2)
    # count 1: the bias-corrected step is g / (|g| + eps)
    torch.testing.assert_close(new["a"], p["a"] - 0.1 * gc / (gc + 1e-8))
    bad = {"a": torch.tensor([math.nan, 1.0])}
    same, st2 = ref_wgan.adam_update(p, bad, st, 0.1, 0.5, 0.9, 1.0)
    assert same is p and st2 is st


def test_gradient_penalty_of_a_linear_critic():
    """A linear critic's input gradient is its scaled weight everywhere, so
    the penalty is (|scale * w| - 1)^2 and the loss -W + lambda GP."""
    w = torch.tensor([[0.6], [0.3]])
    params = {"w0": w, "b0": torch.tensor([0.1])}
    scale = torch.tensor([2.0, 1.0])
    real = torch.tensor([[1.0, 2.0], [3.0, 1.0]])
    fake = torch.tensor([[0.5, 0.5], [1.0, 1.0]])
    eps = torch.tensor([[0.3], [0.7]])
    loss, w_est = ref_wgan.critic_loss(params, real, fake, eps, scale, 10.0,
                                       "fp32")
    wdist = ((real - fake) * scale) @ w
    gp = (math.sqrt(1.2 ** 2 + 0.3 ** 2) - 1.0) ** 2
    assert float(loss) == pytest.approx(-float(wdist.mean()) + 10 * gp,
                                        rel=1e-5)
    assert float(w_est) == pytest.approx(float(wdist.mean()), rel=1e-5)
