"""tcgan_torch: the PyTorch/CUDA port of :mod:`tcgan_tpu`.

Each module keeps the path and public names of its ``tcgan_tpu``
counterpart, so ``tcgan_torch.ops.fixed_point.solve_fixed_point`` is the
port of ``tcgan_tpu.ops.fixed_point.solve_fixed_point``. The port imports
torch and numpy and never jax; ``tcgan_tpu`` stays the reference that the
port's tests compare against.

Ported so far: the forward/serving path ``python -m tcgan_torch.run.forward``
(weights, stimulus battery, fixed-point solve, probe readout), with the
fused SSN solver as a hand-written CUDA kernel (``ops/cuda``), and the
fixed-point WGAN-GP fit ``python -m tcgan_torch.run.gan`` (implicit
gradients, critic, optimizers, fake-truth data, driver, recorders,
checkpoints).
"""

__version__ = "0.1.0"
