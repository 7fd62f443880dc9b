"""Hand-written CUDA kernels for Hopper (sm_90a), bound through ctypes.

The sources live in ``tcgan_torch/csrc``; :mod:`.build` compiles them with
nvcc at first use. Each kernel's wrapper runs its plain-PyTorch version for
CPU tensors and launches the kernel (or raises) for CUDA tensors.
"""
