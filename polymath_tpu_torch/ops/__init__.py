"""Bulk field, curve, NTT, MSM and prover math in PyTorch.

Kernel wrappers (``cuda_field``, ``cuda_curve``, ``cuda_gather`` and the
local NTT in ``ntt``) launch the CUDA sources in ``../csrc`` on CUDA
tensors and run their plain PyTorch versions on CPU tensors.  Nothing here
builds or imports CUDA code at import time.
"""
