"""The POCS loop's fused kernels: CUDA C++ for Hopper, each beside a plain twin.

Every ``<name>/ops.py`` holds one wrapper per kernel and the plain PyTorch
function it is held against.  A wrapper given CPU tensors computes the plain
version; given CUDA tensors it launches the kernel (built from ``csrc/`` by
:mod:`repro_torch.kernels.build`) or raises — there is no fallback.  Each
wrapper counts its kernel launches in a module-level ``launches`` dict.
"""
