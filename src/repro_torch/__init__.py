"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout and names module by module. Nothing here
imports ``jax`` or the ``repro`` package. Entry points run on the card unless
the caller asks for the CPU; kernel wrappers launch their CUDA kernel on a
CUDA tensor and run the kernel's plain PyTorch version on a CPU tensor.
"""
