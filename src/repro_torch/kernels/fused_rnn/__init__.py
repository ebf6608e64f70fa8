"""Whole-layer and depth-fused SRU/QRNN kernels (CUDA C++, ``csrc/``)."""
