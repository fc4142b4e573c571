"""Tensor ops and the three hand-written CUDA kernels of the eval path."""
