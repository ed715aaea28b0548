"""Tensor functions and the CUDA kernels of the rendering path."""
