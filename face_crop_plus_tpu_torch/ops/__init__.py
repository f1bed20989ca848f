"""Tensor operations of the port: plain PyTorch, and the CUDA kernels under ``cuda``."""
