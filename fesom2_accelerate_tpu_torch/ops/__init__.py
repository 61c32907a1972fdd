"""Compute layers of the port: mesh tensors, plain stages, CUDA kernels."""
