"""Kernels of the port: plain twins, CUDA wrappers and their build."""
