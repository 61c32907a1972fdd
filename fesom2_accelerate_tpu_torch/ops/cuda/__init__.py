"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Importing this package touches neither CUDA nor nvcc: the kernels are
built and loaded at their first launch (``build.library``).
"""
