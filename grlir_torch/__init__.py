"""PyTorch/CUDA port of grlir for NVIDIA Hopper GPUs.

Mirrors the module names of the JAX package `grlir`, which stays the
reference the port is tested against.  The port imports torch and numpy
only: it keeps its own copies of the numpy host code it needs (geometry,
parameter-name mapping) and never imports JAX or any module of `grlir`.
"""
