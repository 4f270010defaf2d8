"""PyTorch/CUDA port of grlir for NVIDIA Hopper GPUs.

Mirrors the module names of the JAX package `grlir`, which stays the
reference the port is tested against.  The port imports torch and numpy,
plus the two numpy-only host modules it shares with grlir
(`grlir.ops.geometry`, `grlir.utils.convert`); it never imports JAX.
"""
