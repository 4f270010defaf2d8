"""The benchmark of grlir_torch, the PyTorch and CUDA port, on an NVIDIA H100.

`run.py` runs one cell of `BENCHMARK.json` once; see its docstring.  The
harness is driven by data: each configuration (`configs/`), traffic mix
(`traffic/`), cell's limits (`limits/`) and per-layer metric (`metrics/`)
is a file of its own, found by its name.  The yardstick lives here too:
the plain reference (`reference/`), the counts of operations and bytes
(`work.py`), the table of peaks (`peaks.json`), the trace reduction
(`trace.py`) and the comparison that decides `correct` (`check.py`).
Nothing here imports JAX or the JAX package `grlir`.
"""
