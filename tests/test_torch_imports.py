"""The port imports no JAX, no module of the JAX package, and none of the
packages the GPU machine lacks."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
import grlir_torch, grlir_torch.models.grl, grlir_torch.ops.block_attn
import grlir_torch.engines.inference, grlir_torch.serve
print(sorted(m for m in ("jax", "flax", "yaml", "cv2") if m in sys.modules))
"""

# every module of grlir_torch, and chip_smoke (whose import must not run
# its main); then the names of any grlir module that came in with them
PROBE_ALL = """
import importlib, pkgutil, sys
import grlir_torch
names = [m.name for m in pkgutil.walk_packages(grlir_torch.__path__, "grlir_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
print(len(names))
print(sorted(m for m in sys.modules if m == "grlir" or m.startswith("grlir.")
             or m.split(".")[0] in ("jax", "flax", "yaml", "cv2")))
"""


def _run(probe):
    env = {**os.environ, "PYTHONPATH": ROOT}
    return subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, check=True)


def test_port_imports_no_jax():
    out = _run(PROBE)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_port_and_chip_smoke_import_no_grlir_module():
    out = _run(PROBE_ALL)
    n_modules, leaked = out.stdout.strip().splitlines()
    assert int(n_modules) >= 10, out.stdout
    assert leaked == "[]", out.stdout + out.stderr
