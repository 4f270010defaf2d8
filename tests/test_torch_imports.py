"""The port imports no JAX, and none of the packages the GPU machine lacks."""

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


def test_port_imports_no_jax():
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
