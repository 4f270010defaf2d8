"""Nothing of the benchmark that runs on the card loads JAX or the JAX
package, and the reference loads nothing of the program either: checked
in a fresh interpreter by whole top-level module name (`grlir_torch` is
the port, `grlir` the JAX package)."""

import json
import subprocess
import sys

import pytest

from h100_bench.run import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for name in {mods!r}:
    __import__(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(mods):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), mods=mods)],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    loaded = top_level(["h100_bench.reference.grl", "h100_bench.reference.train",
                        "h100_bench.reference.geometry", "h100_bench.work", "h100_bench.check"])
    assert not loaded & {"grlir_torch", "grlir", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_a_run_loads_no_jax(kind):
    """The modules a run imports, the port's included, by whole name."""
    mods = ["h100_bench.run", f"h100_bench.cell_{kind}", "grlir_torch.engines.inference",
            "grlir_torch.engines.train", "grlir_torch.engines.preprocess",
            "grlir_torch.optim", "grlir_torch.models.grl"]
    loaded = top_level(mods)
    assert "grlir_torch" in loaded
    assert not loaded & {"grlir", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_whole_top_level_names():
    from h100_bench import run

    assert run.forbidden_modules(["grlir_torch", "grlir_torch.models.grl", "numpy"]) == []
    assert run.forbidden_modules(["grlir.models.grl", "jax._src.api", "flax"]) == [
        "flax", "grlir", "jax"]
