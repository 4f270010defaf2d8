"""Nothing of the benchmark that runs on the card loads JAX or the JAX
package, and the reference loads nothing of the program either: checked
in a fresh interpreter by whole top-level module name (`grlir_torch` is
the port, `grlir` the JAX package)."""

import json

import pytest

from h100_bench import spec
from h100_bench.tests import cells

BENCH = spec.benchmark()
# the reference module of every configuration, and the harness's own
REFERENCES = list(dict.fromkeys(
    [cells.module_name(json.loads((spec.ROOT / c["file"]).read_text())["reference"])
     for c in BENCH["configs"]]
    + ["h100_bench.reference.grl", "h100_bench.reference.train",
       "h100_bench.reference.geometry", "h100_bench.work", "h100_bench.check"]))
# every kind a mix of traffic/ names
KINDS = sorted({json.loads(p.read_text())["kind"] for p in (spec.HERE / "traffic").glob("*.json")})


def test_reference_imports_nothing_of_the_program():
    cells.imports_nothing_of_the_program(spec.ROOT, REFERENCES)


@pytest.mark.parametrize("kind", KINDS)
def test_a_run_loads_no_jax(kind):
    """The modules a run imports, the port's included, by whole name."""
    cells.run_loads_no_jax(spec.ROOT, kind)


def test_forbidden_names_are_whole_top_level_names():
    from h100_bench import run

    assert run.forbidden_modules(["grlir_torch", "grlir_torch.models.grl", "numpy"]) == []
    assert run.forbidden_modules(["grlir.models.grl", "jax._src.api", "flax"]) == [
        "flax", "grlir", "jax"]
