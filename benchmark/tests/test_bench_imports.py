"""What a run loads: after a CPU dry run of each entry, ``sys.modules``
holds no top-level ``jax``, ``jaxlib``, ``flax`` or ``dr4sr_tpu`` (whole
names: the port's ``dr4sr_tpu_torch`` begins with the JAX package's name);
and the references import nothing of the port."""

import ast
import json
import os
import subprocess
import sys

import pytest

import harness
from conftest import ALL_CELLS

DRY_RUN = """
import json, sys
sys.path[:0] = [{bench!r}, {tests!r}, {root!r}]
import harness
from conftest import tiny
result = harness.run_cell(tiny(harness.load_spec({cell!r}, {bench_path!r})), 7, 0.2, False, device="cpu")
print(json.dumps({{"correct": result["correct"], "modules": harness.forbidden_modules(),
                  "port": "dr4sr_tpu_torch" in sys.modules}}))
"""


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_dry_run_loads_no_jax(cell, bench_path):
    code = DRY_RUN.format(bench=harness.HERE, tests=os.path.dirname(__file__), root=harness.ROOT,
                          cell=cell, bench_path=bench_path)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"correct": True, "modules": [], "port": True}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


REFERENCES = sorted(f for f in os.listdir(os.path.join(harness.HERE, "reference"))
                    if f.endswith(".py"))


@pytest.mark.parametrize("name", REFERENCES)
def test_reference_imports_nothing_of_the_port(name):
    tops = {m.split(".")[0] for m in _imports(os.path.join(harness.HERE, "reference", name))}
    assert not tops & {"dr4sr_tpu", "dr4sr_tpu_torch", "jax", "jaxlib", "flax"}
