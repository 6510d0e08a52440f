"""The port stands alone: no module of ``dr4sr_tpu_torch``, nor
``chip_smoke.py``, imports JAX, flax or the JAX package.

The import check runs in a fresh interpreter, because tests/conftest.py has
already imported JAX into this one.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "dr4sr_tpu_torch")
FORBIDDEN = ("jax", "flax", "dr4sr_tpu")

_PROBE = """
import importlib, pkgutil, sys
import dr4sr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dr4sr_tpu_torch.__path__, "dr4sr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "dr4sr_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _sources():
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


# modules that must be among those imported (the multi-device layer's, the
# tooling's, and those the models on a mesh and DR4SR+ on a mesh run)
REQUIRED = ("dr4sr_tpu_torch.parallel.mesh", "dr4sr_tpu_torch.parallel.ep",
            "dr4sr_tpu_torch.parallel.collectives", "dr4sr_tpu_torch.parallel.launch",
            "dr4sr_tpu_torch.ops.ring_attention", "dr4sr_tpu_torch.ops.topk",
            "dr4sr_tpu_torch.utils.env", "dr4sr_tpu_torch.utils.logger",
            "dr4sr_tpu_torch.utils.parsing", "dr4sr_tpu_torch.utils.tbwriter",
            "dr4sr_tpu_torch.quickstart", "dr4sr_tpu_torch.tune",
            "dr4sr_tpu_torch.scripts.preprocess", "dr4sr_tpu_torch.modules.losses",
            "dr4sr_tpu_torch.modules.augmentation", "dr4sr_tpu_torch.modules.graph_augmentation",
            "dr4sr_tpu_torch.models.cl4srec", "dr4sr_tpu_torch.models.iclrec",
            "dr4sr_tpu_torch.models.graph_cl", "dr4sr_tpu_torch.models.gnn",
            "dr4sr_tpu_torch.train.trainer", "dr4sr_tpu_torch.train.meta_trainer",
            "dr4sr_tpu_torch.meta.hypergrad")


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = _PROBE.replace("print(len(names), bad)",
                           "print(len(names), bad)\nprint(' '.join(names))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 10  # every module was imported
    imported = set(proc.stdout.splitlines()[-1].split())
    assert set(REQUIRED) <= imported, sorted(set(REQUIRED) - imported)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), f"{path}:{node.lineno} imports {roots}"
