"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program.  Module names are compared by their
top-level part, whole: ``maunet_tpu_torch`` is not ``maunet_tpu``."""

import ast
import subprocess
import sys

from portbench.tests import tiny

FORBIDDEN = ("jax", "jaxlib", "flax", "maunet_tpu")

BLOCKED_RUN = """
import importlib.abc, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, {root!r})

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import torch
from portbench import harness
from portbench.tests import tiny
with tempfile.TemporaryDirectory() as tmp:
    root = tiny.make_root(Path(tmp))
    for name in tiny.CELLS:
        res, _ = harness.run_cell(root, name, 7, 0.2, False, torch.device("cpu"),
                                  time.perf_counter())
        assert res["attempted"] > 0, name
found = harness.forbidden_modules()
assert not found, found
print("clean")
"""

REFERENCE_ONLY = """
import pkgutil, importlib, sys
sys.path.insert(0, {root!r})
import portbench.reference as ref
for m in pkgutil.iter_modules(ref.__path__):
    importlib.import_module("portbench.reference." + m.name)
tops = {{k.split(".")[0] for k in sys.modules}}
bad = tops & {{"maunet_tpu_torch", "maunet_tpu", "jax", "jaxlib", "flax"}}
assert not bad, bad
print("clean")
"""


def run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_each_cells_run_loads_no_jax_with_jax_blocked():
    assert "clean" in run(BLOCKED_RUN.format(root=str(tiny.ROOT), forbidden=FORBIDDEN))


def test_reference_loads_nothing_of_the_program():
    assert "clean" in run(REFERENCE_ONLY.format(root=str(tiny.ROOT)))


def imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_sources_name_no_forbidden_module():
    bench = tiny.ROOT / "portbench"
    for path in bench.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not imports(path) & set(FORBIDDEN), path
        if "reference" in path.parts:
            assert "maunet_tpu_torch" not in imports(path), path
