"""What the benchmark loads: no module whose top-level name is `jax`,
`jaxlib`, `flax` or `cineform_tpu` (compared whole: the port's name,
`cineform_tpu_torch`, begins with the JAX package's), in a process that
loads every module of the benchmark and runs a cell; and the reference
loads nothing of the port either."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "cineform_tpu"}

_RUN_A_CELL = r"""
import glob, os, sys, tempfile
sys.path.insert(0, {root!r})
sys.path.insert(0, os.path.join({root!r}, "cfbench", "tests"))
import conftest
from cfbench import plugins, run
import importlib
found = [os.path.join("cfbench", d) for d in conftest.PIECES]
for path in sorted(glob.glob(os.path.join({root!r}, "cfbench", "**", "*.py"),
                             recursive=True)):
    rel = os.path.relpath(path, {root!r})
    if rel.startswith(os.path.join("cfbench", "tests")):
        continue
    if os.path.dirname(rel) in found and not rel.endswith("__init__.py"):
        plugins.load_module(path, rel)     # found by name, as a run does
    else:
        importlib.import_module(rel[:-3].replace(os.sep, ".")
                                .replace(".__init__", ""))
with tempfile.TemporaryDirectory() as tmp:
    bench = conftest.make_root(tmp)
    for cell in ("yuy2_1080.pool_decode", "byr4_uhd.export_rg48"):
        conftest.rehearse(tmp, bench, cell, seconds=1.0, traced=True)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level(_RUN_A_CELL.format(root=ROOT))
    assert "cineform_tpu_torch" in loaded     # the program did run
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_either_package():
    loaded = _top_level(
        f"import sys; sys.path.insert(0, {ROOT!r})\n"
        "import glob, os\n"
        "import cfbench.reference.codec, cfbench.check, cfbench.plugins\n"
        f"for p in glob.glob(os.path.join({ROOT!r}, 'cfbench', 'reference',"
        " 'formats', '*.py')):\n"
        "    cfbench.plugins.load_module(p, p)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert not loaded & (FORBIDDEN | {"cineform_tpu_torch", "torch"})


def test_no_source_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "cfbench")):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                for m in mods:
                    top = m.split(".")[0]
                    assert top not in FORBIDDEN, (path, m)
                    if os.sep + "reference" in dirpath:
                        assert top != "cineform_tpu_torch", (path, m)
