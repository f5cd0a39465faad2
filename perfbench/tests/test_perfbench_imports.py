"""Nothing the benchmark loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the JAX package), compared whole:
``repro_torch`` is not ``repro``."""

import ast
import subprocess
import sys

from perfbench.tests.smoke import ROOT, run_module

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_no_source_of_the_benchmark_imports_jax_or_repro():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_a_run_loads_no_jax_or_repro():
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from perfbench.tests.smoke import smoke_cell
from perfbench.harness import run_cell
for name in ("granite-3-8b.long-prompt", "deepseek-v2-236b.chat"):
    cell, cfg = smoke_cell(name)
    run_cell(cell, 3, 0.5, True, "cpu", cfg=cfg)
print(sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}))
print("repro_torch" in sys.modules)
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert lines[-2] == "[]" and lines[-1] == "True"


def test_forbidden_names_are_compared_whole(monkeypatch):
    run = run_module()
    for name in ("repro_torch.fake", "reprox", "jax.fake", "repro"):
        monkeypatch.setitem(sys.modules, name, sys)
    bad = run.forbidden_modules()
    assert "jax.fake" in bad and "repro" in bad
    assert "repro_torch.fake" not in bad and "reprox" not in bad
