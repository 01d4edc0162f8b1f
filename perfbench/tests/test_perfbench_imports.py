"""What the harness loads: after its modules and the port load, no
top-level module is jax, jaxlib, flax, optax or the JAX package fpv4d
(compared by whole top-level name: fpv4d_torch is the port); the
reference imports nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from perfbench.run import FORBIDDEN

ROOT = Path(__file__).resolve().parents[2]
HARNESS = ["perfbench.run", "perfbench.profiling",
           "perfbench.drivers.clip_solve",
           "perfbench.reference.check", "perfbench.counts.flops",
           "perfbench.inputs.synth", "perfbench.tests.readings",
           "fpv4d_torch.solve.clip_solve", "fpv4d_torch.models.smplx"]


def _loaded(mods):
    code = ("import sys, importlib\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import perfbench.metrics as pm, pkgutil\n"
            "for i in pkgutil.iter_modules(pm.__path__):\n"
            "    importlib.import_module('perfbench.metrics.' + i.name)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_no_jax_loaded():
    top = _loaded(HARNESS)
    assert "fpv4d_torch" in top
    assert not (top & FORBIDDEN), top & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    top = _loaded(["perfbench.reference.check", "perfbench.counts.flops",
                   "perfbench.inputs.synth"])
    assert "fpv4d_torch" not in top and not (top & FORBIDDEN)


def test_reference_sources_import_no_port():
    for d in ("reference", "inputs", "counts"):
        for f in (ROOT / "perfbench" / d).glob("*.py"):
            tree = ast.parse(f.read_text())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    top = n.split(".")[0]
                    assert top not in FORBIDDEN | {"fpv4d_torch"}, (f, n)
