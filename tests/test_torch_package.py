"""The port's import rule: every module of fpv4d_torch imports with jax
(and the JAX-side libraries) and the fpv4d package blocked, in a fresh
interpreter, so no module of the port reaches the reference."""
import subprocess
import sys
from pathlib import Path

_BLOCKED = ("jax", "jaxlib", "optax", "orbax", "ml_dtypes", "fpv4d")

_PROBE = """
import importlib, pkgutil, sys
blocked = {blocked!r}
for name in list(sys.modules):
    if name.split(".")[0] in blocked:
        del sys.modules[name]
for name in blocked:
    sys.modules[name] = None          # any import of it now raises
import fpv4d_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    fpv4d_torch.__path__, "fpv4d_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n, m in sys.modules.items()
                if m is not None and n.split(".")[0] in blocked)
assert not leaked, leaked
print(" ".join(names))
"""

# the modules of each slice, so a module that stopped being walked (or
# was never added) fails here rather than passing unchecked
_EXPECTED = (
    "fpv4d_torch.solve.clip_solve", "fpv4d_torch.ops.cand_cuda",
    "fpv4d_torch.ops.chamfer_cuda", "fpv4d_torch.cli.globalopt",
    "fpv4d_torch.io.keypoints", "fpv4d_torch.models.motion_gru",
    "fpv4d_torch.solve.lbfgs", "fpv4d_torch.solve.keypoint_fit",
    "fpv4d_torch.solve.frame_fit", "fpv4d_torch.cli.fit",
    "fpv4d_torch.cli.smooth", "fpv4d_torch.parallel.multi_clip",
    "fpv4d_torch.parallel.sharding", "fpv4d_torch.cli.multiopt")


def test_every_port_module_imports_without_jax_or_fpv4d():
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-c", _PROBE.format(blocked=_BLOCKED)], cwd=root,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    # every subpackage's modules were walked, the CLIs and io included
    names = res.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 40
    assert set(_EXPECTED) <= set(names), set(_EXPECTED) - set(names)
