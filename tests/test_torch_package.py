"""The port's import rules, each in a fresh interpreter: every module of
fpv4d_torch imports with jax (and the JAX-side libraries) and the fpv4d
package blocked, so no module of the port reaches the reference; and
importing every module loads no cv2, PIL or joblib (the card's machine
has none of them: the port renders and encodes PNGs without them)."""
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
    "fpv4d_torch.parallel.sharding", "fpv4d_torch.cli.multiopt",
    "fpv4d_torch.vis.raster", "fpv4d_torch.vis.png",
    "fpv4d_torch.vis.ego_overlay", "fpv4d_torch.vis.world_view",
    "fpv4d_torch.vis.interactive", "fpv4d_torch.vis.export",
    "fpv4d_torch.io.video", "fpv4d_torch.cli.vis", "fpv4d_torch.cli.prep",
    "fpv4d_torch.models.cvae", "fpv4d_torch.ops.chamfer_ref",
    "fpv4d_torch.utils.monitor", "fpv4d_torch.utils.observability",
    "fpv4d_torch.utils.accuracy_report", "fpv4d_torch.io.native")

_HOST_LIBS = ("cv2", "PIL", "joblib")

_PROBE_HOST_LIBS = """
import importlib, pkgutil, sys
import fpv4d_torch
for m in pkgutil.walk_packages(fpv4d_torch.__path__, "fpv4d_torch."):
    importlib.import_module(m.name)
loaded = sorted(n for n in sys.modules if n.split(".")[0] in {libs!r})
assert not loaded, loaded
print("ok")
"""


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


def test_no_port_module_loads_cv2_pil_or_joblib():
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-c", _PROBE_HOST_LIBS.format(libs=_HOST_LIBS)],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
