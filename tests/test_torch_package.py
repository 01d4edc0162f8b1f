"""The port's import rules, each in a fresh interpreter: every module of
fpv4d_torch imports with jax (and the JAX-side libraries) and the fpv4d
package blocked, so no module of the port reaches the reference; and
importing every module loads no cv2, PIL or joblib (the card's machine
has none of them: the port renders and encodes PNGs without them)."""
import subprocess
import sys
from pathlib import Path

import pytest

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
    "fpv4d_torch.utils.accuracy_report", "fpv4d_torch.io.native",
    "fpv4d_torch.bench", "fpv4d_torch.utils.cost",
    "fpv4d_torch.solve.adam", "fpv4d_torch.solve.step_graph",
    "fpv4d_torch.utils.profile_stages", "fpv4d_torch.utils.profile_frames")

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


# the JAX package's benchmark records, taken on a TPU
_TPU_RECORDS = ("bench_out.json", "bench_out_cpu.json", "BENCH_r0",
                "kp_bench_out.json", "hbm_probe_out.json", "MULTICHIP_r0")


def test_bench_reads_no_tpu_record():
    """The port's bench and its cost count name none of the TPU's
    record files, so they can read none of them."""
    pkg = Path(__file__).resolve().parents[1] / "fpv4d_torch"
    for rel in ("bench.py", "utils/cost.py"):
        src = (pkg / rel).read_text()
        assert not [r for r in _TPU_RECORDS if r in src], rel


# every optimization loop of the port (the clip solve, the fleet step,
# the keypoint fit's Adam stages, the smoothers) steps with solve/adam.py
# (capturable, on the device), and no module of the package reaches
# torch.optim
_PKG = Path(__file__).resolve().parents[1] / "fpv4d_torch"
_MODULES = sorted(str(p.relative_to(_PKG)) for p in _PKG.rglob("*.py"))
_OPTIMIZING = ("solve/clip_solve.py", "solve/adam.py", "solve/step_graph.py",
               "solve/keypoint_fit.py", "solve/frame_fit.py",
               "parallel/multi_clip.py", "parallel/sharding.py")


@pytest.mark.parametrize("rel", _MODULES)
def test_no_port_module_uses_torch_optim(rel):
    import ast
    assert set(_OPTIMIZING) <= set(_MODULES)
    tree = ast.parse((_PKG / rel).read_text())
    uses = [n.lineno for n in ast.walk(tree)
            if (isinstance(n, ast.Attribute) and n.attr == "optim"
                and isinstance(n.value, ast.Name)
                and n.value.id == "torch")
            or (isinstance(n, (ast.Import, ast.ImportFrom))
                and any("torch.optim" in (a.name or "")
                        for a in n.names)
                or isinstance(n, ast.ImportFrom)
                and (n.module or "").startswith("torch.optim"))]
    assert not uses, (rel, uses)
