"""Build the hand-written sources of ``fpv4d_torch/csrc/``.

Each CUDA source (``.cu``) is compiled by nvcc for ``sm_90a``, and each
host source (``.cpp``, the voxel-grid builder) by the host C++
compiler, into a shared library with a plain C interface under
``fpv4d_torch/_build/`` (git-ignored), named after the source and a
hash of its bytes, of the bytes of every ``csrc/*.cuh`` header it
includes and of its compiler flags, so an edited source, header or flag
rebuilds and an unchanged one is built once. ``compile_sources`` starts
one compiler per missing library, all together, and waits for them;
``load_function`` compiles one source if needed, opens it with ctypes
and declares its entry point. Nothing here runs at import: only a
kernel's first launch (or an explicit build) needs the CUDA toolkit,
and only the first native grid build needs the host compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

# ctypes argument types of the kernels' C entry points
POINTER = ctypes.c_void_p
INT = ctypes.c_int

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-I", str(CSRC))
# the host route: GCC's default FMA contraction with FMA instructions
# on, as the reference's -march=native build has them on the x86-64
# machines that build it (-march=native itself would tie the library
# to the building machine's CPU)
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC") + (
    ("-mfma",) if platform.machine() in ("x86_64", "AMD64") else ())
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+\.cuh)"', re.M)


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc")


def host_cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no host C++ compiler (g++) found: the voxel-grid "
                       "builder is built with it")


def _command(src: Path, out: Path) -> List[str]:
    if src.suffix == ".cu":
        return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [host_cxx(), *HOST_FLAGS, "-o", str(out), str(src)]


def _headers(src: Path):
    """The .cuh headers src includes with quotes, found beside it or in
    CSRC, and those they include in turn, each once, in include order."""
    seen, todo = [], [src]
    while todo:
        text = todo.pop(0).read_text()
        for name in _INCLUDE.findall(text):
            hdr = next((d / name for d in (src.parent, CSRC)
                        if (d / name).exists()), None)
            if hdr is not None and hdr not in seen:
                seen.append(hdr)
                todo.append(hdr)
    return seen


def library_path(src: Path) -> Path:
    """src's library, named after the hash of src, its headers and its
    compiler flags."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in _headers(src):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS if src.suffix == ".cu"
                      else HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def compile_sources(srcs: Sequence[Path]) -> Dict[str, str]:
    """Compile every source whose library is missing, one compiler
    process each, all started before any is waited for. Returns each
    compiled source's compiler output (for nvcc, ptxas' register and
    spill lines) by file name; raises if any compilation fails, with the
    compiler's output."""
    BUILD_DIR.mkdir(exist_ok=True)
    running = []
    for src in srcs:
        so = library_path(src)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = _command(src, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, so, tmp, cmd, proc))
    logs, failed = {}, []
    for src, so, tmp, cmd, proc in running:
        logs[src.name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                          f"{logs[src.name]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load_function(src: Path, name: str, argtypes: Sequence,
                  restype=ctypes.c_int) -> Tuple[Callable[..., int], str]:
    """(C entry point `name` of src's library, declared with `argtypes`
    and `restype`; compiler output), compiling src first if its library
    is missing (the output is "" when it was not)."""
    log = compile_sources([src]).get(src.name, "")
    fn = getattr(ctypes.CDLL(str(library_path(src))), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn, log
