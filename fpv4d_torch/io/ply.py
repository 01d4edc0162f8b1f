"""Minimal NumPy PLY reader/writer (the port's own copy of
fpv4d/io/ply.py): scene vertices from ``meshed-poisson.ply`` /
``xyz.ply``. Supports ascii and binary little/big endian, vertex
properties (x, y, z [+ extras]) and triangle faces.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """-> (vertices [N,3] float32, faces [F,3] int32 or None)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []          # list of (name, count, [(prop, dtype)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                cur = (tok[1], int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == "property":
                if tok[1] == "list":
                    cur[2].append((tok[4], ("list", _DTYPES[tok[2]],
                                            _DTYPES[tok[3]])))
                else:
                    cur[2].append((tok[2], _DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break

        verts, faces = None, None
        if fmt == "ascii":
            verts, faces = _read_ascii(f, elements)
        elif fmt == "binary_little_endian":
            verts, faces = _read_binary(f, elements, "<")
        elif fmt == "binary_big_endian":
            verts, faces = _read_binary(f, elements, ">")
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return verts, faces


def _read_ascii(f, elements):
    verts = faces = None
    for name, count, props in elements:
        rows = [f.readline().decode().split() for _ in range(count)]
        if name == "vertex":
            idx = {p[0]: i for i, p in enumerate(props)}
            verts = np.asarray(
                [[float(r[idx["x"]]), float(r[idx["y"]]),
                  float(r[idx["z"]])] for r in rows], dtype=np.float32)
        elif name == "face" and count:
            faces = np.asarray([[int(v) for v in r[1:4]] for r in rows],
                               dtype=np.int32)
    return verts, faces


def _read_binary(f, elements, endian):
    verts = faces = None
    for name, count, props in elements:
        if name == "vertex":
            fields = [(p, np.dtype(endian + d)) for p, d in props
                      if not isinstance(d, tuple)]
            rec = np.dtype([(p, d) for p, d in fields])
            data = np.frombuffer(f.read(rec.itemsize * count), dtype=rec,
                                 count=count)
            verts = np.stack([data["x"], data["y"], data["z"]],
                             axis=1).astype(np.float32)
        elif name == "face":
            out = np.empty((count, 3), dtype=np.int32)
            for i in range(count):
                # assume the standard (count_dtype, idx_dtype) list
                cdt, idt = None, None
                for p, d in props:
                    if isinstance(d, tuple):
                        cdt, idt = np.dtype(endian + d[1]), \
                            np.dtype(endian + d[2])
                n = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                idxs = np.frombuffer(f.read(idt.itemsize * n), idt)
                out[i] = idxs[:3]
            faces = out
        else:
            # skip unknown fixed-size elements
            size = sum(np.dtype(endian + d).itemsize for _, d in props
                       if not isinstance(d, tuple))
            f.read(size * count)
    return verts, faces


def write_ply(path: str, verts: np.ndarray,
              faces: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    verts = np.asarray(verts, dtype=np.float32)
    faces = None if faces is None else np.asarray(faces, dtype=np.int32)
    with open(path, "wb") as f:
        hdr = ["ply",
               "format binary_little_endian 1.0" if binary
               else "format ascii 1.0",
               f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z"]
        if faces is not None:
            hdr += [f"element face {len(faces)}",
                    "property list uchar int vertex_indices"]
        hdr.append("end_header")
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        if binary:
            f.write(verts.astype("<f4").tobytes())
            if faces is not None:
                rec = np.empty(len(faces),
                               dtype=[("n", "u1"), ("v", "<i4", 3)])
                rec["n"] = 3
                rec["v"] = faces
                f.write(rec.tobytes())
        else:
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n".encode())
            if faces is not None:
                for fc in faces:
                    f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n".encode())
