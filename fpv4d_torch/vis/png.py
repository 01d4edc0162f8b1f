"""PNG encoder and decoder with the standard library only (zlib,
struct): the port's stand-in for PIL and cv2.imwrite.

``encode_png`` writes 8-bit RGB or grey images, every row with filter
type 0 (none), deflated at one fixed level. ``decode_png`` reads back
8-bit RGB and grey PNGs whose rows all use filter type 0, which is
what ``encode_png`` writes; it raises on anything else.
"""
from __future__ import annotations

import struct
import zlib
from typing import Union

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_LEVEL = 6                    # zlib's default, and PIL's
_COLOR_TYPE = {1: 0, 3: 2}    # channels -> PNG colour type (grey, RGB)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: Union[np.ndarray, torch.Tensor]) -> bytes:
    """uint8 [H, W, 3] (RGB), [H, W, 1] or [H, W] (grey) -> PNG bytes.
    A tensor is copied to the host once."""
    if torch.is_tensor(img):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png needs uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png needs [H, W], [H, W, 1] or [H, W, 3], "
                         f"got {img.shape}")
    H, W, C = img.shape
    rows = np.zeros((H, 1 + W * C), np.uint8)     # filter byte 0 per row
    rows[:, 1:] = img.reshape(H, W * C)
    header = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), _LEVEL))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes as encode_png writes them -> uint8 [H, W, 3] or
    [H, W]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPE.items()}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(H, 1 + W * channels)
    if rows[:, 0].any():
        raise ValueError("PNG rows use filters other than 0")
    img = rows[:, 1:].reshape(H, W, channels)
    return img[:, :, 0].copy() if channels == 1 else img.copy()
