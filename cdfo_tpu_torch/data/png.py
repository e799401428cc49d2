"""A PNG codec on the standard library (``zlib`` + ``struct``) and numpy:
8-bit, non-interlaced gray (colour type 0) and RGB (colour type 2) images.

``data/io.py`` reads and writes through ``cv2`` or PIL where one is
installed and through this codec otherwise, so the data pipeline runs on
a machine that has neither. Any other PNG (palette, alpha, 16-bit,
interlaced) raises ``ValueError``.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}     # colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> PNG bytes (every row
    unfiltered)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"the PNG codec writes (H, W) or (H, W, 3) uint8, "
                         f"got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray,
              bpp: int) -> np.ndarray:
    """One scanline's bytes from its filtered bytes and the row above."""
    if kind == 0:
        return line
    if kind == 1:    # Sub: a running sum per sample, mod 256
        return (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                % 256).astype(np.uint8).reshape(-1)
    if kind == 2:    # Up
        return line + prior
    if kind not in (3, 4):
        raise ValueError(f"PNG filter type {kind} is not defined")
    out = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        c = up[i - bpp] if i >= bpp else 0
        pred = (a + up[i]) >> 1 if kind == 3 else _paeth(a, up[i], c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint8 (gray) or (H, W, 3) uint8 (RGB)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(
            f"the PNG codec reads 8-bit non-interlaced gray or RGB, got "
            f"bit depth {depth}, colour type {colour}, interlace {interlace}")
    bpp = _CHANNELS[colour]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prior, bpp)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, 3)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 luma as ``cv2.imread(path, 0)``
    computes it: 0.299 R + 0.587 G + 0.114 B in 14-bit fixed point,
    rounded."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)
