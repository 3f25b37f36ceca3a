"""Minimal PNG reader and writer (numpy + zlib).

The port's stand-in for what PIL does for the JAX package's dataset readers
and matplotlib for its viewer: the card's machine has neither. The writer
makes 8-bit grayscale or RGB PNGs with every row unfiltered (filter 0); the
reader takes non-interlaced 8-bit grayscale or RGB PNGs with any of the five
row filters, as other encoders (PIL's adaptive filtering among them) write
them.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}      # colour type -> channels (grayscale, RGB)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> the bytes of a PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the row filters. ``filt`` (H, W, C) int32 filtered bytes,
    ``ftype`` (H,) the filter of each row. A pixel depends on its left,
    upper and upper-left neighbours once reconstructed, so the pixels of one
    anti-diagonal r + x = d are reconstructed together, a diagonal a step.
    The diagonals are laid out as rows of a skewed array: pixel (r, x) at
    ``out[r + x + 2, r + 1]``, its neighbours in the two rows before, and
    row 0 of the second axis (the row above the image) stays zero."""
    h, w, c = filt.shape
    if not ftype.any():
        return filt.astype(np.uint8)
    n = h + w - 1
    r, x = np.mgrid[0:h, 0:w]
    skewed = np.zeros((n, h, c), np.int32)
    skewed[r + x, r] = filt
    kind = [(ftype == k)[:, None] for k in range(5)]
    out = np.zeros((n + 2, h + 1, c), np.int32)
    for d in range(n):
        lo, hi = max(0, d - w + 1), min(h, d + 1)        # rows on this diagonal
        a = out[d + 1, lo + 1:hi + 1]                     # left
        b = out[d + 1, lo:hi]                             # up
        cc = out[d, lo:hi]                                # up-left
        pred = np.where(kind[1][lo:hi], a, np.where(kind[2][lo:hi], b, 0))
        if kind[3][lo:hi].any():
            pred = np.where(kind[3][lo:hi], (a + b) >> 1, pred)
        if kind[4][lo:hi].any():
            pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
            pred = np.where(kind[4][lo:hi], paeth, pred)
        out[d + 2, lo + 1:hi + 1] = (skewed[d, lo:hi] + pred) & 0xFF
    return out[r + x + 2, r + 1].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG -> (H, W) or (H, W, 3) uint8."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    off, header, idat = 8, None, []
    while off < len(data):
        (n,) = struct.unpack_from(">I", data, off)
        kind = data[off + 4: off + 8]
        body = data[off + 8: off + 8 + n]
        (crc,) = struct.unpack_from(">I", data, off + 8 + n)
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        off += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace} (8-bit grayscale or RGB, not interlaced)")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (w * c + 1)}")
    rows = raw.reshape(h, w * c + 1)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {ftype.max()}")
    img = _unfilter(rows[:, 1:].astype(np.int32).reshape(h, w, c), ftype)
    return img[..., 0] if c == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
