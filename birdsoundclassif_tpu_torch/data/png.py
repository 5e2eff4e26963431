"""PNG read and write with zlib and numpy, for the training windows.

The dataset's windows are 8-bit grayscale PNGs (JAX package:
data/etl.py:193-196). The port reads them without imageio or Pillow:
chunks are parsed here, the image data inflated with zlib, and the row
filters reversed, the None/Sub/Up rows in numpy and the Average/Paeth rows
by a small C routine (``csrc/png_unfilter.c``, built at first use with the
host C compiler), since each of their bytes depends on the one just
reconstructed to its left. ``unfilter_plain`` reverses all five filters
in plain Python: the tests hold the decoder against it.

Supported: 8-bit grayscale without interlace, what the ETL writes.
Anything else raises.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..kernels import NativeLibrary

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
UNFILTER = NativeLibrary("png_unfilter", {
    # filter, cur (in place), prev, n
    "png_unfilter_row": [_INT, _PTR, _PTR, _INT],
})

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _parse(data: bytes):
    """-> (height, width, inflated filtered rows (h, 1 + width))."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color != 0 or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace} (8-bit non-interlaced grayscale only)")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w):
        raise ValueError(f"PNG image data holds {raw.size} bytes, want {h * (1 + w)}")
    return h, w, raw.reshape(h, 1 + w)


def _unfilter_numpy(filt: int, cur: np.ndarray, prev: np.ndarray) -> bool:
    """None/Sub/Up reversal in place; False for Average/Paeth."""
    if filt == 0:
        return True
    if filt == 1:
        cur[:] = np.cumsum(cur, dtype=np.uint8)
        return True
    if filt == 2:
        cur += prev
        return True
    return False


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def unfilter_plain(rows: np.ndarray) -> np.ndarray:
    """Filtered scanlines (H, 1 + W), each led by its filter byte -> uint8
    (H, W), all five filters reversed in plain Python byte by byte: the
    reference the tests hold ``decode_png`` against."""
    h, w = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, w), np.uint8)
    up = [0] * w
    for y in range(h):
        filt, row = int(rows[y, 0]), [int(v) for v in rows[y, 1:]]
        if filt not in range(5):
            raise ValueError(f"PNG row {y}: unknown filter type {filt}")
        for i in range(w):
            a, b, c = (row[i - 1], up[i], up[i - 1]) if i else (0, up[i], 0)
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[filt]
            row[i] = (row[i] + pred) & 0xFF
        out[y] = up = row
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 array (H, W)."""
    rows = _parse(data)[2]
    h, w = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h + 1, w), np.uint8)  # row 0: the zero row above the image
    for y in range(h):
        filt = int(rows[y, 0])
        cur = out[y + 1]
        cur[:] = rows[y, 1:]
        if _unfilter_numpy(filt, cur, out[y]):
            continue
        if filt not in (3, 4):
            raise ValueError(f"PNG row {y}: unknown filter type {filt}")
        status = UNFILTER.call("png_unfilter_row", filt, cur.ctypes.data, out[y].ctypes.data, w)
        if status != 0:
            raise ValueError(f"PNG row {y}: the unfilter routine failed ({status})")
    return out[1:]


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _paeth_predict(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    a, b, c = (v.astype(np.int16) for v in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W) gray -> PNG bytes. Row y takes filter type y % 5, so a
    file of five rows or more exercises every filter of the decoder."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"encode_png takes a (H, W) uint8 image, got shape {img.shape}")
    h, w = img.shape
    rows = np.zeros((h, 1 + w), np.uint8)
    prev = np.zeros(w, np.uint8)
    for y in range(h):
        cur = img[y]
        left = np.concatenate([[0], cur[:-1]]).astype(np.uint8)
        upleft = np.concatenate([[0], prev[:-1]]).astype(np.uint8)
        filt = y % 5
        if filt == 0:
            pred = np.zeros(w, np.uint8)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = prev
        elif filt == 3:
            pred = ((left.astype(np.int16) + prev) >> 1).astype(np.uint8)
        else:
            pred = _paeth_predict(left, prev, upleft)
        rows[y, 0] = filt
        rows[y, 1:] = cur - pred  # uint8 arithmetic wraps mod 256
        prev = cur

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
