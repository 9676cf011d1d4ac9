"""Image export. Row 0 of framework images is the BOTTOM (Unity UV origin);
files are written top-down.

PNG is encoded and decoded here with ``zlib`` + ``struct`` + NumPy, so the
CLI's ``--out x.png`` needs no imaging library. The writer emits 8-bit RGB
with filter 0; the reader takes 8-bit grey, grey+alpha, RGB and RGBA
non-interlaced files with any of the five scanline filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit depth only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8, row 0 = TOP -> PNG file bytes."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    h, w, c = rgb8.shape
    if c != 3:
        raise ValueError(f"encode_png expects (H, W, 3) RGB, got {rgb8.shape}")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1
    )  # leading filter byte 0 (None) on every scanline
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters of (H, 1 + stride) raw rows."""
    h = rows.shape[0]
    out = np.zeros((h, rows.shape[1] - 1), np.int32)
    prev = np.zeros(rows.shape[1] - 1, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: left neighbour is serial
            cur = np.zeros_like(line)
            for i in range(line.size):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> (H, W, C) uint8, row 0 = TOP."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); 8-bit non-interlaced only"
        )
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + w * ch)
    return _unfilter(rows, ch).reshape(h, w, ch)


def save_png(path, img, tone: str = "none", exposure: float = 1.0):
    """Write a linear (H, W, 3) float image as sRGB PNG."""
    from ..ops.tonemap import to_srgb8

    data = np.asarray(to_srgb8(img, tone=tone, exposure=exposure))
    with open(path, "wb") as f:
        f.write(encode_png(data[::-1]))


def load_png(path) -> np.ndarray:
    """Read a PNG back to linear-ish float (sRGB decode), row 0 = bottom."""
    with open(path, "rb") as f:
        data = decode_png(f.read())
    if data.shape[-1] < 3:  # grey (+ alpha): replicate the grey channel
        data = np.repeat(data[..., :1], 3, axis=-1)
    srgb = data[::-1, :, :3].astype(np.float32) / 255.0
    lin = np.where(
        srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4
    )
    return lin.astype(np.float32)
