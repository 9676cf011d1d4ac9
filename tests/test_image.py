"""PNG writer/reader (zlib + struct + NumPy, no imaging library)."""

import struct
import zlib

import numpy as np
import pytest

from ray_tracing_extended_tpu.ops.tonemap import to_srgb8
from ray_tracing_extended_tpu.utils.image import (
    decode_png,
    encode_png,
    load_png,
    save_png,
)


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (64, 33, 3)])
def test_png_round_trip(shape):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8
    )
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(data), img)


def test_save_load_png_linear_round_trip(tmp_path):
    """save_png writes top-down sRGB; load_png decodes back to linear with
    row 0 at the bottom, within one 8-bit sRGB step."""
    lin = np.random.default_rng(1).random((9, 11, 3)).astype(np.float32)
    path = tmp_path / "x.png"
    save_png(path, lin)
    back = load_png(path)
    assert back.shape == lin.shape
    # an 8-bit sRGB step is at most ~1/255 * 2.4 in linear at the top end
    np.testing.assert_allclose(back, lin, atol=0.01)
    # the file is top-down: its first row is the image's last (top) row
    np.testing.assert_array_equal(
        decode_png(path.read_bytes())[0], np.asarray(to_srgb8(lin))[-1]
    )


def _filtered_png(img, ftype):
    """Encode ``img`` (H, W, 3) with every scanline using filter ``ftype``
    (the encoder side of the PNG spec's filters 1-4)."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        line = raw[y]
        prev = raw[y - 1] if y else np.zeros_like(line)
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ftype]) + ((line - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [1, 2, 3, 4])
def test_png_decodes_every_filter(ftype):
    img = np.random.default_rng(ftype).integers(
        0, 256, (6, 5, 3), dtype=np.uint8
    )
    np.testing.assert_array_equal(decode_png(_filtered_png(img, ftype)), img)
