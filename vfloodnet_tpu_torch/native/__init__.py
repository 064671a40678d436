"""Indexed-PNG mask IO without PIL (counterpart of
``vfloodnet_tpu.native``, whose libpng library the port does not build).

The masks that the runners write and read are 8-bit palette PNGs. Here
they are encoded and decoded with numpy and Python's own ``zlib``, so the
port writes and reads them on a machine with no PIL, no libpng headers
and no compiler. The writer makes what the JAX package's libpng writer
makes: an 8-bit palette image, filter byte 0 on every row, deflate at
``compress_level`` (one IDAT chunk). :func:`write_rgb_png` writes an
8-bit RGB image the same way (the overlays, which the JAX package writes
with PIL), and :func:`read_rgb_png` reads such a file back. The reader
takes 8-bit palette and grey PNGs, not interlaced, with any of the five
row filters (PIL filters grey images row by row), and raises
:class:`UnsupportedPNG` on anything else; it has no fallback of its own.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
PALETTE, GREY, RGB = 3, 0, 2      # IHDR colour types


class UnsupportedPNG(ValueError):
    """A PNG that is not an 8-bit palette or grey image, or is malformed."""


def available() -> bool:
    """Always true: the IO needs nothing beyond numpy and ``zlib`` (the JAX
    package's answers whether its library built)."""
    return True


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write_png(path: str, colour: int, pixels: np.ndarray,
               extra: bytes = b"", compress_level: int = 1) -> None:
    """Write uint8 ``pixels`` [H, W] or [H, W, C] as an 8-bit PNG of IHDR
    colour type ``colour``: the chunks ``extra`` after IHDR, then the
    rows, each with filter byte 0, deflated into one IDAT chunk."""
    h, w = pixels.shape[:2]
    raw = np.zeros((h, pixels[0].size + 1), np.uint8)    # filter byte 0
    raw[:, 1:] = pixels.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr) + extra
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(),
                                                compress_level))
                + _chunk(b"IEND", b""))


def write_palette_png(path: str, labels: np.ndarray,
                      palette: Sequence[int], compress_level: int = 1
                      ) -> bool:
    """Write uint8 labels [H, W] as an 8-bit palette PNG with the first
    ``min(len(palette) // 3, 256)`` RGB entries of ``palette``; returns
    True, as the JAX writer does when it wrote the file."""
    labels = np.ascontiguousarray(labels, np.uint8)
    if labels.ndim != 2:
        raise ValueError(f"labels must be [H, W], got {labels.shape}")
    h, w = labels.shape
    pal = np.asarray(palette, np.uint8).reshape(-1)
    pal = pal[:min(len(pal) // 3, 256) * 3]
    _write_png(path, PALETTE, labels, _chunk(b"PLTE", pal.tobytes()),
               compress_level)
    return True


def write_rgb_png(path: str, rgb: np.ndarray) -> bool:
    """Write uint8 pixels [H, W, 3] in RGB order as an 8-bit RGB PNG
    (colour type 2, filter byte 0 on every row, one IDAT chunk); returns
    True."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"rgb must be [H, W, 3], got {rgb.shape}")
    _write_png(path, RGB, rgb)
    return True


def _read_chunks(path: str):
    """(IHDR fields, the concatenated IDAT data) of a PNG file."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != SIGNATURE:
        raise UnsupportedPNG(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise UnsupportedPNG(f"{path}: no IHDR")
    return header, b"".join(idat)


def read_rgb_png(path: str) -> np.ndarray:
    """The pixels [H, W, 3] uint8 of an 8-bit RGB PNG whose rows all have
    filter byte 0, as :func:`write_rgb_png` writes them; raises
    :class:`UnsupportedPNG` on any other."""
    (w, h, depth, colour, compression, filtering, interlace), data = \
        _read_chunks(path)
    if depth != 8 or colour != RGB or interlace or compression or filtering:
        raise UnsupportedPNG(f"{path}: bit depth {depth}, colour type "
                             f"{colour} (only 8-bit RGB, not interlaced)")
    raw = np.frombuffer(zlib.decompress(data), np.uint8)
    if raw.size != h * (3 * w + 1):
        raise UnsupportedPNG(f"{path}: {raw.size} bytes of image data for "
                             f"{h} x {w} x 3")
    raw = raw.reshape(h, 3 * w + 1)
    if raw[:, 0].any():
        raise UnsupportedPNG(f"{path}: rows with a filter other than 0")
    return raw[:, 1:].reshape(h, w, 3).copy()


def _unfilter(rows: np.ndarray) -> np.ndarray:
    """Rows [H, 1 + W] of filter byte and filtered bytes (one byte a
    pixel) -> the image [H, W] uint8. Rows of filters 0-2 only are undone
    row by row; with Average or Paeth rows, by anti-diagonals of the whole
    image, each cell from its left, upper and upper-left neighbours."""
    kinds, data = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise UnsupportedPNG(f"row filter {int(kinds.max())}")
    if not kinds.any():
        return np.ascontiguousarray(data)
    h, w = data.shape
    if kinds.max() <= 2:
        out = np.empty_like(data)
        prior = np.zeros(w, np.uint8)
        for y in range(h):
            if kinds[y] == 1:
                out[y] = np.cumsum(data[y], dtype=np.uint8)
            elif kinds[y] == 2:
                out[y] = data[y] + prior
            else:
                out[y] = data[y]
            prior = out[y]
        return out
    recon = np.zeros((h + 1, w + 1), np.int32)    # a zero row and column
    filt = data.astype(np.int32)
    kind = kinds.astype(np.int32)
    for k in range(2, h + w + 1):                 # cells with y + x = k
        ys = np.arange(max(1, k - w), min(h, k - 1) + 1)
        xs = k - ys
        a, b = recon[ys, xs - 1], recon[ys - 1, xs]
        c = recon[ys - 1, xs - 1]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = kind[ys - 1]
        pred = np.choose(t, (np.zeros_like(a), a, b, (a + b) >> 1, paeth))
        recon[ys, xs] = (filt[ys - 1, xs - 1] + pred) & 255
    return recon[1:, 1:].astype(np.uint8)


def read_palette_png(path: str) -> np.ndarray:
    """The labels [H, W] uint8 of an 8-bit palette or grey PNG (palette
    indices or grey levels)."""
    (w, h, depth, colour, compression, filtering, interlace), data = \
        _read_chunks(path)
    if depth != 8 or colour not in (PALETTE, GREY) or interlace \
            or compression or filtering:
        raise UnsupportedPNG(
            f"{path}: bit depth {depth}, colour type {colour}, interlace "
            f"{interlace} (only 8-bit palette or grey, not interlaced)")
    raw = np.frombuffer(zlib.decompress(data), np.uint8)
    if raw.size != h * (w + 1):
        raise UnsupportedPNG(f"{path}: {raw.size} bytes of image data for "
                             f"{h} x {w}")
    return _unfilter(raw.reshape(h, w + 1))
