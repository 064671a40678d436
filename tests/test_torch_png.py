"""The port's mask PNG IO (``vfloodnet_tpu_torch/native``: numpy and
``zlib``, no PIL, no libpng): the five cases of tests/test_native_io.py
(round trip, PIL reads the port's file, the port reads PIL's, the
``save_seg_mask`` / ``load_mask`` round trip, the writer against PIL on a
1080p mask), grey PNGs from PIL and with each of the five row filters,
the refusals, and both
directions against the JAX package's libpng library, labels and palette
equal."""

import time

import numpy as np
import pytest
from PIL import Image

from vfloodnet_tpu import native as jnative
from vfloodnet_tpu_torch import native
from vfloodnet_tpu_torch.utils import COLOR_PALETTE, load_mask, save_seg_mask


def test_round_trip(tmp_path):
    labels = (np.random.RandomState(0).rand(123, 201) * 3).astype(np.uint8)
    path = str(tmp_path / "m.png")
    assert native.available()
    assert native.write_palette_png(path, labels, COLOR_PALETTE)
    np.testing.assert_array_equal(native.read_palette_png(path), labels)


def test_pil_reads_the_port_and_the_port_reads_pil(tmp_path):
    labels = np.zeros((50, 60), np.uint8)
    labels[20:, :] = 1
    path = str(tmp_path / "m.png")
    native.write_palette_png(path, labels, COLOR_PALETTE)
    with Image.open(path) as img:
        assert img.mode == "P"
        np.testing.assert_array_equal(np.asarray(img), labels)
        assert img.getpalette()[3:6] == [0, 0, 128]
    labels = (np.random.RandomState(1).rand(40, 30) * 2).astype(np.uint8)
    img = Image.fromarray(labels, "P")
    img.putpalette(COLOR_PALETTE)
    img.save(str(tmp_path / "pil.png"))
    np.testing.assert_array_equal(
        native.read_palette_png(str(tmp_path / "pil.png")), labels)


@pytest.mark.parametrize("kind", ["noise", "stripes", "mask"])
def test_reads_pil_grey_with_every_filter(tmp_path, kind):
    """PIL filters grey images row by row (all five filters turn up in
    these); the reader undoes each."""
    rng = np.random.RandomState(2)
    arr = {"noise": (rng.rand(61, 83) * 255).astype(np.uint8),
           "stripes": np.tile((np.arange(200) // 7 % 3).astype(np.uint8),
                              (50, 1)),
           "mask": (np.add.outer(np.arange(90), 2 * np.arange(120)) % 97
                    > 40).astype(np.uint8)}[kind]
    path = str(tmp_path / "grey.png")
    Image.fromarray(arr, "L").save(path)
    np.testing.assert_array_equal(native.read_palette_png(path), arr)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def test_every_row_filter(tmp_path):
    """Rows filtered in turn with None, Sub, Up, Average and Paeth (the
    PNG specification's definitions, written out per byte here) decode to
    the image."""
    import struct
    import zlib
    img = (np.random.RandomState(5).rand(25, 33) * 256).astype(np.int64)
    rows = []
    for y in range(img.shape[0]):
        kind = y % 5
        out = [kind]
        for x in range(img.shape[1]):
            a = img[y, x - 1] if x else 0
            b = img[y - 1, x] if y else 0
            c = img[y - 1, x - 1] if x and y else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((img[y, x] - pred) % 256)
        rows.append(bytes(out))
    path = str(tmp_path / "filters.png")
    with open(path, "wb") as f:
        f.write(native.SIGNATURE + native._chunk(b"IHDR", struct.pack(
            ">IIBBBBB", img.shape[1], img.shape[0], 8, native.GREY, 0, 0, 0))
            + native._chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + native._chunk(b"IEND", b""))
    np.testing.assert_array_equal(native.read_palette_png(path), img)


def test_save_seg_mask_round_trip_and_refusals(tmp_path):
    """``save_seg_mask`` / ``load_mask`` go through the port's IO; the
    reader refuses a PNG it does not take, and ``load_mask`` gives such a
    file to PIL."""
    labels = (np.random.RandomState(2).rand(64, 64) * 2).astype(np.uint8)
    path = str(tmp_path / "seg.png")
    save_seg_mask(labels, path)
    np.testing.assert_array_equal(native.read_palette_png(path), labels)
    np.testing.assert_array_equal(load_mask(path), labels)
    rgb = str(tmp_path / "rgb.png")
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(rgb)
    with pytest.raises(native.UnsupportedPNG):
        native.read_palette_png(rgb)
    assert load_mask(rgb).shape == (4, 5)
    one_bit = str(tmp_path / "bits.png")
    Image.fromarray(labels.astype(bool)).save(one_bit)
    with pytest.raises(native.UnsupportedPNG):
        native.read_palette_png(one_bit)


def test_against_the_jax_library(tmp_path):
    """The JAX package's libpng reads the port's file and the port reads
    libpng's: labels equal, and the palettes equal as PIL reads them."""
    if not jnative.available():
        pytest.skip("the JAX package's native library did not build")
    labels = (np.random.RandomState(4).rand(270, 480) * 3).astype(np.uint8)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    native.write_palette_png(ours, labels, COLOR_PALETTE)
    assert jnative.write_palette_png(theirs, labels, COLOR_PALETTE)
    np.testing.assert_array_equal(jnative.read_palette_png(ours), labels)
    np.testing.assert_array_equal(native.read_palette_png(theirs), labels)
    with Image.open(ours) as a, Image.open(theirs) as b:
        assert a.getpalette() == b.getpalette()
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_writer_against_pil_1080p(tmp_path):
    """A 1080p two-label mask: the port writes it in less than half of
    PIL's time (the JAX library's bar), and reads it back equal."""
    labels = (np.random.RandomState(3).rand(1080, 1920) * 2).astype(
        np.uint8)
    path_n, path_p = str(tmp_path / "n.png"), str(tmp_path / "p.png")
    t0 = time.perf_counter()
    for _ in range(3):
        native.write_palette_png(path_n, labels, COLOR_PALETTE)
    t_port = (time.perf_counter() - t0) / 3
    img = Image.fromarray(labels, "P")
    img.putpalette(COLOR_PALETTE)
    t0 = time.perf_counter()
    for _ in range(3):
        img.save(path_p)
    t_pil = (time.perf_counter() - t0) / 3
    t0 = time.perf_counter()
    back = native.read_palette_png(path_n)
    t_read = time.perf_counter() - t0
    print(f"1080p mask: write {1e3 * t_port:.1f} ms, PIL {1e3 * t_pil:.1f} "
          f"ms, read {1e3 * t_read:.1f} ms")
    np.testing.assert_array_equal(back, labels)
    assert t_port < t_pil / 2, (t_port, t_pil)
