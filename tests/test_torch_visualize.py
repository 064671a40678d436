"""The port's Visualizer and RGB PNG writer against the JAX package's
Visualizer (PIL and matplotlib): decoded pixels equal, on the inputs of
tests/test_visualize.py."""

import numpy as np
import pytest
from PIL import Image

from vfloodnet_tpu.utils.visualize import Visualizer as JVisualizer
from vfloodnet_tpu_torch import native
from vfloodnet_tpu_torch.utils.visualize import Visualizer


def _inputs():
    rng = np.random.RandomState(0)
    img = (rng.rand(60, 80, 3) * 255).astype(np.uint8)
    mask = np.zeros((60, 80), np.uint8)
    mask[30:, :] = 1
    mask[5:15, 10:30] = 2
    depth = np.where(mask > 0, np.linspace(0, 50, 60)[:, None]
                     * np.ones((60, 80)), np.nan)
    return img, mask, depth


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def test_plot_seg_pixels_equal_jax(tmp_path):
    img, mask, _ = _inputs()
    JVisualizer().plot_seg(img, mask, str(tmp_path / "jax.png"))
    Visualizer().plot_seg(img, mask, str(tmp_path / "port.png"))
    want = _pixels(tmp_path / "jax.png")
    got = _pixels(tmp_path / "port.png")
    assert got.shape == want.shape == (60, 80, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["masked", "all_nan"])
def test_plot_depth_pixels_equal_jax(tmp_path, case):
    """The same matplotlib code on both sides: equal decoded pixels, for
    a masked depth map and for one with no estimate."""
    img, mask, depth = _inputs()
    if case == "masked":
        args, kwargs = (img, depth), {"mask": mask}
    else:
        args, kwargs = (img, np.full((60, 80), np.nan)), {}
    JVisualizer().plot_depth(*args, str(tmp_path / "jax.png"), **kwargs)
    Visualizer().plot_depth(*args, str(tmp_path / "port.png"), **kwargs)
    want = _pixels(tmp_path / "jax.png")
    got = _pixels(tmp_path / "port.png")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(1, 1), (37, 53), (120, 160)])
def test_rgb_png_round_trip(tmp_path, hw):
    """PIL and the port's reader decode the writer's bytes to the array;
    the reader refuses a palette PNG."""
    rgb = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,),
                                               dtype=np.uint8)
    path = str(tmp_path / "rgb.png")
    assert native.write_rgb_png(path, rgb)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), rgb)
    np.testing.assert_array_equal(native.read_rgb_png(path), rgb)
    native.write_palette_png(path, rgb[..., 0], [0, 0, 0] * 256)
    with pytest.raises(native.UnsupportedPNG):
        native.read_rgb_png(path)
    with pytest.raises(ValueError):
        native.write_rgb_png(path, rgb[..., 0])
