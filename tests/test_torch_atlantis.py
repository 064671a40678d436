"""The port's Atlantis harness (``pipelines/atlantis.py``) against the JAX
package's ``test_atlantis_model.main`` on the CPU.

Three seeded synthetic PNGs at ``--padding-size 96``: one inside the
padding, one oversize (shrunk first: the cv2 branch, whose long side
comes out at the padding, so the right pad is 0 and every column is
kept), one as tall as the padding. Both harnesses run with JAX's
``PRNGKey(0)`` variables: JAX's from its own init (jitted here, which
draws the same values as its eager init), the port's from a ``.npz``
of them that the test writes. The classifier's bias is raised by 1.5 on
three water classes in both, so that the random network labels some
pixels water and the overlay has something to draw. Bars: each ``_color.png``'s labels at
least 0.999 equal to JAX's, and each ``_water.png``'s pixels equal
wherever the labels are."""

import argparse
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import test_atlantis_model as jharness
from vfloodnet_tpu_torch.core.checkpoint import save_flat_npz
from vfloodnet_tpu_torch.pipelines import atlantis
from vfloodnet_tpu_torch.pipelines.loaders import load_pspnet

torch.set_num_threads(4)
PAD = 96
WATER_LABELS = jharness.WATER_LABELS
SIZES = {"inside": (60, 80), "oversize": (120, 150), "tall": (96, 50)}


def _write_images(root):
    rng = np.random.default_rng(0)
    for name, (h, w) in SIZES.items():
        yy, xx = np.mgrid[:h, :w] / max(h, w)
        water = yy + 0.2 * np.sin(7 * xx) > 0.5
        img = np.where(water[..., None], rng.uniform(0, 0.4, 3),
                       rng.uniform(0.5, 1.0, 3))
        img = img + 0.05 * rng.standard_normal(img.shape)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root, f"{name}.png"))


class _CapturedPSPNet(jharness.PSPNet):
    """JAX's PSPNet whose ``init`` is jitted, raises three water classes'
    bias and keeps the variables."""
    variables = None

    def init(self, *args, **kwargs):
        out = jax.tree.map(np.array, jax.jit(super().init)(*args, **kwargs))
        out["params"]["cls"]["bias"][list(WATER_LABELS[:3])] += 1.5
        _CapturedPSPNet.variables = out
        return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("atlantis")
    data = root / "images"
    data.mkdir()
    _write_images(str(data))
    missing = str(root / "no_checkpoint")
    jargs = argparse.Namespace(model="PSPNet", num_classes=56,
                               padding_size=PAD, data_directory=str(data),
                               restore_from=missing,
                               save_path=str(root / "jax"))
    saved = jharness.PSPNet
    jharness.PSPNet = _CapturedPSPNet
    try:
        with pytest.warns(UserWarning):
            jharness.main(jargs)
    finally:
        jharness.PSPNet = saved
    weights = str(root / "pspnet.npz")
    save_flat_npz(weights, _CapturedPSPNet.variables)
    atlantis.main(atlantis.get_arguments([
        "--padding-size", str(PAD), "--data-directory", str(data),
        "--restore-from", weights, "--save-path", str(root / "port"),
        "--device", "cpu"]))
    return root


def _read(path, mode):
    with Image.open(path) as im:
        return np.asarray(im if mode == "P" else im.convert(mode))


def test_same_outputs_as_jax(runs):
    want = sorted(os.listdir(runs / "jax"))
    assert want == sorted(f"{n}_{k}.png" for n in SIZES
                          for k in ("color", "water"))
    assert sorted(os.listdir(runs / "port")) == want
    labels = np.concatenate([_read(runs / "jax" / f"{n}_color.png", "P")
                             .ravel() for n in SIZES])
    water = np.isin(labels, WATER_LABELS).mean()
    assert 0.05 < water < 0.95, water


@pytest.mark.parametrize("name", sorted(SIZES))
def test_labels_and_water_overlay_match_jax(runs, name):
    want = _read(runs / "jax" / f"{name}_color.png", "P")
    got = _read(runs / "port" / f"{name}_color.png", "P")
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.999
    same = got == want
    want_water = _read(runs / "jax" / f"{name}_water.png", "RGB")
    got_water = _read(runs / "port" / f"{name}_water.png", "RGB")
    assert got_water.shape == want_water.shape == want.shape + (3,)
    np.testing.assert_array_equal(got_water[same], want_water[same])


def test_water_labels_and_defaults_are_jax(runs, monkeypatch):
    """The port's copy of the water classes, and the CLI's defaults, plus
    ``--device`` 'cuda' (no CUDA here, so loading raises)."""
    assert atlantis.WATER_LABELS == WATER_LABELS
    monkeypatch.setattr("sys.argv", ["test_atlantis_model.py"])
    want = vars(jharness.get_arguments())
    got = vars(atlantis.get_arguments([]))
    assert got.pop("device") == "cuda"
    assert got == want
    with pytest.raises(RuntimeError):
        load_pspnet(str(runs / "pspnet.npz"))


def test_orbax_folder_raises(tmp_path):
    folder = tmp_path / "best"
    folder.mkdir()
    (folder / "checkpoint").write_bytes(b"")
    with pytest.raises(ValueError):
        load_pspnet(str(folder), device="cpu")
