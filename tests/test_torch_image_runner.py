"""The port's image runner against the JAX package's, on the CPU, with
the bundled trained LinkNet on the demo stills
(``records/demo_train/JPEGImages/img_exp``, two sizes, so both runners
take the host tail):

- the runner returns (mask, overlay) pairs in the JAX runner's order and
  layout, ``<out>/<name>/{mask,overlay}/<image>.png``, and the files
  decode to the JAX runner's, pixel for pixel;
- ``dtype=torch.bfloat16``: the port's bf16 masks agree with the JAX
  runner's bf16 ones at least as well as the JAX bf16 runner's agree with
  its float32 ones, less 0.01 (bf16 labels move with rounding order,
  ROADMAP "bf16 labels move with rounding order"), and the caller's model
  keeps its float32 weights;
- ``workers=2`` writes the same files and returns the same pairs as the
  default, which starts no thread.
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vfloodnet_tpu.models.linknet import load_linknet as j_load_linknet
from vfloodnet_tpu.pipelines.image_seg import \
    run_image_segmentation as j_run
from vfloodnet_tpu_torch.pipelines import load_linknet
from vfloodnet_tpu_torch.pipelines.image_seg import run_image_segmentation
from vfloodnet_tpu_torch.utils import load_mask

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(REPO, "records", "demo_train", "JPEGImages",
                      "img_exp")


def _png(path):
    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX runner's pairs in float32 and in bf16."""
    out = tmp_path_factory.mktemp("jax")
    runs = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jm, variables = j_load_linknet(None, dtype=dtype)
        runs[name] = j_run(IMAGES, name, str(out), model=jm,
                           variables=variables)
    return runs


@pytest.fixture(scope="module")
def port_model():
    return load_linknet(device="cpu")


def test_pairs_masks_and_overlays_match_jax(jax_runs, port_model, tmp_path):
    pairs = run_image_segmentation(IMAGES, "f32", str(tmp_path),
                                   model=port_model, device="cpu")
    want = jax_runs["f32"]
    assert len(pairs) == len(want) == 2
    for (mask, overlay), (j_mask, j_overlay) in zip(pairs, want):
        assert os.path.relpath(mask, tmp_path) == os.path.join(
            "f32", "mask", os.path.basename(j_mask))
        assert os.path.relpath(overlay, tmp_path) == os.path.join(
            "f32", "overlay", os.path.basename(j_overlay))
        np.testing.assert_array_equal(load_mask(mask), load_mask(j_mask))
        np.testing.assert_array_equal(_png(overlay), _png(j_overlay))


def test_bf16_runner_within_the_jax_bf16_gap(jax_runs, port_model,
                                             tmp_path):
    pairs = run_image_segmentation(IMAGES, "bf16", str(tmp_path),
                                   device="cpu", dtype=torch.bfloat16)
    got = np.concatenate([load_mask(m).ravel() for m, _ in pairs])
    j16 = np.concatenate([load_mask(m).ravel() for m, _ in jax_runs["bf16"]])
    j32 = np.concatenate([load_mask(m).ravel() for m, _ in jax_runs["f32"]])
    gap = (j16 == j32).mean()
    assert (got == j16).mean() >= gap - 0.01, ((got == j16).mean(), gap)
    assert 0.05 < got.mean() < 0.95
    with pytest.raises(ValueError):
        run_image_segmentation(IMAGES, "x", str(tmp_path), model=port_model,
                               device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in port_model.parameters())


def test_writer_pool_is_opt_in_and_writes_the_same(port_model, tmp_path,
                                                   monkeypatch):
    started = []
    real_start = threading.Thread.start

    def start(self):
        started.append(self.name)
        return real_start(self)

    monkeypatch.setattr(threading.Thread, "start", start)
    inline = run_image_segmentation(IMAGES, "a", str(tmp_path),
                                    model=port_model, device="cpu")
    assert started == []
    pooled = run_image_segmentation(IMAGES, "b", str(tmp_path),
                                    model=port_model, device="cpu",
                                    workers=2)
    assert started
    for (m0, o0), (m1, o1) in zip(inline, pooled):
        assert os.path.basename(m0) == os.path.basename(m1)
        np.testing.assert_array_equal(_png(m0), _png(m1))
        np.testing.assert_array_equal(_png(o0), _png(o1))
