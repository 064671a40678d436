"""The image path against the JAX package's, on the CPU with the bundled
trained LinkNet, on the first two frames of the lake clip
(``records/demo_eval/lake/frames``, 1920 x 1080):

- the batched forward with the device tail and the host tail, against
  JAX's ``_jit_forward_device_tail`` and ``_host_tail``: masks agree on
  > 0.999 of pixels;
- the single-image device pipeline (antialiased resize in) against JAX's
  ``_build_pipeline``: > 0.999;
- the video runner with a missing first mask makes it with the image
  model, and it agrees with what JAX's ``run_image_segmentation`` writes on
  the CPU (its host tail) on > 0.999.

JAX's EfficientNet runs at 416 only in the module fixture.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.models.linknet import load_linknet as j_load_linknet
from vfloodnet_tpu.pipelines import image_seg as jimg
from vfloodnet_tpu.pipelines.video_seg import unpack_bits as j_unpack_bits
from vfloodnet_tpu_torch.pipelines import image_seg, load_linknet
from vfloodnet_tpu_torch.pipelines.video_seg import run_video_segmentation
from vfloodnet_tpu_torch.utils import load_mask

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = os.path.join(REPO, "records", "demo_eval", "lake", "frames")
PATHS = [os.path.join(FRAMES, f"{i}.jpg") for i in (0, 1)]


@pytest.fixture(scope="module")
def lake():
    """The two frames, their 416 inputs, and JAX's outputs on them."""
    imgs, inputs = zip(*(image_seg.read_image(p) for p in PATHS))
    hw = imgs[0].shape[:2]
    jm, variables = j_load_linknet(None)
    batch = jnp.asarray(np.stack(inputs))
    probs = np.asarray(jimg._jit_forward(jm)(variables, batch))
    tail = j_unpack_bits(np.asarray(jimg._jit_forward_device_tail(
        jm, True)(variables, batch, hw)), hw[1])
    pipe = np.asarray(jimg._build_pipeline(jm, variables)(
        jnp.asarray(imgs[0].astype(np.float32) / 255.0)))
    return imgs, np.stack(inputs), probs, tail, pipe


@pytest.fixture(scope="module")
def port():
    return load_linknet(device="cpu")


def test_tails_match_jax(lake, port):
    imgs, inputs, probs, tail, _ = lake
    hw = imgs[0].shape[:2]
    batch = torch.from_numpy(inputs)
    with torch.no_grad():
        got_probs = port(batch)[..., 0].numpy()
    np.testing.assert_allclose(got_probs, probs, atol=1e-4)
    packed = image_seg.device_tail(port, batch, hw).numpy()
    got_tail = image_seg.unpack_bits(packed, hw[1])
    assert got_tail.shape == (2, *hw)
    assert (got_tail == tail).mean() > 0.999
    for j in range(2):
        want = jimg._host_tail(probs[j], hw, True)
        got = image_seg.host_tail(got_probs[j], hw)
        assert (got == want).mean() > 0.999
        assert 0.05 < got.mean() < 0.95      # water and land both present


def test_device_pipeline_matches_jax(lake, port):
    imgs, _, _, _, pipe = lake
    got = image_seg.device_pipeline(
        port, torch.from_numpy(imgs[0].astype(np.float32) / 255.0)).numpy()
    assert got.shape == pipe.shape and got.dtype == np.uint8
    assert (got == pipe).mean() > 0.999


def test_video_runner_bootstraps_first_mask(lake, tmp_path):
    imgs, _, probs, _, _ = lake
    src = tmp_path / "frames"
    src.mkdir()
    for p in PATHS:
        shutil.copy(p, src)
    out = run_video_segmentation(str(src), "lake", str(tmp_path / "out"),
                                 budget=4096, downsample=96, device="cpu")
    first = load_mask(os.path.join(out["mask_dir"], "0.png"))
    want = jimg._host_tail(probs[0], imgs[0].shape[:2], True)
    assert first.shape == want.shape
    assert (first == want).mean() > 0.999
    assert out["frames"] == 1
    assert load_mask(os.path.join(out["mask_dir"], "1.png")).shape == \
        want.shape
