"""The whole slice: the port's video engine vs the JAX engine.

- Random init (mirror of tests/test_golden.py): JAX weights from
  PRNGKey(0) carried across by the weight bridge; label agreement with the
  JAX engine's labels > 0.999.
- Trained weights (mirror of tests/test_demo_e2e.py's lake clip): IoU
  >= 0.75 against the ground truth on every frame, and agreement > 0.97
  with tests/golden/demo_lake_golden.npz, which the JAX engine produced.
- The CLI runner on a small frame directory (the image model makes a
  missing first mask: tests/test_torch_image_seg.py).
"""

import os
from glob import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu.pipelines.video_seg import VideoSegEngine as JEngine
from vfloodnet_tpu_torch.core import convert_afb_urr_variables
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.pipelines import load_afb_urr, run_video_segmentation
from vfloodnet_tpu_torch.pipelines.video_seg import (VideoSegEngine,
                                                     host_largest_cc)

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL = os.path.join(REPO, "records", "demo_eval", "lake")
GOLDEN = os.path.join(REPO, "tests", "golden", "demo_lake_golden.npz")


def _iou(a, b):
    a, b = a > 0, b > 0
    return np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)


def _clip(seed=123, n=4, hw=(48, 64)):
    rng = np.random.RandomState(seed)
    frames = [rng.rand(*hw, 3).astype(np.float32) for _ in range(n)]
    mask0 = np.zeros(hw, np.uint8)
    mask0[hw[0] // 2:, :] = 1
    return frames, mask0


def test_random_init_engine_matches_jax_engine():
    jm = JAFBURR(read_chunk=128)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((48, 64, 3)),
                        jnp.zeros((2, 48, 64)), method=jm.init_all)
    port = AFBURR()
    port.load_state_dict(convert_afb_urr_variables(variables))
    frames, mask0 = _clip()

    jeng = JEngine(jm, variables, JFeatureBank(obj_n=2, memory_budget=1024),
                   downsample=48, postprocess="none")
    teng = VideoSegEngine(port, FeatureBank(obj_n=2, memory_budget=1024,
                                            device="cpu"),
                          downsample=48, postprocess="none")
    js = jeng.bootstrap(frames[0], mask0)
    ts = teng.bootstrap(frames[0], mask0)
    want, got = [], []
    for i, f in enumerate(frames[1:]):
        js, jl = jeng.step(js, f, i + 1)
        ts, tl = teng.step(ts, f, i + 1)
        want.append(jeng.fetch_label(jl))
        got.append(teng.fetch_label(tl))
    np.testing.assert_array_equal(ts.occ.numpy(), np.asarray(js.occ))
    agreement = (np.stack(got) == np.stack(want)).mean()
    assert agreement > 0.999, agreement


def test_trained_engine_propagates_lake_clip():
    import cv2
    from PIL import Image

    from vfloodnet_tpu_torch.utils import load_mask

    model = load_afb_urr(device="cpu")
    frames = sorted(glob(os.path.join(EVAL, "frames", "*.jpg")),
                    key=lambda p: int(os.path.splitext(
                        os.path.basename(p))[0]))
    masks = [load_mask(os.path.join(EVAL, "masks", os.path.splitext(
        os.path.basename(p))[0] + ".png")) for p in frames]
    imgs = [np.asarray(Image.open(p).convert("RGB"), np.uint8)
            for p in frames]
    eng = VideoSegEngine(model, FeatureBank(obj_n=2, memory_budget=65_536,
                                            device="cpu"),
                         downsample=240, postprocess="host")
    state = eng.bootstrap(imgs[0], masks[0])
    preds, ious = [], []
    for i, img in enumerate(imgs[1:]):
        state, lab = eng.step(state, img, i + 1)
        pred = host_largest_cc(eng.fetch_label(lab))
        preds.append(pred)
        ious.append(_iou(pred, masks[i + 1]))
    assert min(ious) >= 0.75, ious
    want = np.load(GOLDEN)["labels"]
    got = np.stack([cv2.resize(p, want.shape[1:][::-1],
                               interpolation=cv2.INTER_NEAREST)
                    for p in preds])
    agreement = (got == want).mean()
    assert agreement > 0.97, agreement


def test_cli_runner_writes_masks(tmp_path):
    from PIL import Image

    from vfloodnet_tpu_torch.utils import load_mask, save_seg_mask

    frames, mask0 = _clip(n=3)
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray((f * 255).astype(np.uint8)).save(src / f"{i}.png")
    torch.manual_seed(0)
    model = AFBURR().eval()
    # a missing first mask is made by the image model: here from a
    # checkpoint that does not exist
    with pytest.raises(FileNotFoundError, match="image checkpoint"):
        run_video_segmentation(str(src), "clip", str(tmp_path / "out"),
                               model=model, device="cpu",
                               image_model_path=str(tmp_path / "no.npz"))
    first = tmp_path / "mask0.png"
    save_seg_mask(mask0, str(first))
    out = run_video_segmentation(str(src), "clip", str(tmp_path / "out"),
                                 model=model, budget=1024, downsample=48,
                                 first_mask_path=str(first), device="cpu")
    assert out["frames"] == 2
    written = sorted(os.listdir(out["mask_dir"]))
    assert written == ["0.png", "1.png", "2.png"]
    np.testing.assert_array_equal(load_mask(os.path.join(out["mask_dir"],
                                                         "0.png")), mask0)
    assert load_mask(os.path.join(out["mask_dir"], "2.png")).shape == (48, 64)
