"""The video trainer on the card. Marked ``cuda``; each test skips where
there is no GPU. Run on a GPU machine with ``python -m pytest --noconftest
-m cuda tests/test_torch_train_cuda.py``.

- ``chip_smoke.py`` phase 15(b), one case for each of its clips (the wavy
  clip and the scene clip, 240 px, 3 frames, 2 objects): one step of the
  trained weights (the training form, frozen BN, cuDNN deterministic),
  card against CPU. In float64 the losses within 1e-9 relative and every
  gradient leaf within 1e-6 of its largest magnitude; in float32 the
  losses within 5e-5 relative and the gradients' global norms within
  5e-4 relative (twice the largest gaps over 8 seeded clips, see
  ``chip_smoke.train_card_cpu_phase``); and the training read launches
  none of the port's CUDA kernels.
- The same with live BatchNorm (``update_bn``) at 64 px: losses within
  1e-5 relative, every new running statistic within 1e-5.
- Two live-BN steps from the same state with cuDNN deterministic give
  equal weights and statistics.
"""

import os

import pytest
import torch

import chip_smoke
from vfloodnet_tpu_torch.core import load_flat_npz
from vfloodnet_tpu_torch.ops import bank_read_cuda
from vfloodnet_tpu_torch.train import (VideoTrainConfig,
                                       init_video_train_state,
                                       make_video_train_step)

pytestmark = pytest.mark.cuda
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "records", "checkpoints", "video", "best.npz")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def variables():
    return load_flat_npz(CKPT)


def _step(variables, dev, cfg, frames, masks):
    """One training step -> (loss, the model's state on the CPU)."""
    model = chip_smoke.training_form(variables, dev)
    step = make_video_train_step(model, init_video_train_state(model, cfg),
                                 cfg)
    loss = step(torch.from_numpy(frames).to(dev),
                torch.from_numpy(masks).to(dev)).item()
    return loss, {k: v.detach().cpu() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("clip", list(chip_smoke.CARD_CPU_CLIPS))
def test_card_step_matches_cpu(variables, dev, clip):
    bank_read_cuda.reset_launches()
    torch.backends.cudnn.deterministic = True
    try:
        chip_smoke.train_card_cpu_phase(variables, (clip,))  # raises on a miss
    finally:
        torch.backends.cudnn.deterministic = False
    assert not any(bank_read_cuda.launches.values())


def test_live_bn_step_matches_cpu_and_repeats(variables, dev):
    cfg = VideoTrainConfig(clip_n=3, max_obj_n=2, output_size=64,
                           update_bn=True, lr=1e-4)
    frames, masks = chip_smoke.wavy_clip(64, seed=1)
    torch.backends.cudnn.deterministic = True
    try:
        lc, sc = _step(variables, dev, cfg, frames, masks)
        lc2, sc2 = _step(variables, dev, cfg, frames, masks)
    finally:
        torch.backends.cudnn.deterministic = False
    lh, sh = _step(variables, torch.device("cpu"), cfg, frames, masks)
    assert lc == lc2 and all(torch.equal(v, sc2[k]) for k, v in sc.items())
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for k, v in sh.items():
        if k.endswith((".mean", ".var")):
            torch.testing.assert_close(sc[k], v, rtol=0, atol=1e-5)
