"""Bank checkpoints of the single-stream runner (``checkpoint_every``) and
resuming from them, on the CPU with a seeded random-init model.

- A run stopped after a checkpoint and run again resumes after that
  checkpoint: every mask, and the bank of the last checkpoint, equal
  those of a run without a break.
- The mirror of tests/test_pipelines.py's resume test: a rerun of a
  finished run redoes only the frames after its last checkpoint.
- An unusable checkpoint is reported and the run starts afresh; the CLI
  takes ``--checkpoint-every`` and ``--workers``.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from vfloodnet_tpu_torch.memory import FeatureBank, load_bank_checkpoint
from vfloodnet_tpu_torch.memory.checkpoint import FILE, TENSORS
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.pipelines import run_video_segmentation, video_seg
from vfloodnet_tpu_torch.utils import load_mask, save_seg_mask

torch.set_num_threads(4)
KW = dict(budget=2048, downsample=48, viz=False, postprocess="none",
          device="cpu")


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return AFBURR().eval()


def _clip(root, n=5):
    rng = np.random.RandomState(4)
    frames = root / "frames"
    frames.mkdir()
    for i in range(n):
        img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(frames / f"{i:05d}.png")
    return str(frames)


def _first_mask(out):
    mask_dir = out / "clip" / "mask"
    mask_dir.mkdir(parents=True)
    m = np.zeros((48, 64), np.uint8)
    m[24:, :] = 1
    save_seg_mask(m, str(mask_dir / "00000.png"))
    return str(mask_dir)


def _bank():
    return FeatureBank(obj_n=2, memory_budget=2048, device="cpu")


class Stopped(Exception):
    """The run's process ends here."""


def _masks(mask_dir):
    return {f: load_mask(os.path.join(mask_dir, f))
            for f in sorted(os.listdir(mask_dir))}


def test_resumed_run_equals_unbroken_run(tmp_path, model, monkeypatch):
    frames = _clip(tmp_path)
    outs = {k: tmp_path / k for k in ("unbroken", "resumed")}
    dirs = {k: _first_mask(v) for k, v in outs.items()}
    run_video_segmentation(frames, "clip", str(outs["unbroken"]),
                           model=model, checkpoint_every=2, **KW)

    step = video_seg.VideoSegEngine.step

    def stopped_at_4(self, state, frame, frame_idx):
        if frame_idx == 4:
            raise Stopped
        return step(self, state, frame, frame_idx)

    monkeypatch.setattr(video_seg.VideoSegEngine, "step", stopped_at_4)
    with pytest.raises(Stopped):
        run_video_segmentation(frames, "clip", str(outs["resumed"]),
                               model=model, checkpoint_every=2, **KW)
    ckpt = os.path.join(outs["resumed"], "clip", "bank_ckpt")
    assert load_bank_checkpoint(ckpt, _bank())[1] == 2
    assert len(os.listdir(dirs["resumed"])) == 3   # frames 0-2 written
    monkeypatch.setattr(video_seg.VideoSegEngine, "step", step)
    res = run_video_segmentation(frames, "clip", str(outs["resumed"]),
                                 model=model, checkpoint_every=2, **KW)
    assert res["frames"] == 2                      # frames 3 and 4

    want, got = _masks(dirs["unbroken"]), _masks(dirs["resumed"])
    assert sorted(got) == sorted(want) and len(got) == 5
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    banks = {k: load_bank_checkpoint(os.path.join(v, "clip", "bank_ckpt"),
                                     _bank()) for k, v in outs.items()}
    assert banks["unbroken"][1] == banks["resumed"][1] == 4
    for name in TENSORS:
        assert torch.equal(getattr(banks["unbroken"][0], name),
                           getattr(banks["resumed"][0], name)), name


def test_rerun_resumes_after_last_checkpoint(tmp_path, model):
    frames = _clip(tmp_path)
    mask_dir = _first_mask(tmp_path / "out")
    run_video_segmentation(frames, "clip", str(tmp_path / "out"),
                           model=model, checkpoint_every=3, **KW)
    assert os.path.isfile(os.path.join(tmp_path, "out", "clip", "bank_ckpt",
                                       FILE))
    assert len(os.listdir(mask_dir)) == 5
    res = run_video_segmentation(frames, "clip", str(tmp_path / "out"),
                                 model=model, checkpoint_every=3, **KW)
    assert res["frames"] == 1        # only the tail after frame 3 reruns
    assert len(os.listdir(mask_dir)) == 5


def test_unusable_checkpoint_starts_fresh(tmp_path, model, capsys,
                                          monkeypatch):
    frames = _clip(tmp_path)
    _first_mask(tmp_path / "out")
    ckpt = tmp_path / "out" / "clip" / "bank_ckpt"
    ckpt.mkdir()
    (ckpt / FILE).write_bytes(b"not a checkpoint")
    res = run_video_segmentation(frames, "clip", str(tmp_path / "out"),
                                 model=model, checkpoint_every=2, **KW)
    assert res["frames"] == 4
    assert "bank checkpoint unusable" in capsys.readouterr().out
    # a checkpoint of another budget does not fit
    with pytest.raises(ValueError, match="holds"):
        load_bank_checkpoint(str(ckpt), FeatureBank(
            obj_n=2, memory_budget=4096, device="cpu"))
    monkeypatch.setattr("sys.argv", ["video_seg", "--test-path", frames,
                                     "--test-name", "clip",
                                     "--checkpoint-every", "3",
                                     "--workers", "2"])
    args = video_seg._args()
    assert args.checkpoint_every == 3 and args.workers == 2
