"""The video trainer's loop and CLI, on the CPU, starting from the
bundled trained checkpoint in the training form, on an in-memory dataset
of seeded 32 x 32 clips:

- ``run_video_training`` for 1 epoch with live BatchNorm writes
  ``metrics.jsonl``, the source snapshot, ``final.pt``, ``best.pt`` and
  ``best.npz``, and the step moved the weights and the statistics;
- 2 epochs, and 1 epoch resumed from ``final.pt`` to 2: the same losses,
  and the same weights, statistics and optimiser state, exactly;
- ``best.npz`` through the JAX package's ``load_afb_urr`` and through the
  port's gives the same ``memorize`` output (1e-4 relative);
- the CLI ``python -m vfloodnet_tpu_torch.train.train_video`` on the demo
  set (``records/demo_train``) with ``--device cpu`` trains an epoch from
  its seeded init.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.pipelines.loaders import load_afb_urr as j_load_afb_urr
from vfloodnet_tpu_torch.pipelines import load_afb_urr
from vfloodnet_tpu_torch.train import VideoTrainConfig, run_video_training

from torch_train_common import make_clips, port_model

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(clip_n=3, max_obj_n=2, output_size=32, update_bn=True, lr=1e-4,
           seed=0)


class ClipSet:
    """Four seeded clips; sample ``idx`` of epoch ``epoch`` is a pure
    function of (epoch, idx)."""

    def __len__(self):
        return 4

    def get(self, idx, epoch=0):
        frames, masks = make_clips(seed=1000 * epoch + idx, b=1)
        return frames[0], masks[0], 2


@pytest.fixture(scope="module")
def trained():
    from vfloodnet_tpu_torch.core.checkpoint import load_flat_npz
    return load_flat_npz(os.path.join(REPO, "records", "checkpoints",
                                      "video", "best.npz"))


def _epochs(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["event"] == "epoch"]


def test_one_epoch_writes_its_files(trained, tmp_path):
    model = port_model(trained)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    log = str(tmp_path / "log")
    best = run_video_training(model, VideoTrainConfig(epochs=1, **CFG),
                              ClipSet(), log, batch_size=2, log_every=1)
    assert best == os.path.join(log, "best.npz")
    for name in ("final.pt", "best.pt", "best.npz", "metrics.jsonl"):
        assert os.path.exists(os.path.join(log, name)), name
    assert os.path.exists(os.path.join(log, "scripts", "vfloodnet_tpu_torch",
                                       "train", "loops.py"))
    (rec,) = _epochs(log)
    assert rec["step"] == 2 and np.isfinite(rec["loss"])
    blob = torch.load(os.path.join(log, "final.pt"), weights_only=True)
    assert blob["step"] == 2 and blob["epoch"] == 0
    after = model.state_dict()
    assert not torch.equal(after["decoder.pred2.weight"],
                           before["decoder.pred2.weight"])
    assert not torch.equal(after["encoder_q.backbone.bn1.mean"],
                           before["encoder_q.backbone.bn1.mean"])


def test_resume_equals_a_run_that_did_not_stop(trained, tmp_path):
    whole, first = str(tmp_path / "whole"), str(tmp_path / "first")
    run_video_training(port_model(trained), VideoTrainConfig(epochs=2,
                                                             **CFG),
                       ClipSet(), whole, batch_size=2)
    run_video_training(port_model(trained), VideoTrainConfig(epochs=1,
                                                             **CFG),
                       ClipSet(), first, batch_size=2)
    resumed = port_model(trained)
    run_video_training(resumed, VideoTrainConfig(epochs=2, **CFG),
                       ClipSet(), first, batch_size=2,
                       resume=os.path.join(first, "final.pt"))
    assert [r["loss"] for r in _epochs(first)] == \
        [r["loss"] for r in _epochs(whole)]
    a = torch.load(os.path.join(whole, "final.pt"), weights_only=True)
    b = torch.load(os.path.join(first, "final.pt"), weights_only=True)
    assert a["step"] == b["step"] == 4 and a["epoch"] == b["epoch"] == 1
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 4
    for part in ("mu", "nu"):
        for k, v in a["optimizer"][part].items():
            assert torch.equal(v, b["optimizer"][part][k]), (part, k)


def test_best_npz_loads_in_both_packages(trained, tmp_path):
    log = str(tmp_path / "log")
    best = run_video_training(port_model(trained),
                              VideoTrainConfig(epochs=1, **CFG), ClipSet(),
                              log, batch_size=2)
    frames, masks = make_clips(hw=48, b=1)
    port = load_afb_urr(best, device="cpu")
    with torch.no_grad():
        k, v = port.memorize(torch.from_numpy(frames[0, 0]),
                             torch.from_numpy(masks[0, 0]))
    jm, variables = j_load_afb_urr(best)
    jk, jv = jm.apply(variables, jnp.asarray(frames[0, 0]),
                      jnp.asarray(masks[0, 0]), method=jm.memorize)
    for got, want in ((k, jk), (v, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_cli_trains_on_the_demo_set(tmp_path):
    log = str(tmp_path / "cli")
    proc = subprocess.run(
        [sys.executable, "-m", "vfloodnet_tpu_torch.train.train_video",
         "--dataset", os.path.join(REPO, "records", "demo_train"),
         "--log", log, "--total-epochs", "1", "--clip-n", "2",
         "--obj-n", "2", "--output-size", "32", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Training done" in proc.stdout
    (rec,) = _epochs(log)
    assert rec["step"] == 3 and np.isfinite(rec["loss"])
    assert os.path.exists(os.path.join(log, "best.npz"))
