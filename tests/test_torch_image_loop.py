"""The port's image-training loop on the CPU at 32 px, on a two-image dataset
(``tests/test_loops.py``'s, 64 px stills with the lower half water):

- a run of 2 epochs with a validation set (live BN) writes
  ``metrics.jsonl`` (a record an epoch), ``final.pt``, ``best.pt`` and
  ``best.npz``;
- the same run stopped after its first epoch and resumed from
  ``final.pt`` ends with the weights, statistics and optimiser state of
  the run that never stopped, exactly;
- ``best.npz`` loads through both packages' ``load_linknet`` and the two
  give the same probabilities (within 1e-5) on the same images.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vfloodnet_tpu.models.linknet import load_linknet as j_load_linknet
from vfloodnet_tpu_torch.data import WaterImageDataset
from vfloodnet_tpu_torch.pipelines.loaders import load_linknet
from vfloodnet_tpu_torch.train import (ImageTrainConfig, init_linknet,
                                       run_image_training)
from vfloodnet_tpu_torch.utils import save_seg_mask

torch.set_num_threads(4)
HW = 32


def _dataset(tmp_path):
    rng = np.random.RandomState(0)
    root = tmp_path / "ds"
    (root / "JPEGImages" / "vid0").mkdir(parents=True)
    (root / "Annotations" / "vid0").mkdir(parents=True)
    for i in range(2):
        img = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "JPEGImages" / "vid0" / f"{i}.jpg")
        m = np.zeros((64, 64), np.uint8)
        m[32:, :] = 1
        save_seg_mask(m, str(root / "Annotations" / "vid0" / f"{i}.png"))
    (root / "train_imgs.txt").write_text("vid0\n")
    (root / "val_imgs.txt").write_text("vid0\n")
    return str(root)


class _Stop(Exception):
    pass


class _StopAtEpoch(WaterImageDataset):
    """Raises when asked for a sample of epoch ``stop``: a run killed
    after its earlier epochs."""
    stop = None

    def get(self, idx, epoch=0):
        if epoch == self.stop:
            raise _Stop
        return super().get(idx, epoch)


def _run(root, log_dir, epochs, resume=None, update_bn=False, stop=None):
    cfg = ImageTrainConfig(epochs=epochs, batch_size=1, input_size=HW,
                           update_bn=update_bn)
    ds = _StopAtEpoch("train_offline", root, input_size=HW)
    ds.stop = stop
    val = WaterImageDataset("train_offline", root, input_size=HW,
                            dataset_file="val_imgs.txt")
    model = init_linknet(0, "cpu")
    best = run_image_training(model, cfg, ds, log_dir, val_dataset=val,
                              resume=resume)
    return model, best


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A run of 2 epochs with a validation set, and the same run stopped
    after its first epoch, then resumed from ``final.pt``."""
    root = _dataset(tmp_path_factory.mktemp("data"))
    whole = str(tmp_path_factory.mktemp("whole"))
    part = str(tmp_path_factory.mktemp("part"))
    model, best = _run(root, whole, 2, update_bn=True)
    with pytest.raises(_Stop):
        _run(root, part, 2, update_bn=True, stop=1)
    resumed, _ = _run(root, part, 2, update_bn=True,
                      resume=os.path.join(part, "final.pt"))
    return {"whole": whole, "part": part, "model": model, "best": best,
            "resumed": resumed}


def test_the_loop_writes_its_files(runs):
    log_dir = runs["whole"]
    assert runs["best"] == os.path.join(log_dir, "best.npz")
    for name in ("final.pt", "best.pt", "best.npz", "metrics.jsonl"):
        assert os.path.exists(os.path.join(log_dir, name)), name


def test_metrics_record_each_epoch(runs):
    with open(os.path.join(runs["whole"], "metrics.jsonl")) as f:
        rec = [json.loads(line) for line in f]
    assert [r["event"] for r in rec] == ["epoch", "epoch"]
    assert [r["step"] for r in rec] == [2, 4]
    for r in rec:
        assert 0.0 <= r["select_iou"] <= 1.0 and np.isfinite(r["dice"])


def test_resumed_weights_equal_a_run_that_did_not_stop(runs):
    a, b = runs["model"].state_dict(), runs["resumed"].state_dict()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resumed_optimiser_equals_a_run_that_did_not_stop(runs):
    ja, jb = (torch.load(os.path.join(runs[r], "final.pt"),
                         weights_only=True)["optimizer"]
              for r in ("whole", "part"))
    assert ja["count"] == jb["count"] == 4
    for k in ja["mu"]:
        assert torch.equal(ja["mu"][k], jb["mu"][k]), k
        assert torch.equal(ja["nu"][k], jb["nu"][k]), k


def test_best_npz_loads_through_both_packages(runs):
    images = np.random.default_rng(0).random((1, HW, HW, 3)).astype(
        np.float32)
    port = load_linknet(runs["best"], device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(images)).numpy()
    jm, jv = j_load_linknet(runs["best"])
    want = np.asarray(jax.jit(jm.apply)(jv, jnp.asarray(images)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
