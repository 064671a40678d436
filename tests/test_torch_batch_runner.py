"""The runners on frame directories: the multi-stream runner
(``run_video_segmentation_batch``) against the JAX package's, and the
opt-in decode and writer pools of both runners.

- Two streams of 4 and 3 PNG frames (the JAX runner's test,
  tests/test_batch_runner.py): a mask per frame in each stream's tree, of
  the frames' size, the exhausted stream's padding not written, and every
  mask equal to the JAX runner's with the same weights (random init,
  PRNGKey(0), through the weight bridge).
- ``workers=2`` (decode ahead, write in pools) writes the same masks as
  ``workers=0``, which starts no thread, for both runners.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu.pipelines.video_seg_batch import \
    run_video_segmentation_batch as j_run_batch
from vfloodnet_tpu_torch.core import convert_afb_urr_variables
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.pipelines import (pools, run_video_segmentation,
                                           run_video_segmentation_batch)
from vfloodnet_tpu_torch.utils import load_mask, save_seg_mask

torch.set_num_threads(4)
NAMES, LENGTHS = ["vidA", "vidB"], [4, 3]


def _streams(root):
    """Frame directories of NAMES with LENGTHS frames under ``root``."""
    rng = np.random.RandomState(0)
    dirs = []
    for name, n in zip(NAMES, LENGTHS):
        d = root / name
        d.mkdir(parents=True)
        for i in range(n):
            img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"{i:03d}.png")
        dirs.append(str(d))
    return dirs


def _first_masks(out):
    """Each stream's first mask, water below row 24, in its tree under
    ``out``."""
    for name in NAMES:
        mask_dir = out / name / "mask"
        mask_dir.mkdir(parents=True)
        m = np.zeros((48, 64), np.uint8)
        m[24:, :] = 1
        save_seg_mask(m, str(mask_dir / "000.png"))


def _masks(out, name):
    mask_dir = os.path.join(out, name, "mask")
    return {f: load_mask(os.path.join(mask_dir, f))
            for f in sorted(os.listdir(mask_dir))}


@pytest.fixture(scope="module")
def weights():
    jm = JAFBURR(read_chunk=128)
    variables = jax.jit(lambda key: jm.init(
        key, jnp.zeros((48, 64, 3)), jnp.zeros((2, 48, 64)),
        method=jm.init_all))(jax.random.PRNGKey(0))
    port = AFBURR().eval()
    port.load_state_dict(convert_afb_urr_variables(variables))
    return jm, variables, port


def test_batch_runner_matches_jax_runner(tmp_path, weights):
    jm, variables, port = weights
    out = {k: tmp_path / k for k in ("jax", "port")}
    dirs = _streams(tmp_path / "src")
    for d in out.values():
        _first_masks(d)
    j_run_batch(dirs, NAMES, str(out["jax"]), jm, variables, budget=1024,
                downsample=48, viz=True)
    res = run_video_segmentation_batch(dirs, NAMES, str(out["port"]),
                                       model=port, budget=1024,
                                       downsample=48, viz=True,
                                       device="cpu")
    assert res["frames"] == (4 - 1) + (3 - 1)
    for name, n in zip(NAMES, LENGTHS):
        got, want = _masks(out["port"], name), _masks(out["jax"], name)
        assert len(got) == n and sorted(got) == sorted(want)
        overlays = os.listdir(os.path.join(out["port"], name, "overlay"))
        assert len(overlays) == n
        for f in got:
            assert got[f].shape == (48, 64)
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("batch", [True, False], ids=["batch", "single"])
def test_pools_write_the_same_masks(tmp_path, batch, monkeypatch):
    started = []

    class Counted(pools.ThreadPoolExecutor):
        def __init__(self, *args, **kwargs):
            started.append(kwargs.get("max_workers"))
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(pools, "ThreadPoolExecutor", Counted)
    torch.manual_seed(0)
    model = AFBURR().eval()
    dirs = _streams(tmp_path / "src")
    written = {}
    for workers in (0, 2):
        out = tmp_path / f"out{workers}"
        _first_masks(out)
        started.clear()
        before = threading.active_count()
        if batch:
            run_video_segmentation_batch(dirs, NAMES, str(out), model=model,
                                         budget=1024, downsample=48,
                                         viz=False, workers=workers,
                                         device="cpu")
        else:
            run_video_segmentation(dirs[0], NAMES[0], str(out), model=model,
                                   budget=1024, downsample=48, viz=False,
                                   workers=workers, device="cpu")
        assert threading.active_count() == before   # pools shut down
        # the decode and the writer pool, and none without workers
        assert started == ([workers, workers] if workers else [])
        written[workers] = {name: _masks(out, name)
                            for name in (NAMES if batch else NAMES[:1])}
    for name, masks in written[0].items():
        assert sorted(masks) == sorted(written[2][name])
        for f, m in masks.items():
            np.testing.assert_array_equal(m, written[2][name][f])
