"""The port's sharded video engine and runner
(``pipelines/video_seg_sharded.py``) on worlds of 2 and 4 gloo ranks.

- A world of 2 against the JAX package's ``ShardedVideoSegEngine`` on a
  mesh of 2 of conftest's CPU devices, and a world of 4 against the
  port's single-device ``VideoSegEngine``, both with the trained
  ``best.npz``, on seeded 144 x 192 frames at the full size (108
  features a frame) and a bank of 128 slots an object: the bootstrap
  fills the first shards, the frames append into the last, and the water
  object's bank evicts. The bars of tests/test_sharded_engine.py: labels
  agree on > 0.99 of each frame; the valid counts, ``occ`` and
  ``replace_n`` equal.
- Every rank holds the same weights and returns the same labels.
- The runner writes the single runner's output tree over 2 frames.
"""

import os

import jax
import numpy as np
import pytest
import torch

from torch_parallel_ranks import (engine_frames, engine_rank, runner_rank,
                                  spawn)
from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu.parallel import make_mesh as j_make_mesh
from vfloodnet_tpu.pipelines.loaders import load_afb_urr as j_load_afb_urr
from vfloodnet_tpu.pipelines.video_seg_sharded import \
    ShardedVideoSegEngine as JShardedEngine
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.pipelines import VideoSegEngine, load_afb_urr
from vfloodnet_tpu_torch.pipelines.loaders import default_checkpoint
from vfloodnet_tpu_torch.utils import load_mask, save_seg_mask

torch.set_num_threads(4)
HW, BUDGET, FRAMES = (144, 192), 300, 5
WEIGHTS = default_checkpoint("video")


def _jax_run():
    model, variables = j_load_afb_urr(WEIGHTS)
    mesh = j_make_mesh((1, 2), devices=jax.devices()[:2])
    eng = JShardedEngine(model, variables,
                         JFeatureBank(obj_n=2, memory_budget=BUDGET), mesh,
                         downsample=HW[0], postprocess="none")
    frames, mask0 = engine_frames(FRAMES, HW)
    state = eng.bootstrap(frames[0], mask0)
    labels = []
    for i, f in enumerate(frames[1:]):
        state, label = eng.step(state, f, i + 1)
        labels.append(eng.fetch_label(label))
    bank = {k: np.asarray(getattr(state, k)) for k in (
        "valid", "occ", "peak_n", "replace_n")}
    return labels, bank


def _single_run():
    eng = VideoSegEngine(load_afb_urr(WEIGHTS, device="cpu"),
                         FeatureBank(obj_n=2, memory_budget=BUDGET,
                                     device="cpu"),
                         downsample=HW[0], postprocess="none")
    frames, mask0 = engine_frames(FRAMES, HW)
    state = eng.bootstrap(frames[0], mask0)
    labels = []
    for i, f in enumerate(frames[1:]):
        state, label = eng.step(state, f, i + 1)
        labels.append(eng.fetch_label(label))
    bank = {k: getattr(state, k).numpy() for k in (
        "valid", "occ", "peak_n", "replace_n")}
    return labels, bank


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine")
    args = (WEIGHTS, BUDGET, HW, FRAMES, HW[0])
    waits = {world: spawn(engine_rank, world, tmp, *args, wait=False)
             for world in (2, 4)}
    out = {"jax": _jax_run(), "single": _single_run()}
    return {**out, **{world: wait() for world, wait in waits.items()}}


def _whole(ranks):
    """Labels of rank 0 and the bank with its shards joined."""
    bank = dict(ranks[0][1])
    for k in ("valid", "usage", "birth"):
        bank[k] = np.concatenate([r[1][k] for r in ranks], axis=1)
    return ranks[0][0], bank


@pytest.mark.parametrize("world,ref", [(2, "jax"), (4, "single")])
def test_sharded_engine_labels(runs, world, ref):
    labels, _ = _whole(runs[world])
    for i, (got, want) in enumerate(zip(labels, runs[ref][0])):
        agreement = (got == want).mean()
        assert agreement > 0.99, (i, agreement)


@pytest.mark.parametrize("world,ref", [(2, "jax"), (4, "single")])
def test_sharded_engine_bank_telemetry(runs, world, ref):
    _, bank = _whole(runs[world])
    want = runs[ref][1]
    np.testing.assert_array_equal(bank["valid"].sum(axis=1),
                                  want["valid"].sum(axis=1))
    for k in ("occ", "replace_n"):
        np.testing.assert_array_equal(bank[k], want[k], err_msg=k)
    np.testing.assert_array_equal(bank["occ"], bank["valid"].sum(axis=1))
    assert (bank["peak_n"] >= bank["occ"]).all()
    assert bank["replace_n"].sum() > 0          # the bank evicted
    assert bank["usage"].sum() > 0.0
    # shards fill in rank order: the last shard took appends too
    assert bank["valid"][:, -bank["valid"].shape[1] // world:].any()


def test_every_rank_holds_the_same_state(runs):
    """The ranks loaded the same weights: their labels and replicated
    totals are equal."""
    for world in (2, 4):
        first = runs[world][0]
        for other in runs[world][1:]:
            for a, b in zip(first[0], other[0]):
                np.testing.assert_array_equal(a, b)
            for k in ("occ", "peak_n", "replace_n"):
                np.testing.assert_array_equal(first[1][k], other[1][k])


def test_sharded_runner_output_tree(tmp_path):
    """``run_video_segmentation_sharded`` over 3 frames on a world of 2
    writes the single runner's tree (masks and overlays of every frame);
    the masks are labels of the frame's size."""
    from PIL import Image
    rng = np.random.RandomState(1)
    frame_dir = tmp_path / "frames"
    frame_dir.mkdir()
    for i in range(3):
        arr = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(frame_dir / f"{i:02d}.jpg")
    mask0 = np.zeros((48, 64), np.uint8)
    mask0[24:, :] = 1
    mask_dir = tmp_path / "out" / "vid" / "mask"
    os.makedirs(mask_dir)
    save_seg_mask(mask0, str(mask_dir / "00.png"))
    res = spawn(runner_rank, 2, tmp_path / "spawn", str(frame_dir),
                str(tmp_path / "out"), WEIGHTS)
    assert [r["frames"] for r in res] == [2, 2]
    for i in range(3):
        mask = load_mask(str(mask_dir / f"{i:02d}.png"))
        assert mask.shape == (48, 64) and mask.max() <= 1
        assert os.path.exists(tmp_path / "out" / "vid" / "overlay"
                              / f"{i:02d}.png")
