"""The image-training loop under data parallelism
(``run_image_training(..., mesh=)``): a world of 2 gloo ranks against the
port's single-process loop, in float64, from the bundled trained LinkNet
with live BN, at 64 px: 2 epochs of one step at batch 2, and a validation
set of 5 images (two full batches; the short last one is skipped, as the
JAX loop skips it). Every rank takes its half of each validation batch, as the
step takes its half of the training batch, so that no rank waits in a
collective while another validates.

Bars: each epoch's selected (validation) IoU and training loss within
1e-12 relative; ``best.npz``, which holds float32, equal entry for entry
up to that one rounding (the float64 runs differ by ~1e-12 relative, so
an entry may round to the neighbouring float32); rank 0 alone writes,
and every rank ends with the same weights and statistics, bit for bit.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from torch_image_train_common import image_batch
from torch_parallel_ranks import image_loop, loop_rank, spawn

torch.set_num_threads(4)
HW = 64
EPOCHS = 2


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["event"] == "epoch"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single process's and the ranks' runs: each one's epoch
    records, ``best.npz`` and the ranks' (path, state hash). The
    checkpoints, ~1 GB a run in float64, are removed once read."""
    train = image_batch(seed=1, b=2, hw=HW)
    val = image_batch(seed=2, b=5, hw=HW)
    root = tmp_path_factory.mktemp("dp_loop")
    dirs = {"single": root / "single", "ranks": root / "ranks"}
    wait = spawn(loop_rank, 2, root / "spawn", str(dirs["ranks"]), train,
                 val, wait=False)
    single_best, _, single_calls = image_loop(None, dirs["single"], train,
                                              val)
    ranks = wait()
    out = {"rank_ends": ranks, "single_calls": single_calls}
    for name, path in (("single", single_best), ("ranks", ranks[0][0])):
        with np.load(path) as z:
            best = dict(z)
        out[name] = (_records(dirs[name]), best,
                     sorted(os.listdir(dirs[name])))
        shutil.rmtree(dirs[name])
    return out


def test_selected_iou_and_best_weights_match_one_process(runs):
    want_recs, want_best, _ = runs["single"]
    got_recs, got_best, _ = runs["ranks"]
    assert len(want_recs) == len(got_recs) == EPOCHS
    for got, want in zip(got_recs, want_recs):
        assert 0.0 < want["select_iou"] <= 1.0
        assert want["select_iou"] != want["iou"]   # validation's, not train
        assert abs(got["select_iou"] - want["select_iou"]) <= \
            1e-12 * want["select_iou"]
        assert abs(got["dice"] - want["dice"]) <= 1e-12 * want["dice"]
    assert sorted(got_best) == sorted(want_best)
    for name, want in want_best.items():
        got = got_best[name]
        assert want.dtype == got.dtype == np.float32, name
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
        assert (np.abs(got - want) <= ulp).all(), name


def test_every_rank_validates_and_rank0_alone_writes(runs):
    """Each rank computed as many IoUs as the single process (one step
    and two validation batches an epoch), and the ranks end equal."""
    (path0, digest0, calls0), (path1, digest1, calls1) = runs["rank_ends"]
    assert calls0 == calls1 == runs["single_calls"] == EPOCHS * (1 + 2)
    assert path0 == path1 and digest0 == digest1
    _, _, want_files = runs["single"]
    _, _, got_files = runs["ranks"]
    assert got_files == want_files
