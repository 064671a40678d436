"""The trainers' data parallelism (``train/data_parallel.py``, the steps'
``mesh=``): a world of 2 gloo ranks, each taking its half of the global
batch, against the port's single-process step on the whole batch, in
float64, from the bundled trained weights.

Bars: each step's loss within 1e-12 relative (and the image step's IoU);
every gradient leaf of the first step within 1e-9 of its scale, a leaf's
scale floored at 1e-6 of the largest (a leaf that feeds a live BN
vanishes to rounding noise, ~1e-16 of the largest leaf, which a floor of
1e-9 would hold to 1e-18); the running statistics after the steps within
1e-9 of each statistic's scale; every rank's weights and statistics
equal bit for bit. One step a case, and a second with the image
trainer's live BN (its statistics are the ones the ranks share in the
forward pass). Live BN: the video trainer's statistics are per clip, the
image trainer's the global batch's (the BNs all-reduce their sums in the
forward pass). The video clips are 32 px, 3 frames, 2
objects; the images 64 px (tests/torch_train_common.py,
tests/torch_image_train_common.py).
"""

import numpy as np
import pytest
import torch

from torch_image_train_common import image_batch
from torch_parallel_ranks import dp_rank, image_steps, spawn, video_steps
from torch_train_common import make_clips
from vfloodnet_tpu_torch.parallel import Mesh
from vfloodnet_tpu_torch.train.data_parallel import (check_training_mesh,
                                                     data_shard)

torch.set_num_threads(4)
CASES = [("video", False, 1), ("video", True, 1), ("image", False, 1),
         ("image", True, 2)]


def _inputs(kind):
    return make_clips() if kind == "video" else image_batch()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(kind, update_bn): (the single process's run, each rank's)}, the
    ranks' runs of every case in one spawn."""
    cases = [(kind, *_inputs(kind), update_bn, steps)
             for kind, update_bn, steps in CASES]
    wait = spawn(dp_rank, 2, tmp_path_factory.mktemp("dp"), cases,
                 wait=False)
    single = [(video_steps if kind == "video" else image_steps)(None, *args)
              for kind, *args in cases]
    ranks = wait()
    return {(kind, update_bn): (single[i], [r[i] for r in ranks])
            for i, (kind, update_bn, _) in enumerate(CASES)}


def _check(single, ranks):
    outs, grads, state, _ = single
    got_outs, got_grads, got_state, digest = ranks[0]
    for got, want in zip(got_outs, outs):
        for g, w in zip(got, want):
            assert np.isfinite(w)
            assert abs(g - w) <= 1e-12 * abs(w), (got, want)
    top = max(g.abs().max().item() for g in grads.values())
    for name, want in grads.items():
        scale = max(want.abs().max().item(), 1e-6 * top)
        err = (got_grads[name] - want).abs().max().item()
        assert err <= 1e-9 * scale, name
    for name, want in state.items():
        if name.endswith((".mean", ".var")):
            err = (got_state[name] - want).abs().max().item()
            assert err <= 1e-9 * want.abs().max().item(), name
    for other in ranks[1:]:
        assert other[0] == got_outs and other[3] == digest


@pytest.mark.parametrize("kind,update_bn", [c[:2] for c in CASES],
                         ids=[f"{k}-{'live' if u else 'frozen'}"
                              for k, u, _ in CASES])
def test_data_parallel_step_matches_whole_batch(runs, kind, update_bn):
    _check(*runs[kind, update_bn])


def test_live_statistics_moved(runs):
    """Live BN did update the running statistics; frozen BN left them."""
    for kind in ("video", "image"):
        frozen = runs[kind, False][0][2]
        live = runs[kind, True][0][2]
        assert any(not torch.equal(live[n], frozen[n]) for n in live
                   if n.endswith(".mean")), kind


def test_batch_split_and_model_axis():
    """The batch is split contiguously over the data axis and must
    divide; a model axis > 1 raises."""
    layout = np.arange(4).reshape(4, 1)
    meshes = [Mesh((4, 1), r, (r, 0), layout, (None, None),
                   torch.device("cpu")) for r in range(4)]
    x = torch.arange(8)
    assert torch.equal(torch.cat([data_shard(x, m) for m in meshes]), x)
    with pytest.raises(ValueError):
        data_shard(torch.arange(6), meshes[0])
    check_training_mesh(meshes[0])
    with pytest.raises(NotImplementedError):
        check_training_mesh(Mesh((2, 2), 0, (0, 0),
                                 np.arange(4).reshape(2, 2), (None, None),
                                 torch.device("cpu")))
