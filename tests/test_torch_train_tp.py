"""The video trainer's model axis (``train_video.param_sharding_rules``,
``shard_train_state``, ``train/model_parallel.py``): gloo CPU ranks in
float64, from the bundled trained weights, on the 32-px clips of
tests/torch_train_common.py with live BN, against the port's plain steps
on the whole batch. At mesh (1, 2) two steps of one clip, with model
rank 1's replicated work perturbed in its last bits (its first BN's
output scaled by 1 + 2**-45, as a card's non-deterministic kernels may
make it); at mesh (2, 2) one epoch of ``run_video_training``, one step
of two clips, a clip a data rank.

Bars: each loss within 1e-12 relative; every tensor of the state after
the last step (weights and running statistics, gathered whole) within
1e-9 of its scale (its largest magnitude); every rank's replicated
tensors equal bit for bit after the last step, the perturbed rank's too
(the replicated gradients and statistics are averaged over the model
group), and the slices of the ranks that share a model index too; the
sharded parameters, named in the JAX layout, exactly the leaves that
JAX's ``param_sharding_rules`` picks at m = 2 (on ``jax.eval_shape`` of
its variables, no compile). The (2, 2) loop's checkpoint holds full
tensors, its weights and AdamW moments within the same bars of the plain
step's; resumed without a mesh, one more step ends within them of the
plain run's second step. The image step at (1, 2) (replicated over the
model axis, live BN) equals the plain one within the DP test's bars.
The state made by one card at mesh (1, 1) is held bit for bit by
``chip_smoke.py``; m > 1 runs only here, on CPU ranks.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from torch_image_train_common import image_batch
from torch_parallel_ranks import (image_steps, one_thread, spawn,
                                  tp_loop_rank, tp_pair_rank, tp_video_step,
                                  video_form)
from torch_train_common import make_clips
from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu.parallel import MODEL_AXIS as JMODEL_AXIS
from vfloodnet_tpu.parallel import make_mesh as jmake_mesh
from vfloodnet_tpu.train import train_video as jtv
from vfloodnet_tpu_torch.core.checkpoint import flatten
from vfloodnet_tpu_torch.core.convert import export_afb_urr_variables
from vfloodnet_tpu_torch.parallel import Mesh
from vfloodnet_tpu_torch.train import train_video as tv
from vfloodnet_tpu_torch.train.loops import _resume

SHAPES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The plain runs, both meshes' ranks' runs (spawned at once), the
    (2, 2) loop's loss and checkpoint, and that checkpoint resumed
    without a mesh for one more step (its directory is then removed: a
    float64 checkpoint of the trainer is ~0.8 GB)."""
    tmp = tmp_path_factory.mktemp("tp")
    frames, masks = make_clips()
    images, image_masks = image_batch()
    waits = {(1, 2): spawn(tp_pair_rank, 2, tmp, frames[:1], masks[:1],
                           images, image_masks, wait=False),
             (2, 2): spawn(tp_loop_rank, 4, tmp, frames, masks,
                           tmp / "loop", wait=False)}
    plain = {"video": tp_video_step(None, frames, masks, steps=2,
                                    keep=(0, 1)),
             "clip0": tp_video_step(None, frames[:1], masks[:1], steps=2,
                                    keep=(1,)),
             "image": image_steps(None, images, image_masks, True, steps=1)}
    ranks = {shape: wait() for shape, wait in waits.items()}
    with open(tmp / "loop" / "metrics.jsonl") as f:
        loss = [json.loads(line)["loss"] for line in f
                if json.loads(line)["event"] == "epoch"]
    saved = torch.load(tmp / "loop" / "final.pt", weights_only=True)
    model = video_form()
    cfg = tv.VideoTrainConfig(lr=1e-4, update_bn=True, epochs=1)
    opt = tv.init_video_train_state(model, cfg, 1)
    assert _resume(str(tmp / "loop" / "final.pt"), model, opt, 1) == 1
    _close(model.state_dict(), saved["model"], "loaded")
    step = tv.make_video_train_step(model, opt, cfg)
    step(*(torch.from_numpy(x).double() for x in (frames, masks)))
    resumed = {n: t.clone() for n, t in model.state_dict().items()}
    shutil.rmtree(tmp / "loop")
    return plain, ranks, (loss, saved, resumed)


def _close(got, want, what):
    for name, w in want.items():
        if not torch.is_floating_point(w):
            assert torch.equal(got[name], w), (what, name)
            continue
        scale = max(w.abs().max().item(), 1e-300)
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-9 * scale, (what, name, err, scale)


def _same_loss(got, want):
    assert np.isfinite(want) and abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_model_axis_step_matches_whole_batch(runs, shape):
    """The losses and the state after the last step match the plain
    run's; the replicated tensors are equal on every rank (at (1, 2)
    after two steps of which model rank 1's were perturbed), the slices
    on ranks that share a model index (the ranks' order is row-major
    over (data, model))."""
    plain, ranks, (loop_loss, saved, _) = runs
    got = ranks[shape]
    if shape == (1, 2):
        losses, states = plain["clip0"][:2]
        for r in got:
            for g, w in zip(r["video"][0], losses):
                _same_loss(g, w)
        (state, _), = got[0]["video"][1][1:]
        _close(state, states[1][0], "state")
        got = [r["video"][3:] for r in got]
    else:
        losses, states = plain["video"][:2]
        assert len(loop_loss) == 1
        _same_loss(loop_loss[0], losses[0])
        _close(saved["model"], states[0][0], "state")
        got = [r[1:] for r in got]
    assert len({r[0] for r in got}) == 1
    m = shape[1]
    for j in range(m):
        assert len({r[1] for r in got[j::m]}) == 1
    assert len({r[1] for r in got[:m]}) == m


def test_sharded_leaves_are_jax_rule(runs):
    """The port's sharded parameters, exported to JAX's names, are the
    leaves JAX's rule shards at m = 2 (its key-value and memory stem
    kernels are separate leaves there)."""
    _, ranks, _ = runs
    model = JAFBURR(read_chunk=64)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((32, 32, 3)),
                           jnp.zeros((2, 32, 32)), method=model.init_all))
    rule = jtv.param_sharding_rules(jmake_mesh((4, 2)))
    want = {"params/" + k for k, v in flatten(
        jax.tree.map(lambda x: JMODEL_AXIS in tuple(rule(x).spec),
                     shapes["params"])).items() if v}
    state = runs[0]["video"][1][0][0]
    for names in (ranks[1, 2][0]["video"][2], ranks[2, 2][0][0]):
        got = set(export_afb_urr_variables({n: state[n] for n in names}))
        assert got == want, sorted(got ^ want)[:5]


def test_checkpoint_resumes_on_another_mesh(runs):
    """The (2, 2) loop's ``final.pt`` holds the plain step's weights and
    AdamW moments, whole; resumed without a mesh (``loops._resume``), one
    more step ends where the plain run's second step does."""
    plain, _, (_, saved, resumed) = runs
    states = plain["video"][1]
    assert saved["step"] == 1 and saved["epoch"] == 0
    _close(saved["model"], states[0][0], "model")
    for k in ("mu", "nu"):
        assert set(saved["optimizer"][k]) == set(states[0][1][k])
        _close(saved["optimizer"][k], states[0][1][k], k)
    _close(resumed, states[1][0], "resumed")


def test_image_step_with_model_axis_matches_plain(runs):
    plain, ranks, _ = runs
    outs, grads, state, _ = plain["image"]
    got_outs, got_grads, got_state, digest = ranks[1, 2][0]["image"]
    for g, w in zip(got_outs[0], outs[0]):
        assert abs(g - w) <= 1e-12 * abs(w)
    top = max(g.abs().max().item() for g in grads.values())
    for name, want in grads.items():
        scale = max(want.abs().max().item(), 1e-6 * top)
        assert (got_grads[name] - want).abs().max().item() <= 1e-9 * scale
    _close({n: got_state[n] for n in state}, state, "image state")
    assert ranks[1, 2][1]["image"][3] == digest


def test_model_axis_needs_the_sharded_layout():
    """A step over a model axis > 1 without ``shard_train_state`` raises
    (it does not drop to the plain step), and so does a model axis that
    would shard one of the fused key and value kernels alone."""
    def mesh(shape):
        return Mesh(shape, 0, (0, 0), np.arange(shape[0] * shape[1])
                    .reshape(shape), (None, None), torch.device("cpu"))
    cfg = tv.VideoTrainConfig()
    opt = tv.AdamWClip({}, lambda count: 0.0, 0.0)
    with pytest.raises(ValueError):
        tv.make_video_train_step(nn.Module(), opt, cfg, mesh=mesh((2, 2)))
    tv.make_video_train_step(nn.Module(), opt, cfg, mesh=mesh((2, 1)))
    rule = tv.param_sharding_rules(mesh((1, 256)))
    assert not rule("x.weight", torch.zeros(64, 3, 1, 1))
    with pytest.raises(ValueError):
        rule("keyval_r4.conv.weight", torch.zeros(640, 1, 1, 1))
