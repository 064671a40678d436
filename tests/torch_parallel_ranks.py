"""Rank functions of the port's multi-rank CPU tests, and the spawner
that runs them: ``spawn(fn, world, tmp, *args)`` starts ``world`` gloo
ranks (``torch.multiprocessing``, a ``FileStore`` in ``tmp``), runs
``fn(rank, world, *args)`` on each and returns their results, in rank
order. This module imports no JAX: every rank imports it, and the JAX
references are computed in the test process."""

import os

import numpy as np
import torch
import torch.multiprocessing as mp

from vfloodnet_tpu_torch.parallel import close_world, init_rank


def _entry(rank, fn, world, store, out, args):
    torch.set_num_threads(1)
    init_rank(store, rank, world, "cpu")
    try:
        torch.save(fn(rank, world, *args), f"{out}_{rank}.pt")
    finally:
        close_world()


def spawn(fn, world, tmp, *args, wait=True):
    """The ranks' results; with ``wait`` False, a function that waits for
    them (the caller works meanwhile)."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, f"store_{fn.__name__}_{world}")
    out = os.path.join(tmp, f"out_{fn.__name__}_{world}")
    ctx = mp.spawn(_entry, args=(fn, world, store, out, args), nprocs=world,
                   join=False)

    def results():
        while not ctx.join():
            pass
        got = []
        for r in range(world):   # loaded, then removed: they may be large
            got.append(torch.load(f"{out}_{r}.pt", weights_only=False))
            os.remove(f"{out}_{r}.pt")
        return got
    return results() if wait else results


def shard(x, rank, world, axis=1):
    """Rank ``rank``'s contiguous slice of ``x`` along ``axis``."""
    n = x.shape[axis] // world
    return np.take(x, np.arange(rank * n, (rank + 1) * n), axis=axis)


# -- mesh and read ------------------------------------------------------

def mesh_rank(rank, world):
    """Coordinates of this rank in every 2-D layout of the world, the sum
    of the ranks of its model group and of its data group, and whether a
    layout of the wrong size raises."""
    import torch.distributed as dist

    from vfloodnet_tpu_torch.parallel import make_mesh
    out = {}
    for shape in (None, (2, world // 2), (1, world)):
        mesh = make_mesh(shape)
        sums = []
        for g in (mesh.model_group, mesh.data_group):
            t = torch.tensor([rank])
            dist.all_reduce(t, group=g)
            sums.append(int(t))
        out[shape] = (mesh.shape, mesh.coords, sums)
    try:
        make_mesh((world + 1, 1))
        out["bad"] = False
    except ValueError:
        out["bad"] = True
    return out


def read_rank(rank, world, path):
    """This rank's sharded read of every case of ``path`` (keys [obj, N,
    dk], values, valid, q): float32, and on the bank rounded to bf16."""
    from vfloodnet_tpu_torch.parallel import (make_mesh,
                                              sharded_bank_attention_read)
    data = np.load(path)
    mesh = make_mesh((1, world))
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        keys, values = (torch.from_numpy(shard(data[k], rank, world)).to(dt)
                        for k in ("keys", "values"))
        valid = torch.from_numpy(shard(data["valid"], rank, world))
        mem, cnt = sharded_bank_attention_read(
            mesh, keys, values, valid, torch.from_numpy(data["q"]).to(dt))
        out[name] = (mem.float().numpy(), cnt.numpy())
    return out


# -- update -------------------------------------------------------------

def update_rank(rank, world, path):
    """This rank's sharded update of the bank of ``path`` (every object
    at once), then its shard and the evictions."""
    from vfloodnet_tpu_torch.parallel import (make_mesh,
                                              sharded_bank_merge_append)
    data = np.load(path)
    mesh = make_mesh((1, world))
    bank = {k: torch.from_numpy(shard(data[k], rank, world).copy())
            for k in ("keys", "values", "valid", "birth", "usage")}
    evicted = sharded_bank_merge_append(
        mesh, bank["keys"], bank["values"], bank["valid"], bank["birth"],
        bank["usage"], torch.from_numpy(data["new_keys"]),
        torch.from_numpy(data["new_values"]), float(data["frame_idx"]))
    return {k: v.numpy() for k, v in bank.items()}, evicted.numpy()


# -- engine and runner ----------------------------------------------------

def engine_frames(n=4, hw=(48, 64), seed=0):
    rng = np.random.RandomState(seed)
    frames = [rng.rand(*hw, 3).astype(np.float32) for _ in range(n)]
    mask0 = np.zeros(hw, np.uint8)
    mask0[hw[0] // 2:, :] = 1
    return frames, mask0


def engine_rank(rank, world, weights, budget, hw, n_frames, downsample):
    """The sharded engine over the model axis of the world on seeded
    frames: every frame's label and the final bank shard."""
    from vfloodnet_tpu_torch.memory import FeatureBank
    from vfloodnet_tpu_torch.parallel import make_mesh
    from vfloodnet_tpu_torch.pipelines import (ShardedVideoSegEngine,
                                               load_afb_urr)
    mesh = make_mesh((1, world))
    model = load_afb_urr(weights, device="cpu")
    fb = FeatureBank(obj_n=2, memory_budget=budget, device="cpu")
    eng = ShardedVideoSegEngine(model, fb, mesh, downsample=downsample,
                                postprocess="none")
    frames, mask0 = engine_frames(n_frames, hw)
    state = eng.bootstrap(frames[0], mask0)
    labels = []
    for i, f in enumerate(frames[1:]):
        state, label = eng.step(state, f, i + 1)
        labels.append(eng.fetch_label(label))
    bank = {k: getattr(state, k).numpy() for k in (
        "keys", "valid", "usage", "birth", "occ", "peak_n", "replace_n")}
    return labels, bank


def runner_rank(rank, world, frame_dir, out_dir, weights):
    """``run_video_segmentation_sharded`` on a frame directory."""
    from vfloodnet_tpu_torch.parallel import make_mesh
    from vfloodnet_tpu_torch.pipelines import (load_afb_urr,
                                               run_video_segmentation_sharded)
    mesh = make_mesh((1, world))
    model = load_afb_urr(weights, device="cpu")
    res = run_video_segmentation_sharded(
        frame_dir, "vid", mesh, out_dir=out_dir, model=model, budget=2048,
        downsample=48, viz=True, postprocess="none")
    return {"frames": res["frames"], "rank": rank}


# -- data-parallel training ------------------------------------------------

def video_form(dtype=torch.float64):
    """The AFB-URR training form with the bundled trained weights."""
    from vfloodnet_tpu_torch.core import (convert_afb_urr_variables,
                                          load_flat_npz)
    from vfloodnet_tpu_torch.models import AFBURR
    from vfloodnet_tpu_torch.pipelines.loaders import default_checkpoint
    model = AFBURR(trainable_bn=True, dtype=dtype)
    model.load_state_dict(convert_afb_urr_variables(
        load_flat_npz(default_checkpoint("video")), trainable_bn=True))
    return model.to(dtype)


def image_form(dtype=torch.float64):
    """The LinkNet training form with the bundled trained weights."""
    from vfloodnet_tpu_torch.core import load_flat_npz
    from vfloodnet_tpu_torch.core.convert import convert_linknet_variables
    from vfloodnet_tpu_torch.models import LinkNet, TrainBN
    from vfloodnet_tpu_torch.pipelines.loaders import default_checkpoint
    model = LinkNet(dtype=dtype, norm=TrainBN)
    model.load_state_dict(convert_linknet_variables(
        load_flat_npz(default_checkpoint("image")), trainable_bn=True))
    return model.to(dtype)


def _digest(state) -> str:
    """A hash of every tensor of a state dict, in order."""
    import hashlib
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode() + v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _run_steps(model, step, inputs, steps, full=True):
    """``steps`` calls of ``step(*inputs)``: each call's outputs, the
    gradients the first one applied and the state after the last (with
    ``full``; else None), and a hash of that state."""
    outs, grads = [], None
    for _ in range(steps):
        out = step(*inputs)
        outs.append(tuple(float(v) for v in (
            out if isinstance(out, tuple) else (out,))))
        if grads is None and full:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    state = model.state_dict()
    return outs, grads, state if full else None, _digest(state)


def video_steps(mesh, frames, masks, update_bn, steps=2, full=True):
    """float64 video steps (data-parallel with a mesh) on one global
    batch: see :func:`_run_steps`."""
    from vfloodnet_tpu_torch.train import train_video as tv
    model = video_form()
    cfg = tv.VideoTrainConfig(lr=1e-4, update_bn=update_bn)
    step = tv.make_video_train_step(model, tv.init_video_train_state(
        model, cfg), cfg, mesh=mesh)
    return _run_steps(model, step, [torch.from_numpy(x).double()
                                    for x in (frames, masks)], steps, full)


def image_steps(mesh, images, masks, update_bn, steps=2, full=True):
    """float64 LinkNet steps (data-parallel with a mesh), each giving its
    (loss, IoU): see :func:`_run_steps`."""
    from vfloodnet_tpu_torch.train import train_image as ti
    model = image_form()
    step = ti.make_image_train_step(
        model, ti.init_image_train_state(model, ti.ImageTrainConfig()),
        update_bn, mesh=mesh)
    return _run_steps(model, step, [torch.from_numpy(x).double()
                                    for x in (images, masks)], steps, full)


def dp_rank(rank, world, cases):
    """Each case ``(kind, inputs, targets, update_bn, steps)`` of
    ``cases`` through :func:`video_steps` or :func:`image_steps` on the
    world's data axis; rank 0 returns its gradients and state, every rank
    the hash of its state."""
    from vfloodnet_tpu_torch.parallel import make_mesh
    torch.set_num_threads(2)
    mesh = make_mesh()
    return [(video_steps if kind == "video" else image_steps)(
        mesh, *args, full=rank == 0) for kind, *args in cases]


class ArrayDataset:
    """A dataset of images and masks held in two arrays."""

    def __init__(self, images, masks):
        self.images, self.masks = images, masks

    def __len__(self):
        return len(self.images)

    def get(self, idx, epoch=0):
        return self.images[idx], self.masks[idx]


def image_loop(mesh, log_dir, train, val, epochs=2):
    """``run_image_training`` of the float64 LinkNet, live BN, batch 2,
    with a validation set (``train``, ``val``: (images, masks) arrays);
    the path it returned, a hash of the model's state after it, and the
    number of IoUs this process computed (the steps' and the validation
    batches')."""
    from vfloodnet_tpu_torch.train import (ImageTrainConfig,
                                           run_image_training, train_image)
    calls = []
    iou_metric = train_image.iou_metric

    def counted(*args, **kwargs):
        calls.append(1)
        return iou_metric(*args, **kwargs)

    model = image_form()
    cfg = ImageTrainConfig(epochs=epochs, batch_size=2, update_bn=True)
    train_image.iou_metric = counted
    try:
        best = run_image_training(model, cfg, ArrayDataset(*train),
                                  str(log_dir), mesh=mesh,
                                  val_dataset=ArrayDataset(*val))
    finally:
        train_image.iou_metric = iou_metric
    return best, _digest(model.state_dict()), len(calls)


def loop_rank(rank, world, log_dir, train, val):
    """:func:`image_loop` on the world's data axis, every rank naming the
    same log directory."""
    from vfloodnet_tpu_torch.parallel import make_mesh
    torch.set_num_threads(2)
    return image_loop(make_mesh(), log_dir, train, val)
