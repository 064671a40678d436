"""Video water segmentation with the feature bank sharded over ranks
(counterpart of ``vfloodnet_tpu.pipelines.video_seg_sharded``).

Each rank of the mesh's ``model`` axis holds a slice of every object's
bank slots (:func:`..parallel.shard_bank_state`), so the bank's capacity
grows with the number of GPUs. Every rank runs the step as
:class:`.video_seg.VideoSegEngine` does, on the same frame: it encodes the
frame, reads its shard with the read and count kernels and combines the
read with the others' (:func:`..parallel.sharded_bank_attention_read`),
decodes, records usage on its slots, memorizes, and updates its shard
(:func:`..parallel.sharded_bank_merge_append`); ``occ``, ``peak_n`` and
``replace_n`` are totals over the shards, the same on every rank. The
label's tail is the single engine's (bicubic up, the CC kernel with
``postprocess="device"``, bit packing for two objects).

The step runs eagerly: its collectives and the match's host bound (one
read of the shard's highest valid slot a step) keep it out of a CUDA
graph for now. The model holds the weights, on the rank's device; every
rank must load the same ones.
"""

from __future__ import annotations

import os
import time
from glob import glob
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..memory import FeatureBank, FeatureBankState
from ..models import AFBURR
from ..parallel import (MODEL_AXIS, Mesh, shard_bank_state,
                        sharded_bank_attention_read,
                        sharded_bank_merge_append)
from .pools import Prefetcher, make_pool
from .video_seg import VideoSegEngine, host_largest_cc


class ShardedVideoSegEngine(VideoSegEngine):
    """Per-frame propagation with the bank sharded over the mesh's
    ``model`` axis: :class:`.video_seg.VideoSegEngine`'s frame prep,
    bootstrap (whose whole bank is then cut into this rank's shard),
    labels and fetches, with an eager step of sharded reads and updates.
    The model must sit on the mesh's device."""

    def __init__(self, model: AFBURR, fb: FeatureBank, mesh: Mesh,
                 downsample: int = 480, postprocess="none",
                 cc_scale: int = 16):
        super().__init__(model, fb, downsample=downsample,
                         postprocess=postprocess, cc_scale=cc_scale,
                         cuda_graph=False)
        if self.device != mesh.device:
            raise ValueError(f"the model is on {self.device}, the mesh's "
                             f"rank on {mesh.device}")
        self.mesh = mesh

    @torch.no_grad()
    def bootstrap(self, first_frame: np.ndarray,
                  first_mask: np.ndarray) -> FeatureBankState:
        return shard_bank_state(self.mesh,
                                super().bootstrap(first_frame, first_mask))

    def _step(self, state, frame, frame_idx, want_small):
        """The single engine's step without its graphs or its host bound
        of the bank's occupancy, which a shard does not keep (the sharded
        update bounds each shard on the device)."""
        frame_u8 = self.upload(frame)
        self._idx.fill_(float(frame_idx))
        label, small = self._device_step(
            state, frame_u8, frame_idx % self.memorize_every == 0, None)
        return state, label, small

    def _segment(self, state, frame_small):
        """The read of every shard, combined over the model group."""
        k4, v4, skips, hw16, pad = self.model.encode_query(frame_small[None])
        mem, cnt = sharded_bank_attention_read(
            self.mesh, state.keys, state.values, state.valid,
            k4[0].float(), thres=self.model.thres_valid)
        return self.model.decode_with_memory(mem[None], v4, skips, hw16,
                                             pad), cnt

    def _update_bank(self, state, frame_small, pred, occ_bound):
        """The sharded merge and append; ``occ``, ``peak_n`` and
        ``replace_n`` made totals over the shards."""
        nk, nv = self.model.memorize(frame_small, pred)
        evicted = sharded_bank_merge_append(
            self.mesh, state.keys, state.values, state.valid, state.birth,
            state.usage, nk, nv, self._idx, update_rate=self.fb.update_rate,
            thres_close=self.fb.thres_close)
        occ = state.valid.sum(dim=1).to(torch.int32)
        dist.all_reduce(occ, dist.ReduceOp.SUM, group=self.mesh.model_group)
        state.occ.copy_(occ)
        state.replace_n.add_(evicted)
        torch.maximum(state.peak_n, state.occ, out=state.peak_n)


def run_video_segmentation_sharded(test_path: str, test_name: str,
                                   mesh: Mesh,
                                   out_dir: str = "./output/segs",
                                   model: Optional[AFBURR] = None,
                                   budget: int = 250_000,
                                   downsample: int = 480, viz: bool = True,
                                   postprocess="auto",
                                   first_mask_path: Optional[str] = None,
                                   workers: int = 0) -> dict:
    """:func:`.video_seg.run_video_segmentation` with the bank sharded over
    the mesh's ``model`` axis, on every rank of the world at once, on the
    mesh's device: the same output tree (``<out_dir>/<test_name>/mask``
    and, with ``viz``, ``overlay``), written by rank 0 alone. A missing
    first-frame mask is made by rank 0 with the bundled image model while
    the others wait. ``workers`` > 0 decodes ahead and writes in pools;
    none by default. ``model`` defaults to the bundled trained weights."""
    from ..utils import load_image, load_mask, save_overlay, save_seg_mask

    device = mesh.device
    writer = dist.get_rank() == 0
    img_list = sorted(glob(os.path.join(test_path, "*.jpg"))
                      + glob(os.path.join(test_path, "*.png")))
    if not img_list:
        raise FileNotFoundError(f"no frames in {test_path}")
    mask_dir = os.path.join(out_dir, test_name, "mask")
    overlay_dir = os.path.join(out_dir, test_name, "overlay")
    first_name = os.path.splitext(os.path.basename(img_list[0]))[0]
    if first_mask_path is None:
        first_mask_path = os.path.join(mask_dir, first_name + ".png")
    if writer:
        os.makedirs(mask_dir, exist_ok=True)
        if viz:
            os.makedirs(overlay_dir, exist_ok=True)
        if not os.path.exists(first_mask_path):
            from .image_seg import run_image_segmentation
            run_image_segmentation(img_list[0], test_name, out_dir,
                                   device=device)
    dist.barrier()
    if model is None:
        from .loaders import load_afb_urr
        model = load_afb_urr(device=device)

    first_mask = load_mask(first_mask_path)
    fb = FeatureBank(obj_n=int(first_mask.max()) + 1, memory_budget=budget,
                     device=device)
    engine = ShardedVideoSegEngine(model, fb, mesh, downsample=downsample,
                                   postprocess=postprocess)
    first_frame = load_image(img_list[0])
    state = engine.bootstrap(first_frame, first_mask)
    if writer:
        save_seg_mask(first_mask, os.path.join(mask_dir,
                                               first_name + ".png"))
        if viz:
            save_overlay(first_frame, first_mask,
                         os.path.join(overlay_dir, first_name + ".png"))

    def write(name, pending, frame):
        pred = pending.result()
        if engine.postprocess == "host":
            pred = host_largest_cc(pred)
        save_seg_mask(pred, os.path.join(mask_dir, name + ".png"))
        if viz:
            save_overlay(frame, pred, os.path.join(overlay_dir, name + ".png"))

    rest = img_list[1:]
    decode_pool, writer_pool = make_pool(workers), make_pool(workers)
    frames_ahead = Prefetcher(decode_pool, load_image, rest,
                              3 if workers > 0 else 0)
    t0 = time.perf_counter()
    pending, writes = None, []
    try:
        for idx in range(len(rest)):
            frame = frames_ahead.get(idx)
            state, label = engine.step(state, frame, idx + 1)
            if not writer:
                continue
            if pending is not None:
                writes.append(writer_pool.submit(write, *pending))
            pending = (os.path.splitext(os.path.basename(rest[idx]))[0],
                       engine.fetch_label_async(label), frame)
        if pending is not None:
            write(*pending)
        for w in writes:
            w.result()
    finally:
        decode_pool.shutdown()
        writer_pool.shutdown()
    seconds = time.perf_counter() - t0
    fps = len(rest) / seconds if seconds > 0 else float("nan")
    report = fb.report(state)
    if writer:
        print(report)
        print(f"sharded throughput: {fps:.3f} frames/s "
              f"({mesh.size(MODEL_AXIS)} shards)")
    return {"fps": fps, "frames": len(rest), "bank_report": report,
            "mask_dir": mask_dir}
