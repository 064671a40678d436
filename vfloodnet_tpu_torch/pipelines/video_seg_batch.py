"""Multi-stream video segmentation: B independent videos in one step
(counterpart of ``vfloodnet_tpu.pipelines.video_seg_batch``).

A video's frames must run in order (frame t reads the bank that frame t - 1
wrote), so a card serves more frames a second by batching across videos:
B same-resolution streams run as one step. The B frames are prepared,
encoded and decoded as one batch; the B banks are one
:class:`..memory.FeatureBankState` folded along the object axis ([B x
obj_n, N, d], stream-major), which one launch of each bank kernel reads
with every stream's own query (``AFBURR.segment_streams``) and one set of
update ops merges into (``FeatureBank.update_device``); the B labels are
upsampled, cleaned up by one launch set of the largest-CC kernel and
bit-packed together. One occupancy bound serves every stream and object,
as in the JAX engine. On the card the step is one CUDA graph replay, as in
:class:`.video_seg.VideoSegEngine`, whose machinery this engine shares.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional, Sequence

import numpy as np
import torch

from .. import ops
from ..core import resolve_device
from ..memory import FeatureBank, FeatureBankState
from ..models import AFBURR
from .pools import Prefetcher, make_pool
from .video_seg import VideoSegEngine, host_largest_cc, to_onehot


class BatchVideoSegEngine(VideoSegEngine):
    """B-stream propagation engine (fixed B, frame size and objects).

    ``step`` takes frames [B, H, W, 3] (uint8 or float in [0, 1]) and
    gives the labels of the B streams, [B, ...] on the device
    (:meth:`fetch_labels` -> [B, H, W] uint8). Everything else is as in
    :class:`.video_seg.VideoSegEngine`: the read-only step on frames whose
    index is not a multiple of ``memorize_every``, prep in the compute
    dtype, the first step of each graph key eager and a later one
    captured, no host sync in a replayed step, uploads through pinned
    staging into a static frame buffer.
    """

    def __init__(self, model: AFBURR, fb: FeatureBank, batch: int,
                 downsample: int = 480, postprocess="auto",
                 memorize_every: int = 1, cc_scale: int = 16,
                 cuda_graph: Optional[bool] = None):
        super().__init__(model, fb, downsample=downsample,
                         postprocess=postprocess,
                         memorize_every=memorize_every, cc_scale=cc_scale,
                         cuda_graph=cuda_graph)
        self.batch = int(batch)

    @torch.no_grad()
    def bootstrap(self, first_frames: Sequence[np.ndarray],
                  first_masks: Sequence[np.ndarray]) -> FeatureBankState:
        """Seed the B banks from each stream's first frame (HWC, uint8 or
        float in [0, 1]) and label mask, in float32 as the JAX engine's
        bootstrap."""
        if len(first_frames) != self.batch or len(first_masks) != self.batch:
            raise ValueError(f"bootstrap takes {self.batch} first frames "
                             f"and masks")
        frames = np.stack([np.asarray(f, np.float32) / 255.0
                           if np.asarray(f).dtype == np.uint8
                           else np.asarray(f, np.float32)
                           for f in first_frames])
        self.full_hw = frames.shape[1:3]
        small_hw = ops.short_side_size(*self.full_hw, self.downsample)
        frames_small = ops.resize(torch.from_numpy(frames).to(self.device),
                                  small_hw, "bicubic", spatial_axes=(1, 2))
        masks = np.stack([to_onehot(np.asarray(m), self.fb.obj_n)
                          for m in first_masks])
        masks_small = ops.resize(torch.from_numpy(masks).to(self.device),
                                 small_hw, "nearest_torch",
                                 spatial_axes=(-2, -1))
        k4, v4 = self.model.memorize_streams(frames_small, masks_small)
        return self.fb.init_bank(k4, v4)

    def _device_step(self, state, frames_u8, update_bank, occ_bound):
        """The B-stream step's device work: segment every stream against
        its bank (one read), record usage, and with ``update_bank``
        memorize the B frames as one batch and update every bank; then the
        labels [B, ...] and [B, h, w] as the single-stream step gives
        them."""
        if frames_u8.ndim != 4 or frames_u8.shape[0] != self.batch:
            raise ValueError(f"frames must be [{self.batch}, H, W, 3], got "
                             f"{tuple(frames_u8.shape)}")
        full_hw = tuple(frames_u8.shape[1:3])
        small_hw = ops.short_side_size(*full_hw, self.downsample)
        cd = self.model.dtype   # the prep runs in the compute dtype
        frames_small = ops.resize(frames_u8.to(cd) / 255.0, small_hw,
                                  "bicubic", spatial_axes=(1, 2))
        score, cnt = self.model.segment_streams(
            frames_small, state.keys, state.values, state.valid,
            bank_occ=state.occ)
        preds = torch.softmax(score, dim=1)            # [B, obj, h, w]
        self.fb.record_usage(state, cnt)
        if update_bank:
            k4, v4 = self.model.memorize_streams(frames_small, preds)
            self.fb.update_device(state, k4, v4, self._idx, occ_bound)
        return self._labels(preds, full_hw)


def run_video_segmentation_batch(test_paths: Sequence[str],
                                 test_names: Sequence[str], out_dir: str,
                                 model: Optional[AFBURR] = None,
                                 budget: int = 250_000,
                                 downsample: int = 480, viz: bool = True,
                                 image_model_path: Optional[str] = None,
                                 memorize_every: int = 1, cc_scale: int = 16,
                                 postprocess="auto", workers: int = 0,
                                 device="cuda") -> dict:
    """Segment several same-resolution videos at once, one stream each.

    Each video's output tree is the single-stream runner's
    (``<out_dir>/<name>/{mask,overlay}``); a missing first mask is made by
    the image model. A stream that runs out of frames is padded with its
    last frame, whose labels are not written. ``workers`` > 0 decodes
    ahead and writes in pools of that many threads; 0 (the default) starts
    none. Returns the aggregate frames a second over all streams and the
    frames written.
    """
    from ..utils import FrameSecondMeter, load_image, load_mask, \
        save_overlay, save_seg_mask
    from .image_seg import run_image_segmentation

    device = resolve_device(device)
    vids = []
    for path in test_paths:
        frames = sorted(glob(os.path.join(path, "*.jpg"))
                        + glob(os.path.join(path, "*.png")))
        if not frames:
            raise FileNotFoundError(f"no frames in {path}")
        vids.append(frames)
    mask_dirs, overlay_dirs, first_frames, first_masks = [], [], [], []
    for name, frames in zip(test_names, vids):
        mask_dir = os.path.join(out_dir, name, "mask")
        overlay_dir = os.path.join(out_dir, name, "overlay")
        os.makedirs(mask_dir, exist_ok=True)
        if viz:
            os.makedirs(overlay_dir, exist_ok=True)
        mask_dirs.append(mask_dir)
        overlay_dirs.append(overlay_dir)
        first_name = os.path.splitext(os.path.basename(frames[0]))[0]
        first_mask_path = os.path.join(mask_dir, first_name + ".png")
        if not os.path.exists(first_mask_path):
            run_image_segmentation(frames[0], name, out_dir,
                                   model_path=image_model_path,
                                   device=device)
        first_frames.append(load_image(frames[0]))
        first_masks.append(load_mask(first_mask_path))
        save_seg_mask(first_masks[-1], first_mask_path)
        if viz:
            save_overlay(first_frames[-1], first_masks[-1],
                         os.path.join(overlay_dir, first_name + ".png"))
    if model is None:
        from .loaders import load_afb_urr
        model = load_afb_urr(device=device)

    obj_n = max(int(m.max()) + 1 for m in first_masks)
    fb = FeatureBank(obj_n=obj_n, memory_budget=budget, device=device)
    engine = BatchVideoSegEngine(model, fb, batch=len(vids),
                                 downsample=downsample,
                                 postprocess=postprocess,
                                 memorize_every=memorize_every,
                                 cc_scale=cc_scale)
    state = engine.bootstrap(first_frames, first_masks)

    def load(t):
        """Every stream's frame t (its last one once it has run out) and
        its name (None for such padding)."""
        names, frames = [], []
        for paths in vids:
            idx = min(t, len(paths) - 1)
            frames.append(load_image(paths[idx]))
            names.append(os.path.splitext(os.path.basename(paths[idx]))[0]
                         if t < len(paths) else None)
        return names, frames

    def write(names, pending, frames):
        labels = pending.result()
        for vi, name in enumerate(names):
            if name is None:
                continue
            pred = labels[vi]
            if engine.postprocess == "host":
                pred = host_largest_cc(pred)
            save_seg_mask(pred, os.path.join(mask_dirs[vi], name + ".png"))
            if viz:
                save_overlay(frames[vi], pred,
                             os.path.join(overlay_dirs[vi], name + ".png"))

    max_len = max(len(v) for v in vids)
    decode_pool, writer_pool = make_pool(workers), make_pool(workers)
    batches = Prefetcher(decode_pool, load, range(max_len),
                         3 if workers > 0 else 0)
    fps = FrameSecondMeter()
    pending, writes = None, []
    try:
        for t in range(1, max_len):
            names, frames = batches.get(t)
            state, labels = engine.step(state, np.stack(frames), t)
            if pending is not None:
                writes.append(writer_pool.submit(write, *pending))
            pending = (names, engine.fetch_label_async(labels), frames)
            fps.add_frame_n(sum(n is not None for n in names))
        if pending is not None:
            write(*pending)
        for w in writes:
            w.result()
    finally:
        decode_pool.shutdown()
        writer_pool.shutdown()
    fps.end()
    print(f"batch throughput: {fps.fps:.3f} frames/s ({len(vids)} streams)")
    return {"fps": fps.fps, "frames": fps.frame_n}
