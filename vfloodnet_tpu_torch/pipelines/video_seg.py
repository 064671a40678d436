"""Video water segmentation: memory-propagated per-frame inference
(counterpart of ``vfloodnet_tpu.pipelines.video_seg``).

Bootstrap the feature bank from a first-frame mask, then per frame:
normalise and bicubic-downsample, segment against the bank (the CUDA read
and count kernels on the card), record usage, memorize, update the bank,
bicubic-upsample the label to full size, clean it up to its largest
connected component (the CUDA kernel of ``csrc/cc.cu`` on the card), and
bit-pack it. On the card the step is one CUDA graph replay
(:class:`VideoSegEngine`). By default the runner starts no thread pool:
it enqueues frame t before it waits for frame t - 1's label; with
``workers`` it decodes ahead and writes in pools (:mod:`.pools`). With
``checkpoint_every`` it saves the bank every K frames, and a rerun resumes
after the last checkpoint (:mod:`..memory.checkpoint`).

Run as ``python -m vfloodnet_tpu_torch.pipelines.video_seg --test-path
FRAMES --test-name NAME`` (the flags of ``test_video_seg.py``).
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops
from ..core import resolve_device
from ..memory import (FeatureBank, FeatureBankState, load_bank_checkpoint,
                      save_bank_checkpoint)
from ..models import AFBURR
from ..ops import bank_read_cuda, cc_cuda
from .loaders import cast_floating_params
from .pools import Prefetcher, make_pool


def to_onehot(mask: np.ndarray, obj_n: int) -> np.ndarray:
    """Label mask [H, W] -> one-hot [obj_n, H, W] with background =
    1 - sum(objects) (reference ToOnehot)."""
    oh = np.zeros((obj_n,) + mask.shape, np.float32)
    for i in range(1, obj_n):
        oh[i] = mask == i
    oh[0] = 1.0 - oh[1:].sum(axis=0).clip(0.0, 1.0)
    return oh


def pack_bits(label: torch.Tensor) -> torch.Tensor:
    """Binary [..., H, W] uint8 label -> [..., H, ceil(W/8)] uint8,
    row-major and most significant bit first, like ``np.packbits(...,
    axis=-1)``."""
    w = label.shape[-1]
    wpad = -(-w // 8) * 8
    bits = F.pad(label.to(torch.int32), (0, wpad - w)).reshape(
        label.shape[:-1] + (wpad // 8, 8))
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32,
                                device=label.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def unpack_bits(arr: np.ndarray, w: int) -> np.ndarray:
    """Host inverse of :func:`pack_bits` over the last axis."""
    return np.unpackbits(arr, axis=-1)[..., :w]


def _dilate(x: torch.Tensor) -> torch.Tensor:
    """One-cell 8-neighbour dilation of each binary map of a uint8 mask
    [..., H, W]."""
    maps = x.reshape((-1,) + x.shape[-2:]).float()
    return F.max_pool2d(maps, 3, stride=1, padding=1).reshape(
        x.shape).to(x.dtype)


def device_largest_cc(label_full: torch.Tensor, label_small: torch.Tensor,
                      scale: int = 16, dilate: int = 1) -> torch.Tensor:
    """Largest-CC cleanup on the device. The component filter runs on a
    grid ``scale`` times coarser than the operating resolution (the JAX
    package's half-pixel nearest), the keep-mask is dilated by ``dilate``
    coarse cells and nearest-upsampled to full size, and the full-size
    label is masked with it. Falls back to the operating grid when it is
    too small for a ``scale`` grid. Labels may carry leading axes ([B, H,
    W], one map per stream): one launch set of the CC kernel serves them
    all."""
    h, w = label_small.shape[-2:]
    if scale > 1 and min(h, w) // scale >= 16:
        cc_in = ops.resize(label_small, (h // scale, w // scale), "nearest",
                           spatial_axes=(-2, -1))
    else:
        cc_in = label_small
    keep = ops.largest_connected_component(cc_in)
    for _ in range(max(0, int(dilate))):
        keep = _dilate(keep)
    keep_full = ops.resize(keep, tuple(label_full.shape[-2:]), "nearest",
                           spatial_axes=(-2, -1))
    return label_full * keep_full


def host_largest_cc(label: np.ndarray) -> np.ndarray:
    """Largest 8-connected component of a host label map (scipy)."""
    from scipy import ndimage
    lab, n = ndimage.label(label, structure=np.ones((3, 3), int))
    if n <= 1:
        return (lab > 0).astype(np.uint8)
    sizes = np.bincount(lab.ravel())
    sizes[0] = 0
    return (lab == sizes.argmax()).astype(np.uint8)


def resolve_postprocess(postprocess, device) -> str:
    """Normalise the largest-CC postprocess mode: True is 'device', False
    'none', and 'auto' picks 'device' when ``device`` is a CUDA device and
    the host has fewer than 4 CPUs to run the cleanup, else 'host' (the
    JAX package's rule, with CUDA for its accelerator)."""
    if postprocess is True:
        return "device"
    if postprocess is False:
        return "none"
    if postprocess == "auto":
        on_accel = torch.device(device).type == "cuda"
        few_cpus = (os.cpu_count() or 1) < 4
        return "device" if (on_accel and few_cpus) else "host"
    return postprocess


class PendingLabel:
    """A device label on its way to the host: the copy into pinned memory
    is enqueued when this is made, and :meth:`result` waits for it alone
    (the work enqueued after it keeps running)."""

    def __init__(self, label: torch.Tensor, full_w: Optional[int],
                 packed: bool):
        self.full_w, self.packed = full_w, packed
        self.event = None
        if label.is_cuda:
            self.host = torch.empty(label.shape, dtype=label.dtype,
                                    pin_memory=True)
            self.host.copy_(label, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = label

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        arr = self.host.numpy()
        if self.packed and self.full_w is not None:
            arr = unpack_bits(arr, self.full_w)
        return arr


class _CapturedStep:
    """One step captured in a CUDA graph: its output buffers (the
    full-size and the operating-size label), the kernel launches its
    capture recorded (each replay launches them again), and how often it
    was replayed."""

    def __init__(self, graph, label: torch.Tensor, label_small: torch.Tensor,
                 launches: Dict[str, int]):
        self.graph, self.launches = graph, launches
        self.label, self.label_small = label, label_small
        self.replays = 0


def _kernel_launches() -> Dict[str, int]:
    return {**bank_read_cuda.launches, **cc_cuda.launches}


class VideoSegEngine:
    """Per-frame propagation engine.

    A model that computes in bf16 (``AFBURR(dtype=torch.bfloat16)``) gets
    its weights cast once here (:func:`cast_floating_params`, on a copy);
    the frame is then prepared in bf16, and the first frame's bootstrap
    stays float32, as in the JAX engine.

    ``postprocess``: largest-CC cleanup — 'device' (on the label before it
    leaves the device), 'host' (the runner applies :func:`host_largest_cc`
    to the fetched label), 'none'; 'auto' as :func:`resolve_postprocess`
    decides.

    ``memorize_every``: frames whose index is a multiple of it run the
    full step; the others run the read-only step (segment and usage only:
    no memorize, merge or evict), as the JAX engine chooses per frame.

    ``cuda_graph`` (default: on for a CUDA model): the step is captured in
    a CUDA graph and replayed, the counterpart of the JAX engine's one
    jitted dispatch per frame. The step makes no host sync, so it can be
    captured: the bank's occupancy stays on the device, the host keeps an
    upper bound of it (:class:`..memory.OccupancyBound`), and the frame
    index lives in a static device scalar. One graph per (frame size,
    full or read-only step, the bank update's :meth:`FeatureBank.plan`),
    all in one memory pool; the first step of each runs eagerly (the
    warm-up: kernels load and libraries set up), a later one captures it.
    A replay overwrites the graph's outputs, so the labels are copied out
    each time. A failed capture raises; nothing falls back to eager.
    Graphs hold the bank tensors of one state: a new state (another
    bootstrap) drops them.
    """

    def __init__(self, model: AFBURR, fb: FeatureBank, downsample: int = 480,
                 postprocess="auto", memorize_every: int = 1,
                 cc_scale: int = 16, cuda_graph: Optional[bool] = None):
        if model.dtype != torch.float32:
            model = cast_floating_params(model, model.dtype)
        self.model = model.eval()
        self.fb = fb
        self.device = next(model.parameters()).device
        self.downsample = downsample
        self.postprocess = resolve_postprocess(postprocess, self.device)
        if self.postprocess not in ("device", "host", "none"):
            raise ValueError(f"unknown postprocess {postprocess!r}")
        self.memorize_every = max(1, int(memorize_every))
        self.cc_scale = int(cc_scale)
        on_cuda = self.device.type == "cuda"
        self.cuda_graph = on_cuda if cuda_graph is None else bool(cuda_graph)
        if self.cuda_graph and not on_cuda:
            raise ValueError("cuda_graph needs a model on a CUDA device")
        self.full_hw: Optional[Tuple[int, int]] = None
        self.graphs: Dict[tuple, _CapturedStep] = {}
        self._seen: set = set()
        self._graph_state: Optional[tuple] = None
        self._pool = None
        self._frame_bufs: Dict[tuple, torch.Tensor] = {}
        self._staging: Dict[tuple, list] = {}
        self._idx = torch.zeros((), dtype=torch.float32, device=self.device)

    def upload(self, frame) -> torch.Tensor:
        """A frame (uint8, or float in [0, 1]) as a uint8 tensor on the
        engine's device. From the host to a card it goes through a reused
        pinned staging buffer (two per frame size, an event each; the host
        waits on one only while the card still copies from it) and a
        non-blocking copy into the engine's static frame buffer of its
        size, which the captured graphs read: the returned tensor holds
        this frame until the next upload of that size."""
        if torch.is_tensor(frame):
            if frame.dtype != torch.uint8:
                frame = (frame * 255.0 + 0.5).to(torch.uint8)
            return frame.to(self.device)
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = (frame * 255.0 + 0.5).astype(np.uint8)
        if self.device.type != "cuda":
            return torch.tensor(frame)
        ring = self._staging.get(frame.shape)
        if ring is None:
            ring = self._staging[frame.shape] = [
                [(torch.empty(frame.shape, dtype=torch.uint8,
                              pin_memory=True), torch.cuda.Event())
                 for _ in range(2)], 0]
        bufs, i = ring
        buf, event = bufs[i]
        ring[1] = (i + 1) % len(bufs)
        if not event.query():
            event.synchronize()
        buf.numpy()[...] = frame
        out = self._frame_buffer(frame.shape)
        out.copy_(buf, non_blocking=True)
        event.record()
        return out

    def _frame_buffer(self, shape) -> torch.Tensor:
        buf = self._frame_bufs.get(tuple(shape))
        if buf is None:
            buf = self._frame_bufs[tuple(shape)] = torch.empty(
                tuple(shape), dtype=torch.uint8, device=self.device)
        return buf

    @torch.no_grad()
    def bootstrap(self, first_frame: np.ndarray,
                  first_mask: np.ndarray) -> FeatureBankState:
        """Seed the bank from frame 0 (frame [H, W, 3] uint8 or float in
        [0, 1], mask [H, W] uint8 labels)."""
        first_frame = np.asarray(first_frame)
        self.full_hw = first_frame.shape[:2]
        small_hw = ops.short_side_size(*self.full_hw, self.downsample)
        if first_frame.dtype == np.uint8:
            first_frame = first_frame.astype(np.float32) / 255.0
        frame = torch.from_numpy(np.asarray(first_frame, np.float32))
        frame_small = ops.resize(frame.to(self.device), small_hw, "bicubic",
                                 spatial_axes=(0, 1))
        mask_oh = torch.from_numpy(to_onehot(first_mask, self.fb.obj_n))
        mask_small = ops.resize(mask_oh.to(self.device), small_hw,
                                "nearest_torch", spatial_axes=(-2, -1))
        k4, v4 = self.model.memorize(frame_small, mask_small)
        return self.fb.init_bank(k4, v4)

    def _features(self, full_hw) -> int:
        """Features a frame of ``full_hw`` adds per object: its query
        pixels at 1/16 of the padded operating size."""
        h, w = ops.short_side_size(*full_hw, self.downsample)
        return -(-h // 16) * -(-w // 16)

    def _device_step(self, state: FeatureBankState, frame_u8: torch.Tensor,
                     update_bank: bool, occ_bound: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step's device work (what a graph captures): segment, record
        usage, and with ``update_bank`` memorize and update the bank; then
        the full-size label and the operating-size one (uint8 [h, w],
        before any cleanup). The frame index is read from ``self._idx``."""
        full_hw = tuple(frame_u8.shape[:2])
        small_hw = ops.short_side_size(*full_hw, self.downsample)
        cd = self.model.dtype   # the prep runs in the compute dtype
        frame_small = ops.resize(frame_u8.to(cd) / 255.0, small_hw,
                                 "bicubic", spatial_axes=(0, 1))
        score, cnt = self._segment(state, frame_small)
        pred = torch.softmax(score, dim=1)[0]             # [obj, h, w]
        self.fb.record_usage(state, cnt)
        if update_bank:
            self._update_bank(state, frame_small, pred, occ_bound)
        return self._labels(pred, full_hw)

    def _segment(self, state: FeatureBankState, frame_small: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The operating-size frame's object scores [1, obj, h, w] and the
        bank's usage counts [obj, N]: the bank read."""
        return self.model.segment(frame_small[None], state.keys,
                                  state.values, state.valid,
                                  bank_occ=state.occ)

    def _update_bank(self, state: FeatureBankState,
                     frame_small: torch.Tensor, pred: torch.Tensor,
                     occ_bound: int) -> None:
        """Memorize the frame under its probabilities ``pred`` and merge
        its keys into the bank, or append them."""
        k4, v4 = self.model.memorize(frame_small, pred)
        self.fb.update_device(state, k4, v4, self._idx, occ_bound)

    def _labels(self, pred: torch.Tensor, full_hw
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Object probabilities [..., obj, h, w] -> the full-size label
        (cleaned up and bit-packed as the engine is set) and the
        operating-size one, [..., H, W] and [..., h, w] uint8."""
        cd = self.model.dtype
        if self.fb.obj_n == 2:
            # argmax of {bg, fg} is sign(fg - bg), and bicubic is linear
            diff = (pred[..., 1, :, :] - pred[..., 0, :, :]).to(cd)
            up = ops.resize(diff, full_hw, "bicubic", spatial_axes=(-2, -1))
            label_full = (up > 0).to(torch.uint8)
            label_small = (diff > 0).to(torch.uint8)
        else:
            up = ops.resize(pred, full_hw, "bicubic", spatial_axes=(-2, -1))
            label_full = torch.argmax(up, dim=-3).to(torch.uint8)
            label_small = torch.argmax(pred, dim=-3).to(torch.uint8)
        if self.postprocess == "device":
            label_full = device_largest_cc(label_full, label_small,
                                           scale=self.cc_scale)
        if self.fb.obj_n == 2:
            label_full = pack_bits(label_full)
        return label_full, label_small

    @torch.no_grad()
    def step(self, state: FeatureBankState, frame,
             frame_idx: int) -> Tuple[FeatureBankState, torch.Tensor]:
        """Process one frame (numpy, or a tensor from :meth:`upload`).
        Returns (state, full-size uint8 label on the device: bit-packed
        rows when there are two objects, see :meth:`fetch_label`)."""
        state, label, _ = self._step(state, frame, frame_idx, False)
        return state, label

    @torch.no_grad()
    def step_with_small(self, state: FeatureBankState, frame, frame_idx: int
                        ) -> Tuple[FeatureBankState, torch.Tensor,
                                   torch.Tensor]:
        """:meth:`step`, and the frame's label at the operating size (uint8
        [h, w] on the device, water = 1), as the JAX engine's ``_step``
        gives it: what the water-level scan reads."""
        return self._step(state, frame, frame_idx, True)

    def _step(self, state, frame, frame_idx, want_small):
        frame_u8 = self.upload(frame)
        update_bank = frame_idx % self.memorize_every == 0
        m = self._features(frame_u8.shape[-3:-1])
        self._idx.fill_(float(frame_idx))
        bound = state.occ_host.bound
        if self.cuda_graph:
            plan = self.fb.plan(state, m) if update_bank else None
            label, small = self._replay(state, frame_u8, (update_bank, plan),
                                        bound, want_small)
        else:
            label, small = self._device_step(state, frame_u8, update_bank,
                                             bound)
        if update_bank:
            self.fb.note_update(state, m)
        return state, label, small

    def _replay(self, state, frame_u8, mode, bound, want_small):
        ptrs = tuple(t.data_ptr() for t in (
            state.keys, state.values, state.valid, state.birth, state.usage,
            state.occ, state.peak_n, state.replace_n))
        if ptrs != self._graph_state:
            self.graphs.clear()
            self._seen.clear()
            self._graph_state = ptrs
        key = (tuple(frame_u8.shape),) + mode
        captured = self.graphs.get(key)
        if captured is None and key not in self._seen:
            self._seen.add(key)            # the first step of a key: eager
            return self._device_step(state, frame_u8, mode[0], bound)
        buf = self._frame_buffer(frame_u8.shape)
        if buf.data_ptr() != frame_u8.data_ptr():
            buf.copy_(frame_u8)
        if captured is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            before = _kernel_launches()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool):
                label, small = self._device_step(state, buf, mode[0], bound)
            after = _kernel_launches()
            captured = self.graphs[key] = _CapturedStep(
                graph, label, small, {k: after[k] - before[k] for k in after
                                      if after[k] != before[k]})
        captured.graph.replay()
        captured.replays += 1
        return (captured.label.clone(),
                captured.label_small.clone() if want_small else None)

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches made by graph replays so far: each graph's
        captured launches times its replays."""
        out: Dict[str, int] = {}
        for captured in self.graphs.values():
            for k, v in captured.launches.items():
                out[k] = out.get(k, 0) + v * captured.replays
        return out

    @torch.no_grad()
    def step_n(self, state: FeatureBankState, frames,
               start_idx: int) -> Tuple[FeatureBankState, torch.Tensor]:
        """K consecutive frames (a [K, H, W, 3] array or tensor, or a list
        of frames), frame i with index ``start_idx + i``: K steps (graph
        replays on the card), labels stacked [K, ...]. The bank is updated
        on every frame, so only at ``memorize_every == 1``, as in the JAX
        engine."""
        if self.memorize_every != 1:
            raise ValueError("step_n requires memorize_every == 1")
        labels = []
        for i in range(len(frames)):
            state, label = self.step(state, frames[i], start_idx + i)
            labels.append(label)
        return state, torch.stack(labels)

    def fetch_label(self, label: torch.Tensor) -> np.ndarray:
        """Device label (possibly bit-packed) -> host uint8 [H, W]."""
        return self.fetch_label_async(label).result()

    def fetch_label_async(self, label: torch.Tensor) -> PendingLabel:
        """Start copying a device label to the host; ``.result()`` gives
        what :meth:`fetch_label` gives."""
        return PendingLabel(label, None if self.full_hw is None
                            else self.full_hw[1], self.fb.obj_n == 2)

    def fetch_labels(self, labels: torch.Tensor) -> np.ndarray:
        """Stacked :meth:`step_n` labels [K, ...] -> host uint8 [K, H,
        W]."""
        return self.fetch_label(labels)


def run_video_segmentation(test_path: str, test_name: str,
                           out_dir: str = "./output/segs",
                           model: Optional[AFBURR] = None,
                           budget: int = 250_000, update_rate: float = 0.1,
                           merge_thres: float = 0.95, downsample: int = 480,
                           viz: bool = True, postprocess="auto",
                           image_model_path: Optional[str] = None,
                           first_mask_path: Optional[str] = None,
                           checkpoint_every: int = 0,
                           memorize_every: int = 1, cc_scale: int = 16,
                           workers: int = 0, device="cuda") -> dict:
    """Segment every frame of a directory; masks go to
    ``<out_dir>/<test_name>/mask`` as indexed PNGs and, with ``viz``,
    overlays of them on the frames to ``<out_dir>/<test_name>/overlay``
    (:func:`..utils.save_overlay`), as the JAX runner writes them.

    A missing first-frame mask (``first_mask_path``, or
    ``<out_dir>/<test_name>/mask/<first frame>.png``) is made by the image
    model (:func:`.image_seg.run_image_segmentation`, weights from
    ``image_model_path`` or the bundled checkpoint), as the JAX runner
    does.

    ``checkpoint_every`` > 0: the bank is saved every K frames under
    ``<out_dir>/<test_name>/bank_ckpt`` (a host sync each time), and a run
    that finds a checkpoint there resumes after its frame, skipping the
    frames before it, as the JAX runner does; an unusable checkpoint is
    reported and the run starts afresh.

    ``workers`` = 0 (the default) starts no thread pool: the loop enqueues
    frame t before it fetches frame t - 1's label, whose copy to the host
    was started when it was made. ``workers`` > 0 decodes up to three
    frames ahead and writes masks and overlays in pools of that many
    threads (the JAX runner's pools); the masks are the same.
    """
    from ..utils import load_image, load_mask, save_overlay, save_seg_mask

    device = resolve_device(device)
    img_list = sorted(glob(os.path.join(test_path, "*.jpg"))
                      + glob(os.path.join(test_path, "*.png")))
    if not img_list:
        raise FileNotFoundError(f"no frames in {test_path}")
    mask_dir = os.path.join(out_dir, test_name, "mask")
    overlay_dir = os.path.join(out_dir, test_name, "overlay")
    os.makedirs(mask_dir, exist_ok=True)
    if viz:
        os.makedirs(overlay_dir, exist_ok=True)
    first_name = os.path.splitext(os.path.basename(img_list[0]))[0]
    if first_mask_path is None:
        first_mask_path = os.path.join(mask_dir, first_name + ".png")
    if not os.path.exists(first_mask_path):
        # reference test_video_seg.py:67-69
        from .image_seg import run_image_segmentation
        run_image_segmentation(img_list[0], test_name, out_dir,
                               model_path=image_model_path, device=device)
    if model is None:
        from .loaders import load_afb_urr
        model = load_afb_urr(device=device)

    first_mask = load_mask(first_mask_path)
    fb = FeatureBank(obj_n=int(first_mask.max()) + 1, memory_budget=budget,
                     update_rate=update_rate, thres_close=merge_thres,
                     device=device)
    engine = VideoSegEngine(model, fb, downsample=downsample,
                            postprocess=postprocess,
                            memorize_every=memorize_every, cc_scale=cc_scale)
    first_frame = load_image(img_list[0])
    state = engine.bootstrap(first_frame, first_mask)
    ckpt_dir = os.path.join(out_dir, test_name, "bank_ckpt")
    start_idx = 0
    if checkpoint_every > 0:
        try:
            resumed = load_bank_checkpoint(ckpt_dir, fb)
        except Exception as e:   # as the JAX runner: start afresh
            print(f"bank checkpoint unusable ({e}); starting fresh")
            resumed = None
        if resumed is not None:
            state, start_idx = resumed
            print(f"resumed bank checkpoint at frame {start_idx}")
    save_seg_mask(first_mask, os.path.join(mask_dir, first_name + ".png"))
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
        for idx in range(start_idx, len(rest)):
            frame = frames_ahead.get(idx)
            state, label = engine.step(state, frame, idx + 1)
            if checkpoint_every > 0 and (idx + 1) % checkpoint_every == 0:
                save_bank_checkpoint(ckpt_dir, state, idx + 1)
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
    frames = len(rest) - start_idx
    report = fb.report(state)
    fps = frames / seconds if seconds > 0 else float("nan")
    print(report)
    print(f"throughput: {fps:.3f} frames/s")
    return {"fps": fps, "frames": frames, "bank_report": report,
            "mask_dir": mask_dir}


def _args():
    parser = argparse.ArgumentParser(
        description="flowtide (PyTorch/CUDA): water video segmentation")
    parser.add_argument("--gpu", type=int, default=0,
                        help="CUDA device index.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the card --gpu names) or 'cpu'.")
    parser.add_argument("--budget", type=int, default=250000,
                        help="Max number of features in the feature bank.")
    parser.add_argument("--viz", action="store_true", default=True,
                        help="Write overlays of the masks on the frames.")
    parser.add_argument("--model-path", type=str, default=None,
                        help="Flat .npz checkpoint of the JAX package "
                             "(default: the bundled trained one).")
    parser.add_argument("--image-model-path", type=str, default=None,
                        help="Image model (flat .npz of the JAX package) "
                             "that makes a missing first-frame mask "
                             "(default: the bundled trained one).")
    parser.add_argument("--update-rate", type=float, default=0.1,
                        help="Impact of merging new features.")
    parser.add_argument("--merge-thres", type=float, default=0.95,
                        help="Merge if similarity is higher, else append.")
    parser.add_argument("--downsample", type=int, default=480,
                        help="Short-side operating resolution.")
    parser.add_argument("--postprocess", type=str, default="auto",
                        choices=["auto", "host", "device", "none"],
                        help="Largest-CC cleanup (auto = device on a CUDA "
                             "device when the host has fewer than 4 CPUs, "
                             "else host).")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="Checkpoint the bank every K frames under "
                             "<out>/<name>/bank_ckpt and resume from it "
                             "(0 = off).")
    parser.add_argument("--workers", type=int, default=0,
                        help="Threads to decode frames ahead and to write "
                             "masks (0 = none, the frames in turn).")
    parser.add_argument("--memorize-every", type=int, default=1,
                        help="Memorize / update the bank every K frames "
                             "(1 = every frame, the reference).")
    parser.add_argument("--cc-scale", type=int, default=16,
                        help="Device largest-CC grid is 1/K of the "
                             "operating resolution.")
    parser.add_argument("--first-mask", type=str, default=None,
                        help="First-frame mask (default: "
                             "<out>/<name>/mask/<first frame>.png).")
    parser.add_argument("--test-path", type=str, required=True,
                        help="Video frames directory")
    parser.add_argument("--test-name", type=str, required=True,
                        help="Video name")
    return parser.parse_args()


def main() -> None:
    args = _args()
    device = f"cuda:{args.gpu}" if args.device == "cuda" else args.device
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from .loaders import load_afb_urr
    model = load_afb_urr(args.model_path, device=device)
    run_video_segmentation(
        args.test_path, args.test_name, model=model, budget=args.budget,
        update_rate=args.update_rate, merge_thres=args.merge_thres,
        downsample=args.downsample, viz=args.viz,
        postprocess=args.postprocess, image_model_path=args.image_model_path,
        first_mask_path=args.first_mask,
        checkpoint_every=args.checkpoint_every,
        memorize_every=args.memorize_every, cc_scale=args.cc_scale,
        workers=args.workers, device=device)


if __name__ == "__main__":
    main()
