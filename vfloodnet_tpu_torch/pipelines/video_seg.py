"""Video water segmentation: memory-propagated per-frame inference
(counterpart of ``vfloodnet_tpu.pipelines.video_seg``).

Bootstrap the feature bank from a first-frame mask, then per frame:
normalise and bicubic-downsample, segment against the bank (the CUDA read
and count kernels on the card), record usage, memorize, update the bank,
bicubic-upsample the label to full size, clean it up to its largest
connected component, and bit-pack it. The runner is synchronous: one frame
at a time, no thread pools.

Run as ``python -m vfloodnet_tpu_torch.pipelines.video_seg --test-path
FRAMES --test-name NAME`` (the flags of ``test_video_seg.py``).
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops
from ..core import resolve_device
from ..memory import FeatureBank, FeatureBankState
from ..models import AFBURR
from .loaders import cast_floating_params


def to_onehot(mask: np.ndarray, obj_n: int) -> np.ndarray:
    """Label mask [H, W] -> one-hot [obj_n, H, W] with background =
    1 - sum(objects) (reference ToOnehot)."""
    oh = np.zeros((obj_n,) + mask.shape, np.float32)
    for i in range(1, obj_n):
        oh[i] = mask == i
    oh[0] = 1.0 - oh[1:].sum(axis=0).clip(0.0, 1.0)
    return oh


def pack_bits(label: torch.Tensor) -> torch.Tensor:
    """Binary [H, W] uint8 label -> [H, ceil(W/8)] uint8, row-major and
    most significant bit first, like ``np.packbits(..., axis=1)``."""
    h, w = label.shape
    wpad = -(-w // 8) * 8
    bits = F.pad(label.to(torch.int32), (0, wpad - w)).reshape(h, wpad // 8, 8)
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32,
                                device=label.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def unpack_bits(arr: np.ndarray, w: int) -> np.ndarray:
    """Host inverse of :func:`pack_bits` over the last axis."""
    return np.unpackbits(arr, axis=-1)[..., :w]


def _dilate(x: torch.Tensor) -> torch.Tensor:
    """One-cell 8-neighbour dilation of a binary [H, W] uint8 mask."""
    return F.max_pool2d(x[None, None].float(), 3, stride=1,
                        padding=1)[0, 0].to(x.dtype)


def device_largest_cc(label_full: torch.Tensor, label_small: torch.Tensor,
                      scale: int = 16, dilate: int = 1) -> torch.Tensor:
    """Largest-CC cleanup on the device. The component filter runs on a
    grid ``scale`` times coarser than the operating resolution (the JAX
    package's half-pixel nearest), the keep-mask is dilated by ``dilate``
    coarse cells and nearest-upsampled to full size, and the full-size
    label is masked with it. Falls back to the operating grid when it is
    too small for a ``scale`` grid."""
    h, w = label_small.shape[-2:]
    if scale > 1 and min(h, w) // scale >= 16:
        cc_in = ops.resize(label_small, (h // scale, w // scale), "nearest",
                           spatial_axes=(-2, -1))
    else:
        cc_in = label_small
    keep = ops.largest_connected_component(cc_in)
    for _ in range(max(0, int(dilate))):
        keep = _dilate(keep)
    keep_full = ops.resize(keep, tuple(label_full.shape), "nearest",
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
    """

    def __init__(self, model: AFBURR, fb: FeatureBank, downsample: int = 480,
                 postprocess="auto", cc_scale: int = 16):
        if model.dtype != torch.float32:
            model = cast_floating_params(model, model.dtype)
        self.model = model.eval()
        self.fb = fb
        self.device = next(model.parameters()).device
        self.downsample = downsample
        self.postprocess = resolve_postprocess(postprocess, self.device)
        if self.postprocess not in ("device", "host", "none"):
            raise ValueError(f"unknown postprocess {postprocess!r}")
        self.cc_scale = int(cc_scale)
        self.full_hw: Optional[Tuple[int, int]] = None

    def upload(self, frame) -> torch.Tensor:
        """A frame (uint8, or float in [0, 1]) as a uint8 tensor on the
        engine's device."""
        if torch.is_tensor(frame):
            return frame.to(self.device)
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = (frame * 255.0 + 0.5).astype(np.uint8)
        return torch.tensor(frame).to(self.device)

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

    @torch.no_grad()
    def step(self, state: FeatureBankState, frame,
             frame_idx: int) -> Tuple[FeatureBankState, torch.Tensor]:
        """Process one frame. Returns (state, full-size uint8 label on the
        device: bit-packed rows when there are two objects, see
        :meth:`fetch_label`)."""
        frame_u8 = self.upload(frame)
        full_hw = tuple(frame_u8.shape[:2])
        small_hw = ops.short_side_size(*full_hw, self.downsample)
        cd = self.model.dtype   # the prep runs in the compute dtype
        frame_small = ops.resize(frame_u8.to(cd) / 255.0, small_hw,
                                 "bicubic", spatial_axes=(0, 1))
        score, cnt = self.model.segment(frame_small[None], state.keys,
                                        state.values, state.valid,
                                        bank_occ=state.occ)
        pred = torch.softmax(score, dim=1)[0]             # [obj, h, w]
        state = self.fb.record_usage(state, cnt)
        k4, v4 = self.model.memorize(frame_small, pred)
        state = self.fb.update(state, k4, v4, float(frame_idx))

        if self.fb.obj_n == 2:
            # argmax of {bg, fg} is sign(fg - bg), and bicubic is linear
            diff = (pred[1] - pred[0]).to(cd)
            up = ops.resize(diff, full_hw, "bicubic", spatial_axes=(-2, -1))
            label_full = (up > 0).to(torch.uint8)
            label_small = (diff > 0).to(torch.uint8)
        else:
            up = ops.resize(pred, full_hw, "bicubic", spatial_axes=(-2, -1))
            label_full = torch.argmax(up, dim=0).to(torch.uint8)
            label_small = torch.argmax(pred, dim=0).to(torch.uint8)
        if self.postprocess == "device":
            label_full = device_largest_cc(label_full, label_small,
                                           scale=self.cc_scale)
        if self.fb.obj_n == 2:
            label_full = pack_bits(label_full)
        return state, label_full

    def fetch_label(self, label: torch.Tensor) -> np.ndarray:
        """Device label (possibly bit-packed) -> host uint8 [H, W]."""
        arr = label.cpu().numpy()
        if self.fb.obj_n == 2 and self.full_hw is not None:
            arr = unpack_bits(arr, self.full_hw[1])
        return arr


def run_video_segmentation(test_path: str, test_name: str,
                           out_dir: str = "./output/segs",
                           model: Optional[AFBURR] = None,
                           budget: int = 250_000, update_rate: float = 0.1,
                           merge_thres: float = 0.95, downsample: int = 480,
                           postprocess="auto",
                           first_mask_path: Optional[str] = None,
                           cc_scale: int = 16, device="cuda") -> dict:
    """Segment every frame of a directory; masks go to
    ``<out_dir>/<test_name>/mask`` as indexed PNGs.

    The first frame's mask must exist (``first_mask_path``, or
    ``<out_dir>/<test_name>/mask/<first frame>.png``): generating it needs
    the image-segmentation model, which this package does not have yet.
    """
    from ..utils import load_image, load_mask, save_seg_mask

    device = resolve_device(device)
    img_list = sorted(glob(os.path.join(test_path, "*.jpg"))
                      + glob(os.path.join(test_path, "*.png")))
    if not img_list:
        raise FileNotFoundError(f"no frames in {test_path}")
    mask_dir = os.path.join(out_dir, test_name, "mask")
    os.makedirs(mask_dir, exist_ok=True)
    first_name = os.path.splitext(os.path.basename(img_list[0]))[0]
    if first_mask_path is None:
        first_mask_path = os.path.join(mask_dir, first_name + ".png")
    if not os.path.exists(first_mask_path):
        raise FileNotFoundError(
            f"no first-frame mask at {first_mask_path}: the port cannot make "
            "one until the image-segmentation slice (LinkNet) is ported")
    if model is None:
        from .loaders import load_afb_urr
        model = load_afb_urr(device=device)

    first_mask = load_mask(first_mask_path)
    fb = FeatureBank(obj_n=int(first_mask.max()) + 1, memory_budget=budget,
                     update_rate=update_rate, thres_close=merge_thres,
                     device=device)
    engine = VideoSegEngine(model, fb, downsample=downsample,
                            postprocess=postprocess, cc_scale=cc_scale)
    state = engine.bootstrap(load_image(img_list[0]), first_mask)
    save_seg_mask(first_mask, os.path.join(mask_dir, first_name + ".png"))

    t0 = time.perf_counter()
    for idx, path in enumerate(img_list[1:]):
        state, label = engine.step(state, load_image(path), idx + 1)
        pred = engine.fetch_label(label)
        if engine.postprocess == "host":
            pred = host_largest_cc(pred)
        name = os.path.splitext(os.path.basename(path))[0]
        save_seg_mask(pred, os.path.join(mask_dir, name + ".png"))
    seconds = time.perf_counter() - t0
    frames = len(img_list) - 1
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
                        help="Accepted for compatibility; overlays are not "
                             "written yet.")
    parser.add_argument("--model-path", type=str, default=None,
                        help="Flat .npz checkpoint of the JAX package "
                             "(default: the bundled trained one).")
    parser.add_argument("--image-model-path", type=str, default=None,
                        help="Accepted for compatibility; the first-frame "
                             "mask must exist.")
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
                        help="Bank checkpoints are not ported yet; must be 0.")
    parser.add_argument("--memorize-every", type=int, default=1,
                        help="Only 1 (memorize every frame) is ported.")
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
    if args.checkpoint_every != 0 or args.memorize_every != 1:
        raise SystemExit("--checkpoint-every and --memorize-every other "
                         "than their defaults are not ported yet")
    device = f"cuda:{args.gpu}" if args.device == "cuda" else args.device
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from .loaders import load_afb_urr
    model = load_afb_urr(args.model_path, device=device)
    run_video_segmentation(
        args.test_path, args.test_name, model=model, budget=args.budget,
        update_rate=args.update_rate, merge_thres=args.merge_thres,
        downsample=args.downsample, postprocess=args.postprocess,
        first_mask_path=args.first_mask, cc_scale=args.cc_scale,
        device=device)


if __name__ == "__main__":
    main()
