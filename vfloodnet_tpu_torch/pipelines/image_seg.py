"""Still-image water segmentation with LinkNet + EfficientNet-B4
(counterpart of ``vfloodnet_tpu.pipelines.image_seg``).

Resize to 416 x 416, forward, resize the sigmoid map back to the image's
size, threshold at 0.5, and keep the largest connected component. Three
forms, as in the JAX package:

- :func:`device_pipeline`: one image wholly on the device (antialiased
  bilinear resize in, the component filter at 416 with its keep mask
  nearest-upsampled, on the CC kernel of ``csrc/cc.cu`` on the card);
- :func:`device_tail`: a batch already at 416 through the forward and the
  device tail, bit-packed labels out;
- :func:`host_tail`: the reference's tail on the host: bilinear
  (``cv2.INTER_LINEAR``'s, done by torch on the CPU, since the card's
  machine has no cv2) and scipy's connected components.

:func:`run_image_segmentation` reads files with PIL (resized to 416 there
with PIL's bilinear, as the reference's ``tf.Resize`` on a PIL image) and
writes indexed-PNG masks and their overlays, in a pool of ``workers``
writer threads if asked (none by default); it computes in float32 or, with
``dtype=torch.bfloat16``, on a bf16 copy of the model
(:func:`.loaders.cast_floating_params`), as the JAX runner casts its
variables.

Run as ``python -m vfloodnet_tpu_torch.pipelines.image_seg --test-path
IMAGES --test-name NAME`` (the flags of ``test_image_seg.py``).
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops
from ..core import resolve_device
from ..models import LinkNet
from .video_seg import (host_largest_cc, pack_bits, resolve_postprocess,
                        unpack_bits)

MODEL_DIMS = (416, 416)  # reference test_image_seg.py:79


@torch.no_grad()
def device_pipeline(model: LinkNet, img01: torch.Tensor,
                    postprocess: bool = True) -> torch.Tensor:
    """One image [H, W, 3] in [0, 1] on the model's device -> uint8 label
    [H, W] (the JAX package's ``_build_pipeline``)."""
    hw = tuple(img01.shape[:2])
    x = ops.resize(img01[None].float(), MODEL_DIMS, "bilinear",
                   antialias=True)
    prob = model(x)[0]                                  # [416, 416, 1]
    up = ops.resize(prob, hw, "bilinear", spatial_axes=(0, 1))[..., 0]
    label = (up > 0.5).to(torch.uint8)
    if postprocess:
        # the component filter at the model's resolution, its keep mask
        # upsampled: the reference's full-size cleanup at a fraction of
        # the cost
        keep = ops.largest_connected_component(
            (prob[..., 0] > 0.5).to(torch.uint8))
        label = label * ops.resize(keep, hw, "nearest",
                                   spatial_axes=(-2, -1))
    return label


@torch.no_grad()
def device_tail(model: LinkNet, batch01: torch.Tensor,
                out_hw: Tuple[int, int],
                postprocess: bool = True) -> torch.Tensor:
    """A batch [B, 416, 416, 3] in [0, 1] -> bit-packed labels [B, H,
    ceil(W / 8)] at ``out_hw`` (the JAX package's forward with its device
    tail); the component filter runs on the B maps at 416 at once."""
    probs = model(batch01)[..., 0]                      # [B, 416, 416]
    label = (ops.resize(probs, out_hw, "bilinear", spatial_axes=(-2, -1))
             > 0.5).to(torch.uint8)
    if postprocess:
        keep = ops.largest_connected_component((probs > 0.5).to(torch.uint8))
        label = label * ops.resize(keep, out_hw, "nearest",
                                   spatial_axes=(-2, -1))
    b, h, w = label.shape
    return pack_bits(label.reshape(b * h, w)).reshape(b, h, -1)


def host_tail(prob416: np.ndarray, orig_hw: Tuple[int, int],
              postprocess: bool = True) -> np.ndarray:
    """The reference's tail on the host: the 416 probability map resized
    to ``orig_hw`` with half-pixel bilinear and clamped edges (what
    ``cv2.resize(..., INTER_LINEAR)`` does), thresholded at 0.5, and the
    largest component kept (scipy)."""
    up = F.interpolate(torch.from_numpy(np.ascontiguousarray(
        prob416, np.float32))[None, None], size=tuple(orig_hw),
        mode="bilinear", align_corners=False)[0, 0].numpy()
    label = (up > 0.5).astype(np.uint8)
    return host_largest_cc(label) if postprocess else label


def read_image(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """An image file -> (uint8 RGB [H, W, 3], float32 [416, 416, 3] in
    [0, 1] resized by PIL's bilinear, the reference's input resize)."""
    from PIL import Image
    with Image.open(path) as img:
        rgb = img.convert("RGB")
        small = rgb.resize(MODEL_DIMS[::-1], Image.BILINEAR)
        return (np.asarray(rgb, np.uint8),
                np.asarray(small, np.float32) / 255.0)


def run_image_segmentation(test_path: str, test_name: str,
                           out_path: str = "./output/segs",
                           model_path: Optional[str] = None,
                           model: Optional[torch.nn.Module] = None,
                           batch_size: int = 4, postprocess: bool = True,
                           tail: str = "auto", device="cuda",
                           dtype: torch.dtype = torch.float32,
                           workers: int = 0) -> List[Tuple[str, str]]:
    """Segment one image file or a directory of images; masks go to
    ``<out_path>/<test_name>/mask/<name>.png`` and overlays to
    ``.../overlay/<name>.png``. ``tail``: 'device' (:func:`device_tail`,
    for a batch of one image size), 'host' (:func:`host_tail`) or 'auto'
    (the rule of :func:`.video_seg.resolve_postprocess`). ``model``
    (default: :func:`.loaders.load_linknet` of ``model_path`` computing in
    ``dtype``) runs on a copy with its conv kernels cast to its dtype when
    that is not float32. ``workers`` > 0 writes the files in a pool of
    that many threads (:mod:`.pools`). Returns (mask path, overlay path)
    a file, in order."""
    from ..utils import save_overlay, save_seg_mask
    from .loaders import cast_floating_params, load_linknet
    from .pools import make_pool

    device = resolve_device(device)
    if model is None:
        model = load_linknet(model_path, device=device, dtype=dtype)
    elif model.dtype != dtype:
        raise ValueError(f"the model computes in {model.dtype}, not {dtype}")
    if model.dtype != torch.float32:
        model = cast_floating_params(model, model.dtype)
    if tail == "auto":
        tail = resolve_postprocess("auto", device)
    if tail not in ("device", "host"):
        raise ValueError(f"unknown tail {tail!r}")
    mask_out = os.path.join(out_path, test_name, "mask")
    overlay_out = os.path.join(out_path, test_name, "overlay")
    os.makedirs(mask_out, exist_ok=True)
    os.makedirs(overlay_out, exist_ok=True)
    if os.path.isfile(test_path):
        paths = [test_path]
    else:
        paths = sorted(glob(os.path.join(test_path, "*.jpg"))
                       + glob(os.path.join(test_path, "*.png")))

    def write(path, img, label):
        base = os.path.splitext(os.path.basename(path))[0]
        mask_path = os.path.join(mask_out, base + ".png")
        overlay_path = os.path.join(overlay_out, base + ".png")
        save_seg_mask(label, mask_path)
        save_overlay(img, label, overlay_path)
        return mask_path, overlay_path

    writer = make_pool(workers)
    futures = []
    b = max(1, min(batch_size, len(paths)))
    try:
        for start in range(0, len(paths), b):
            chunk = paths[start:start + b]
            imgs, inputs = zip(*(read_image(p) for p in chunk))
            inputs = list(inputs) + [inputs[-1]] * (b - len(chunk))  # pad
            batch = torch.from_numpy(np.stack(inputs)).to(device)
            if tail == "device" and len({im.shape for im in imgs}) == 1:
                packed = device_tail(model, batch, imgs[0].shape[:2],
                                     postprocess).cpu().numpy()
                labels = unpack_bits(packed, imgs[0].shape[1])
            else:
                with torch.no_grad():
                    probs = model(batch)[..., 0].float().cpu().numpy()
                labels = [host_tail(probs[j], im.shape[:2], postprocess)
                          for j, im in enumerate(imgs)]
            futures += [writer.submit(write, path, imgs[j], labels[j])
                        for j, path in enumerate(chunk)]
        results = [f.result() for f in futures]
    finally:
        writer.shutdown()
    print(f"Segmented {len(paths)} image(s) -> {mask_out}")
    return results


def _args():
    parser = argparse.ArgumentParser(
        description="flowtide (PyTorch/CUDA): water image segmentation")
    parser.add_argument("--model-path", type=str, default=None,
                        help="Flat .npz checkpoint of the JAX package's "
                             "LinkNet (default: the bundled trained one).")
    parser.add_argument("--test-path", type=str, required=True,
                        help="Folder or individual jpg/png image")
    parser.add_argument("--test-name", type=str, required=True,
                        help="Test name")
    parser.add_argument("--out-path", type=str,
                        default=os.path.join("./", "output", "segs"),
                        help="Output folder")
    parser.add_argument("--batch-size", type=int, default=4,
                        help="Images per device batch")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' or 'cpu'.")
    parser.add_argument("--workers", type=int, default=0,
                        help="Writer threads (0: write on the main thread)")
    return parser.parse_args()


def main() -> None:
    args = _args()
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run_image_segmentation(args.test_path, args.test_name, args.out_path,
                           model_path=args.model_path,
                           batch_size=args.batch_size, device=args.device,
                           workers=args.workers)


if __name__ == "__main__":
    main()
