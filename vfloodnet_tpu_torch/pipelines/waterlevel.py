"""Water-level estimation CLI (counterpart of ``est_waterlevel.py``):

    python -m vfloodnet_tpu_torch.pipelines.waterlevel --test-path FRAMES \\
        --test-name NAME --opt {ref,stopsign,people} [--streaming] \\
        [--device cpu]

``--opt ref`` reads the segmentation stage's masks
(``<seg-dir>/<name>/mask``) and tracks a reference object
(:func:`.reference_tracking.est_by_reference`); with ``--streaming`` it
segments the frames itself and scans each frame's mask on the device
(:func:`.streaming_waterlevel.run_streaming_waterlevel`), with the video
model of ``--model-path`` (a flat ``.npz`` of the JAX package; default:
the bundled checkpoint). ``--opt stopsign`` and ``--opt people`` read the
same masks, detect stop signs or people
(:func:`.object_detection.est_by_obj_detection`, the detector of
``--det-model-path``: a flat ``.npz`` of the JAX package with its
``rcnn_config.json`` sidecar; default: the bundled tiny checkpoint; people
also run the bundled body-mesh regressor) and write ``waterdepth.txt``.
Results go to ``<out-dir>/<name>_<opt>``.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import torch

from ..utils import gct


def _args():
    p = argparse.ArgumentParser(description="flowtide (PyTorch/CUDA): water "
                                "level estimation")
    p.add_argument("--test-path", type=str, required=True,
                   help="Input frames directory")
    p.add_argument("--test-name", type=str, required=True)
    p.add_argument("--opt", type=str, required=True,
                   choices=["stopsign", "people", "ref"])
    p.add_argument("--seg-dir", type=str, default="./output/segs",
                   help="Segmentation-stage output root")
    p.add_argument("--out-dir", type=str, default="./output/waterlevel")
    p.add_argument("--record-dir", type=str, default="./records/groundtruth",
                   help="Stored calibration records (homo_mat.txt, "
                        "ref_bbox.txt)")
    p.add_argument("--streaming", action="store_true",
                   help="ref mode: segmentation and waterline on the device "
                        "(no mask files between the stages); runs the "
                        "segmentation itself")
    p.add_argument("--model-path", type=str, default=None,
                   help="Video model for --streaming (flat .npz; default: "
                        "the bundled checkpoint)")
    p.add_argument("--det-model-path", type=str, default=None,
                   help="Detector checkpoint for --opt stopsign/people "
                        "(flat .npz; "
                        "an rcnn_config.json beside it selects the "
                        "variant; default: the bundled checkpoint)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' or 'cpu'.")
    return p.parse_args()


def main() -> None:
    args = _args()
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out_dir = os.path.join(args.out_dir, f"{args.test_name}_{args.opt}")
    os.makedirs(out_dir, exist_ok=True)
    img_list = sorted(glob(os.path.join(args.test_path, "*.jpg"))
                      + glob(os.path.join(args.test_path, "*.png")))
    mask_dir = os.path.join(args.seg_dir, args.test_name, "mask")
    masks = [os.path.join(mask_dir, os.path.splitext(
        os.path.basename(p))[0] + ".png") for p in img_list]
    if args.opt in ("stopsign", "people"):
        from .object_detection import est_by_obj_detection
        out = est_by_obj_detection(img_list, masks, out_dir, args.opt,
                                   det_model_path=args.det_model_path,
                                   device=args.device)
        print(gct(), f"Depth estimates written to {out}")
        return
    if args.streaming:
        from .loaders import load_afb_urr
        from .streaming_waterlevel import run_streaming_waterlevel
        model = load_afb_urr(args.model_path, device=args.device)
        out = run_streaming_waterlevel(args.test_path, args.test_name,
                                       out_dir, args.record_dir, model,
                                       device=args.device)
    else:
        from .reference_tracking import est_by_reference
        out = est_by_reference(img_list, masks, out_dir, args.record_dir,
                               args.test_name, device=args.device)
    print(gct(), f"Water levels written to {out}")


if __name__ == "__main__":
    main()
    print(gct(), "Water level estimation done.")
