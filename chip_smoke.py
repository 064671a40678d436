#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``vfloodnet_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. build: four ``nvcc`` runs, started together, build the float32 bank
   read, combine and count kernels, the bf16 read and count kernels, the
   largest-CC kernels and the NMS kernels into
   ``vfloodnet_tpu_torch/_build/``; each
   kernel's registers and spills (``-Xptxas -v``) and its tensor-core
   instructions (``cuobjdump -sass``:
   the float32 read and count must hold ``HMMA`` in TF32, the bf16 ones
   warpgroup ``HGMMA`` in bf16 and no ``HMMA``, and spill nothing).
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (P = 1620 query pixels, dk = 128, dv = 512, N = 98,304 slots,
   2 objects) for a full bank, a bound of 20,000 with valid slots past it
   (so a kernel that ignored the bound would disagree), an all-invalid bank,
   an all-invalid bank at occupancy 0 (one chunk visited), P = 37 on a
   ragged bank of 20,000 slots, and a bound that ends inside the last of 5
   bank segments; the combine kernel against ``combine_partials`` on the
   read kernel's own partials; times of each kernel, its plain version, one
   ``scaled_dot_product_attention`` call as the read's yardstick and the
   cuBLAS float32 ``q @ keys^T`` of the count's scores as its reference
   (the port calls neither).
4. main path: the trained AFB-URR (``records/checkpoints/video/best.npz``
   through the weight bridge) segments eight synthetic 1080p frames at the
   480 operating point with the device largest-CC cleanup, on the eager
   engine (``cuda_graph=False``); steps 2-8 run under
   ``torch.cuda.set_sync_debug_mode("error")``, so a host sync in the step
   raises; the read, combine, count and CC kernels must each launch once
   per frame.
5. graph: the default engine, which replays the step as a CUDA graph, on
   the same frames: its bank must equal the eager engine's tensor for
   tensor and its labels agree on > 0.999 (cuDNN benchmarking off); then
   ``step_n`` of four frames against four eager steps (bank equal again),
   both timed unsynchronised and profiled (device busy time, idle share,
   and the kernels counted by name in the replays, which must include the
   read, combine, count and CC kernels); then both banks filled to
   capacity, three steps with LFU eviction each (the eager ones under the
   sync debug mode), banks equal.
6. small clip: the graph engine on a 240-px clip against itself on the
   CPU (plain versions), at ``memorize_every`` 1 and 2: agreement > 0.999.
7. CC: the CC kernel against its plain version, exactly, on the step's
   1/16 grid, 416 x 416 batches, an empty map, a one-pixel map, a snake and
   equal-size ties; its time, the plain version's and scipy's on the host.
8. image: the trained LinkNet (``records/checkpoints/image/best.npz``)
   through the device pipeline at 416 on a lake frame, card against CPU,
   > 0.999; its time, and a batch of 4 through the device tail.
9. bf16 kernels: the bf16 read (with the float32 combine) and count
   against their plain versions on a bf16 bank at the same shapes (full,
   a bound of 20,000 with valid slots past it, a bound inside the last of
   5 segments, all invalid at occupancy 0, and a bound of 1,700: one
   8,192-slot chunk, the main path's occupancy), mem within rtol 1e-2 /
   atol 2e-3 (in the one-chunk case, on an element where the plain
   version is itself off the read with float32 probabilities by more than
   that, of that read), m and l as in phase 3, and counts within 1; their
   times, the plain versions', one
   bf16 ``scaled_dot_product_attention`` call with the validity mask (the
   backend it took is named) and the cuBLAS bf16 ``q @ keys^T`` of the
   count's scores, each at the full bank and at the one visited chunk.
10. bf16 main path and graph: phases 4-5 with
   ``AFBURR(dtype=torch.bfloat16)`` built from phase 4's weights (which
   must stay float32) and a bf16 bank; the bf16 read and count and the
   combine launch once per frame and the float32 read and count never;
   then phase 6 in bf16, whose agreement must be at least the agreement
   of the CPU's bf16 and float32 labels on that clip (at the same
   ``memorize_every``), less 0.01: bf16 labels there move with the
   convolutions' summation order.
11. water level (``pipelines/streaming_waterlevel.py``): (a) the bf16
   engine of phase 10's weights with a bf16 bank (budget 250,000, 2
   objects, ``postprocess="none"``) as ``StreamingWaterLevel`` steps on
   16 synthetic 1080p frames, first mask water below row 540, the box of
   ``records/groundtruth/LSU_demo/ref_bbox.txt`` and one over the middle
   of the frame, levels through a
   ``BoundedResolver(lag=4)``; every step but the one that captures a
   graph runs under sync debug "error"; each frame's levels equal a host
   scan of its fetched operating-size label; the resolver never holds more
   than 4 frames; the bf16 read, the combine and the bf16 count launch
   once per frame (eager steps and replays); the streaming step's time
   and the plain ``engine.step``'s on the same 8 frames and bank, in
   turns (plain, streaming, streaming, plain; unsynchronised, CUDA events
   at the window's ends). (b) The float32 streaming path on the card
   against the port on the CPU on phase 6's 240-px clip: on every frame
   whose label columns under the boxes agree, the levels are equal. (c)
   The MOSSE tracker on the card against itself on the CPU on a
   translating, growing object: boxes within 1 px, equal ``ok`` flags.
   (d) The bilinear perspective warp of a 1080p frame, card against CPU,
   within 1 grey level, and its time.

12. multi-stream batch (``pipelines/video_seg_batch.py``, B = 4
   streams of 2 objects folded into 8 bank rows): (a) the float32 and
   bf16 read (with the combine) and count with the stream axis (q [4, P,
   dk]) at the full bank and at one chunk, against their plain versions
   (the bounds of phases 3 and 9), each stream equal to its own
   single-stream launch on the same planes, timed beside those 4
   launches, with bounds from the folded shapes; (b) the bf16
   ``BatchVideoSegEngine`` on the main path (trained weights, 1080p ->
   480, budget 250,000 a stream, stream s playing a synthetic clip from
   frame s): 8 steps, all but the first and the captures under sync
   debug "error", one launch of the read, the combine, the count and the
   CC kernel a step, each stream's labels against the single-stream bf16
   engine's on the same frames (>= phase 10's CPU bf16-vs-float32
   agreement less 0.01); the replayed B = 4 step timed and profiled
   beside the single-stream replay (step ms, frames/s, device busy, idle
   share, kernels a step), and (d) both again with every bank full; (c)
   (b) in float32: labels > 0.999, every stream's valid and occ equal to
   the single-stream bank's, and its bootstrapped keys within rtol 1e-4 /
   atol 1e-4 (each merge may then take another slot where two slots'
   cosines with a feature tie within the convolutions' rounding, so
   later keys are logged, not held); in (b) and (c) the batched bank
   update once more against one update per stream on that stream's rows,
   from the same bank (the live one, then every slot valid so that every
   feature evicts) with the same features and bound: keys, values, usage
   and birth within 1e-6, valid, occ and evictions equal; before (b),
   the bf16 bicubic prep resize at B = 4 against four single-frame calls
   and against the strided batched product it replaced, timed;
   (e) the float32 batch engine at B = 2 on phase 6's clip, card against
   CPU, > 0.999.
13. stop-sign detection and depth (``--opt stopsign``; seeded weights:
   the repo has no trained full-width detector): (b) the PointRend
   X-101-32x8d detector at the full width of ``stopsign_rcnn_config`` on
   a seeded 1080p frame (768 x 1344 padded), its forward under sync debug
   "error", the NMS kernel launched exactly twice an image and the plain
   loop never; the time an image and of each stage, device busy time,
   idle share and peak memory; (a) the NMS kernel (``csrc/nms.cu``)
   against its plain loop, exactly, at the RPN's shape (4,756 boxes, IoU
   0.7, 1,000 kept, score > 0, with -inf, tied and duplicate entries),
   the box head's (2,048 class-offset candidates, IoU 0.5, 100 kept, score
   > 0.5), all dead, N < max_out, and the detector's own two calls; its
   time, the plain loop's and the bound; (c) card against CPU at full
   width on scene 0 with ``score_thresh=0.0`` (see
   :func:`card_cpu_phase`); (d) the per-image stop-sign function on both
   scenes, card and CPU rows equal, and a drawn octagon's known ratio.
14. people detection and depth (``--opt people``; seeded weights): (b)
   the Keypoint R-CNN R-101 at the full width of ``keypoint_rcnn_config``
   on phase 13's frame, its forward under sync debug "error", the NMS
   kernel launched exactly twice an image and the plain loop never; the
   time an image and of each stage (the keypoint head: its ROIAlign, 8
   convolutions of 512 on all 100 slots, the deconvolution and the
   upsample; then the heatmaps' argmax on the host), busy time, idle share
   and peak memory; (a) the NMS kernel against its plain loop, exactly,
   at the one-class box head's shape (1,000 candidates, IoU 0.5, 100 kept,
   score > 0.7, ties and duplicates) and on the detector's own two calls;
   (c) card against CPU at full width on people scene 0 with
   ``score_thresh=0.0`` (see :func:`people_card_cpu_phase`); (d) both
   body-mesh regressors at full width (the bundled ``BodyMeshRegressor``
   configuration, ``METRONetwork`` with HRNet-W64), a batch of 4 crops,
   card against CPU within 1e-4, ms a crop at batch 1 and 4; (e) the
   per-image people function on both people fixtures with the trained
   tiny detector's boxes and each seeded regressor, card and CPU rows
   equal, no cv2 or PIL imported.
15. AFB-URR training (``train/``; float32 but where (b) says float64,
   TF32 off, cuDNN deterministic, the trained weights carried into the
   training form): (a) the reference recipe at full width, seeded 400 x
   400 clips of 6 frames and 3 objects, lr 1e-5, lambda_u 0.5, frozen BN:
   ms a step (median of 5 after 2, CUDA events), peak memory (above what
   earlier phases left allocated: the model, optimiser, gradients and
   steps) and the losses (finite) at batch 1 and 4, each also with
   ``remat`` (each clip recomputed in the backward pass), whose losses
   must be equal and whose peak at batch 4 lower; (b) one step of the
   same weights on each of two 240-px clips (3 frames, 2 objects), card
   against CPU (see :func:`train_card_cpu_phase`): in float64 the losses
   within 1e-9 relative and every gradient leaf within 1e-6 of its scale;
   in float32 the losses within 5e-5 relative, the gradients' global
   norms within 5e-4 relative; (d) 30 steps on one repeated clip (lr
   1e-4): the last loss below the first; none of the port's kernels
   launched in (a), (b), (d) (the training read is the plain dense read);
   (c) ``run_video_training`` with the demo recipe (240 px, clip_n 4,
   obj_n 2, lr 1e-4, live BN) over 4 seeded clips: 3 epochs straight
   against 2 epochs and a third resumed from ``final.pt``, which must end
   with equal losses, weights, statistics and optimiser state; then
   ``load_afb_urr`` of its ``best.npz`` segments a frame on the graph
   engine.
16. the image, detection and body-mesh trainers (``train/``; float32,
   TF32 off, seeded in-memory data: no PIL, no cv2; cuDNN deterministic
   for the image trainer, as its CLI runs, and for every card-against-CPU
   step):
   (a) LinkNet (EfficientNet-B4) from the bundled trained weights at the
   CLI's recipe (416 x 416, batch 8, lr 1e-4), frozen and live BN: ms a
   step (median of 5 after 2), peak memory, finite dice and IoU; one step
   at 128 px, batch 2, card against CPU (:func:`trainer_card_cpu`: in
   float64 losses within 1e-9 relative and every gradient leaf within
   1e-6 of its scale; in float32 within :data:`TRAINER_F32_BOUNDS`); and
   ``run_image_training`` (128 px, batch 2, live BN, a validation set)
   for 3 epochs straight against 2 and a third resumed from
   ``final.pt``, which must end equal, then ``best.npz`` through the
   serving ``load_linknet``; (c) the ``BodyMeshRegressor`` (ResNet-50,
   46.8 M, live BN, one 224-px crop a step) from seeded weights: ms a step
   and peak memory over 150 steps of the trainer's samples, whose best
   25-step mean must fall below the first 25's, and one step card against
   CPU; (b) the tiny stop-sign and people detectors at 320 px from seeded
   weights on the cv2-free scenes, 150 steps each (ms a step, peak
   memory; the last 25 steps' mean loss below the first 25's), the
   full-width Keypoint R-CNN R-101 (1 class, keypoints) step at 320 px
   timed, one step of the tiny people detector card against CPU at 96 px;
   no training step launches any of the port's kernels; then the trained
   tiny stop-sign weights through ``export_rcnn_variables`` and the
   serving ``load_default_detector`` detect on a rendered scene, which
   launches the NMS kernel.
17. the feature bank sharded over ranks, the trainers' data parallelism
   and the mask PNGs, on a world of one rank over NCCL made in this
   process (``parallel.init_local_world``: an in-memory store, no other
   process): (a) ``ShardedVideoSegEngine`` in float32 and bf16 (phases 4
   and 10's weights, budget 250,000, 8 synthetic 1080p frames, the device
   CC cleanup) against the eager ``VideoSegEngine`` on the same frames:
   float32 labels > 0.99 a frame and valid counts, occ, replace_n and
   peak_n equal; bf16 labels at least phase 10's CPU bf16-vs-float32
   agreement less 0.01; the read, combine, count and CC kernels once a
   step, no other bank kernel, the sharded read's plain versions never;
   the sharded eager step's ms beside the single engine's eager one on
   the same frames and phase 5's or 10's replayed one; (b) the shard-local kernels at R = 2, 4 and 8 (see
   :func:`shard_kernel_phase`; on the main path's bank against a float64
   read and float64 counts, within twice the plain float32 version's
   error), each shard's read and count ms; (c) the
   video and image trainers' ``mesh=`` step against the plain step, bit
   for bit over 3 steps, frozen and live BN; (d) a 1080p mask through the
   port's PNG writer and reader (no PIL on this machine), read back equal,
   ms of each.
18. the Atlantis evaluation, the RGB PNG writer and the video trainer's
   model axis: (a) the full-width PSPNet (56 classes, seeded weights written
   as the JAX package's flat npz and read by ``load_pspnet``, float32, TF32
   off) at the 768-px padding: the forward's ms (CUDA events, median of
   10) and peak memory, the harness's ms an image (``AtlantisEvaluator``:
   pad, forward, upsample, argmax, water map; host clock, median of 5) at
   540 x 720 and 1080 x 1920, card against CPU on a 256-px image (the
   timed evaluator's model's logits within 1e-4 of their scale; its
   ``predict``'s labels and a CPU evaluator's >= 0.999 equal) and the
   bf16 forward's labels against the float32 ones (printed); (b) a 1080p
   water overlay through ``native.write_rgb_png``, decoded back equal, ms a
   write; (c) ``shard_train_state`` and the model-axis step on a world of
   one over NCCL (mesh (1, 1)) against the plain step, three steps with
   live BN on two 240-px clips, cuDNN deterministic: losses, state and
   AdamW moments equal bit for bit, ms a step (m > 1 needs a rank a
   device: CPU ranks only).

Then one JSON line of the kernels' numbers (with the step times of
phase 5, the image path's and the water-level phase's beside them, and
each kernel's launches in phase 11 as ``launches_waterlevel`` and in
phase 12(b) and (c) as ``launches_batch`` and
``launches_batch_float32``, its phase-12(a) numbers as ``batch4``, the
batch phases' under ``batch``, phase 13's under ``stopsign``, phase 14's
under ``people``, phase 15's under ``training``, phase 16's under
``trainers``, phase 17's under ``sharded``, and each kernel's launches in
phase 17(a)'s float32 and bf16 runs together as ``launches_sharded``,
phase 18's under ``atlantis``; the
NMS kernel's row
counts its launches an image, the people detector's under ``people``)
and, last,
``{"ok": true, "device": {...}}``. In the JSON line, ``bank_read`` times
the read with its combine (the function that its plain version and the
yardstick compute) and gives the read kernel alone as
``read_kernel_ms``; ``bound_ms`` is the 3xTF32 tensor-core bound (three
times the flop at 495 TFLOP/s, against the bytes at 3.35 TB/s) and
``bound_f32_cuda_cores_ms`` the float32 CUDA-core one (67 TFLOP/s). Any
failed check raises and the exit code is not 0; the script exits 1 with
no result when CUDA is absent.
"""

import collections
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from vfloodnet_tpu_torch.memory import FeatureBank, FeatureBankState
from vfloodnet_tpu_torch.memory.feature_bank import OccupancyBound
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.ops import (attention, bank_read_cuda, cc, cc_cuda,
                                     short_side_size)
from vfloodnet_tpu_torch.ops.resize import _cubic_taps, resize
from vfloodnet_tpu_torch.pipelines import image_seg
from vfloodnet_tpu_torch.pipelines.loaders import (default_checkpoint,
                                                   load_afb_urr, load_linknet)
from vfloodnet_tpu_torch.ops.homography import (find_homography,
                                                perspective_map,
                                                warp_perspective)
from vfloodnet_tpu_torch.ops.tracker import MosseTracker
from vfloodnet_tpu_torch.pipelines.streaming_waterlevel import (
    BoundedResolver, StreamingWaterLevel)
from vfloodnet_tpu_torch.pipelines.video_seg import (VideoSegEngine,
                                                     host_largest_cc,
                                                     to_onehot)
from vfloodnet_tpu_torch.pipelines.video_seg_batch import BatchVideoSegEngine
from vfloodnet_tpu_torch.models.detection import (GeneralizedRCNN,
                                                  build_detector,
                                                  keypoint_rcnn_config,
                                                  stopsign_rcnn_config)
from vfloodnet_tpu_torch.models.detection.meta import STRIDES, seeded_init
from vfloodnet_tpu_torch.ops import nms as nms_ops
from vfloodnet_tpu_torch.ops import nms_cuda
from vfloodnet_tpu_torch.ops.homography import perspective_transform
from vfloodnet_tpu_torch.ops.roi_align import LevelTable
from vfloodnet_tpu_torch.models.metro import (BodyMeshRegressor,
                                              METRONetwork, MeshRegressor)
from vfloodnet_tpu_torch.models.metro import seeded_init as mesh_seeded_init
from vfloodnet_tpu_torch.pipelines.object_detection import (
    Instances, load_template_3d, make_stopsign_template, people_depth,
    stopsign_depth)
from vfloodnet_tpu_torch.utils.draw import XY_SHIFT, _fill_convex
from vfloodnet_tpu_torch.core import convert_afb_urr_variables, load_flat_npz
from vfloodnet_tpu_torch.train import (VideoTrainConfig,
                                       init_video_train_state,
                                       make_video_train_step,
                                       run_video_training)
from vfloodnet_tpu_torch.core.checkpoint import save_flat_npz
from vfloodnet_tpu_torch.core.convert import (convert_linknet_variables,
                                              export_rcnn_variables)
from vfloodnet_tpu_torch.data import (SyntheticPeopleDataset,
                                      SyntheticStopsignDataset,
                                      render_stopsign_scene)
from vfloodnet_tpu_torch.models import LinkNet, TrainBN
from vfloodnet_tpu_torch.models.detection.meta import load_default_detector
from vfloodnet_tpu_torch.train import train_bodymesh as tbm
from vfloodnet_tpu_torch.train import train_detection as tdet
from vfloodnet_tpu_torch.train import train_image as timg
from vfloodnet_tpu_torch.train.loops import run_image_training
from vfloodnet_tpu_torch import native
from vfloodnet_tpu_torch.parallel import (close_world, init_local_world,
                                          make_mesh, sharded_read)
from vfloodnet_tpu_torch.pipelines.video_seg_sharded import \
    ShardedVideoSegEngine
from vfloodnet_tpu_torch.utils import COLOR_PALETTE, add_overlay
from vfloodnet_tpu_torch.core.convert import export_pspnet_variables
from vfloodnet_tpu_torch.models.linknet import IMAGENET_MEAN, IMAGENET_STD
from vfloodnet_tpu_torch.models.pspnet import PSPNet
from vfloodnet_tpu_torch.models.pspnet import seeded_init as seeded_psp_init
from vfloodnet_tpu_torch.pipelines.atlantis import AtlantisEvaluator
from vfloodnet_tpu_torch.pipelines.loaders import load_pspnet
from vfloodnet_tpu_torch.train import (gather_train_state,
                                       shard_train_state)

T0 = time.perf_counter()
P, DK, DV, N, OBJ = 1620, 128, 512, 98304, 2
THRES = 1e-3
MEM_TOL = dict(rtol=2e-4, atol=2e-5)
MEM_TOL_BF16 = dict(rtol=1e-2, atol=2e-3)   # one bf16 ulp is 3.9e-3
F32_PEAK = 67e12     # H100 SXM float32 FLOP/s outside the tensor cores
TF32_PEAK = 495e12   # H100 SXM dense TF32 tensor-core FLOP/s
BF16_PEAK = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
HBM_RATE = 3.35e12   # H100 SXM bytes/s
SEED = 0
DEV = torch.device("cuda")
FRAME_HW, DOWNSAMPLE, BUDGET = (1080, 1920), 480, 250_000


def log(phase, msg):
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps=10):
    """Median milliseconds of ``fn`` over ``reps`` calls (CUDA events),
    after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")


KERNELS = ("read_bf16_kernel", "count_bf16_kernel", "read_kernel",
           "combine_kernel", "count_kernel", "cc_init_kernel",
           "cc_merge_kernel", "cc_compress_kernel", "cc_argmax_kernel",
           "cc_keep_kernel")
NMS_KERNELS = ("nms_rank_kernel", "nms_mask_kernel", "nms_walk_kernel")
BANK_STATE = ("keys", "values", "valid", "birth", "usage", "occ", "peak_n",
              "replace_n")


def _kernel_name(symbol):
    return next((k for k in KERNELS + NMS_KERNELS if k in symbol), symbol)


def _ptxas_report(log):
    """Per kernel: registers and spill bytes from the
    ``-Xptxas -v`` report of the build."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_store_bytes"] = int(m.group(1))
            out[name]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def _sass_mma(lib_path):
    """Per kernel: the tensor-core instructions in the library's SASS
    (``HMMA``, of one warp, and ``HGMMA``, of a warpgroup), their counts
    and forms, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
            out[name] = {"hmma": 0, "hgmma": 0, "forms": set()}
            continue
        m = re.search(r"\b((H|HG)MMA\.\S+)", line)
        if m and name is not None:
            out[name]["hmma" if m.group(2) == "H" else "hgmma"] += 1
            out[name]["forms"].add(m.group(1))
    return {k: {**v, "forms": sorted(v["forms"])} for k, v in out.items()}


def build_phase():
    t = time.perf_counter()
    paths = bank_read_cuda.build()
    log("build", f"{paths} in {time.perf_counter() - t:.2f}s (nvcc, every "
        f"library at once: {bank_read_cuda.build_seconds})")
    ptxas, sass = {}, {}
    for lib, path in paths.items():
        ptxas.update(_ptxas_report(bank_read_cuda.build_log.get(lib, "")))
        sass.update(_sass_mma(path))
    for name in KERNELS + NMS_KERNELS:
        log("build", f"{name}: ptxas {ptxas.get(name)}, SASS "
            f"{sass.get(name)}")
    for name in ("read_kernel", "count_kernel"):
        check(sass.get(name, {}).get("hmma", 0) > 0 and
              all("TF32" in f for f in sass[name]["forms"]),
              f"{name} runs on the tensor cores in TF32")
    for name in ("read_bf16_kernel", "count_bf16_kernel"):
        check(sass.get(name, {}).get("hgmma", 0) > 0 and
              sass[name]["hmma"] == 0 and
              all(f.startswith("HGMMA.") and ".BF16" in f
                  for f in sass[name]["forms"]),
              f"{name} runs on the tensor cores as bf16 HGMMA only")
        check(ptxas.get(name, {}).get("spill_store_bytes") == 0 and
              ptxas[name].get("spill_load_bytes") == 0,
              f"{name} spills no registers")
    return {name: {**ptxas.get(name, {}), "sass_mma": sass.get(name)}
            for name in KERNELS + NMS_KERNELS}


def _plain(q, keys, values, valid, occ):
    """The plain versions per object, each on its query plane (q [P, dk],
    or [B, P, dk] for B streams folded along the object axis): (mem, m,
    l), log_thres and the counts."""
    obj = keys.shape[0]
    outs = [attention._read_occ_sweep(keys[o], values[o], valid[o],
                                      attention.query_plane(q, o, obj),
                                      attention.OCC_CHUNK, occ)
            for o in range(obj)]
    mem, m, l = (torch.stack([o[i] for o in outs]) for i in range(3))
    log_thres = math.log(THRES) + torch.log(l) + m
    cnt = torch.stack([attention._count_occ_sweep(
        keys[o], valid[o], attention.query_plane(q, o, obj), log_thres[o],
        attention.OCC_CHUNK, occ) for o in range(obj)])
    return mem, m, l, log_thres, cnt


def _bounds(flop, n_bytes):
    """(bound ms, bound_by, float32 CUDA-core bound ms): the 3xTF32
    tensor-core bound is the larger of 3 flop at the TF32 peak and the bytes
    at the memory rate."""
    t_ops, t_bytes = 3 * flop / TF32_PEAK, n_bytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes",
            1e3 * max(flop / F32_PEAK, t_bytes))


def kernel_phase():
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(SEED)
    keys = torch.randn(OBJ, N, DK, device=dev, generator=g)
    values = torch.randn(OBJ, N, DV, device=dev, generator=g)
    # q at 3x scale: a peaked softmax, so a few probabilities pass 1e-3
    q = 3.0 * torch.randn(P, DK, device=dev, generator=g)
    rand_valid = torch.rand(OBJ, N, device=dev, generator=g) < 0.9
    none_valid = torch.zeros(OBJ, N, dtype=torch.bool, device=dev)
    # P = 37 on a ragged bank of 20,000 slots (3 chunks, the last padded)
    n_r = 20000
    ragged = (q[:37].contiguous(), keys[:, :n_r].contiguous(),
              values[:, :n_r].contiguous(), rand_valid[:, :n_r].contiguous())
    full = (q, keys, values)
    cases = {   # name: (q, keys, values, valid, occ, splits or None)
        "full": (*full, rand_valid, N, None),
        "occ20000": (*full, rand_valid, 20000, None),
        "all_invalid": (*full, none_valid, N, None),
        "all_invalid_occ0": (*full, none_valid, 0, None),
        "p37_n20000": (*ragged, n_r, None),
        # 16,384 visited slots in 5 segments of 3,296: the bound ends 96
        # slots into the last one
        "occ9000_s5": (*full, rand_valid, 9000, 5),
    }
    errs, timing = {}, {}
    for name, (qc, kc, vc, valid, occ, splits) in cases.items():
        valid = valid.contiguous()
        n = kc.shape[1]
        occ_t = torch.tensor([occ], dtype=torch.int32, device=dev)
        if splits is None:
            splits = bank_read_cuda.default_splits(
                OBJ, qc.shape[0],
                torch.cuda.get_device_properties(dev).multi_processor_count)
        parts = bank_read_cuda.bank_read_partials(
            qc, kc, vc, valid, occ_t, attention.OCC_CHUNK, splits)
        mem_k, m_k, l_k, lt_k = bank_read_cuda.bank_read_combine(*parts,
                                                                 THRES)
        mem_p, m_p, l_p, log_thres, cnt_p = _plain(qc, kc, vc, valid, occ)
        # the count kernel on the plain version's thresholds, so that its
        # comparison does not depend on the read's
        cnt_k = bank_read_cuda.bank_count(qc, kc, valid, occ_t, log_thres,
                                          attention.OCC_CHUNK)
        torch.cuda.synchronize()
        combined = attention.combine_partials(*parts, THRES)
        comb_err = max((a - b).abs().max().item()
                       for a, b in zip((mem_k, m_k, l_k, lt_k), combined))
        check(all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                  for a, b in zip((mem_k, m_k, l_k, lt_k), combined)),
              f"{name}: combine kernel within rtol 1e-5 atol 1e-6 of "
              f"combine_partials on the kernel's partials")
        check(torch.isfinite(mem_k).all().item(), f"{name}: mem finite")
        mem_err = (mem_k - mem_p).abs().max().item()
        cnt_diff = (cnt_k - cnt_p).abs()
        n_mismatch = int((cnt_diff > 0).sum())
        cnt_err = cnt_diff.max().item()
        n_visit = attention.visited_slots(n, attention.OCC_CHUNK, occ)
        beyond = cnt_k[:, min(n_visit, n):].abs().sum().item()
        log("kernels", f"{name} (P {qc.shape[0]}, N {n}, occ {occ}, S "
            f"{splits}): mem max|err| {mem_err:.3e}, m max|err| "
            f"{(m_k - m_p).abs().max().item():.3e}, l max rel err "
            f"{((l_k - l_p) / l_p).abs().max().item():.3e}, combine vs plain "
            f"combine {comb_err:.3e}, cnt slots differing {n_mismatch} (max "
            f"|diff| {cnt_err}), cnt total {cnt_k.sum().item():.0f}, cnt "
            f"beyond bound {beyond}")
        check(torch.allclose(mem_k, mem_p, **MEM_TOL),
              f"{name}: mem within rtol 2e-4 atol 2e-5")
        check(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-5),
              f"{name}: m within rtol 1e-5 atol 1e-5")
        check(torch.allclose(l_k, l_p, rtol=1e-4, atol=0),
              f"{name}: l within rtol 1e-4")
        check(cnt_err <= 1.0, f"{name}: cnt |diff| <= 1 per slot")
        check(beyond == 0, f"{name}: no counts beyond the bound")
        errs[name] = (mem_err, comb_err, cnt_err)
        if name.startswith("all_invalid"):
            # every score is -1e30: a uniform mean over the visited slots
            want = vc[:, :n_visit].mean(1, keepdim=True).expand_as(mem_k)
            check(cnt_k.sum().item() == 0, f"{name}: counts are 0")
            check(torch.allclose(mem_k, want, **MEM_TOL),
                  f"{name}: mem is the mean of the first {n_visit} values")
        if name == "occ20000":
            # the case tells a bounded loop from one over the whole bank
            unbounded = _plain(qc, kc, vc, valid, n)[0]
            check(not torch.allclose(mem_k, unbounded, **MEM_TOL),
                  "occ20000: the unbounded read differs from the bounded")
        if name != "full":
            continue
        check(cnt_k.sum().item() > 0, "full bank has nonzero counts")
        chunk = attention.OCC_CHUNK
        read_ms = time_ms(lambda: bank_read_cuda.bank_read(
            q, keys, values, valid, occ_t, chunk, THRES))
        read_kernel_ms = time_ms(lambda: bank_read_cuda.bank_read_partials(
            q, keys, values, valid, occ_t, chunk, splits))
        combine_ms = time_ms(lambda: bank_read_cuda.bank_read_combine(
            *parts, THRES))
        count_ms = time_ms(lambda: bank_read_cuda.bank_count(
            q, keys, valid, occ_t, log_thres, chunk))
        plain_read_ms = time_ms(lambda: [attention._read_occ_sweep(
            keys[o], values[o], valid[o], q, chunk, occ)
            for o in range(OBJ)], reps=5)
        plain_combine_ms = time_ms(lambda: attention.combine_partials(
            *parts, THRES))
        plain_count_ms = time_ms(lambda: [attention._count_occ_sweep(
            keys[o], valid[o], q, log_thres[o], chunk, occ)
            for o in range(OBJ)], reps=5)
        qb = q[None, None].expand(OBJ, 1, P, DK)
        mask = valid[:, None, None, :]
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qb, keys[:, None], values[:, None], attn_mask=mask), reps=5)
        # a reference, not the same function: cuBLAS float32 q @ keys^T,
        # the scores the count compares, written out in full
        scores_ms = time_ms(lambda: torch.matmul(q, keys.transpose(1, 2)),
                            reps=5)
        n_vis = n_visit
        read_flop = OBJ * 2 * P * n_vis * (DK + DV)
        read_bytes = 4 * (P * DK + OBJ * n_vis * (DK + DV)
                          + OBJ * P * (DV + 3)) + OBJ * n_vis
        comb_flop = OBJ * splits * P * 2 * DV
        comb_bytes = 4 * (OBJ * splits * P * (DV + 2) + OBJ * P * (DV + 3))
        count_flop = OBJ * 2 * P * n_vis * DK
        count_bytes = 4 * (P * DK + OBJ * n_vis * DK + OBJ * P + OBJ * N) \
            + OBJ * n_vis
        # the combine is float32 work on the CUDA cores
        comb_t = (comb_flop / F32_PEAK, comb_bytes / HBM_RATE)
        comb_bound = (1e3 * max(comb_t),
                      "operations" if comb_t[0] > comb_t[1] else "bytes",
                      1e3 * max(comb_t))
        timing = dict(
            bank_read=(read_ms, plain_read_ms, sdpa_ms,
                       *_bounds(read_flop, read_bytes),
                       {"read_kernel_ms": read_kernel_ms, "splits": splits}),
            bank_read_combine=(combine_ms, plain_combine_ms, None,
                               *comb_bound, {"splits": splits}),
            bank_count=(count_ms, plain_count_ms, None,
                        *_bounds(count_flop, count_bytes),
                        {"reference_cublas_f32_scores_ms": scores_ms}))
        log("kernels", f"full: read + combine {read_ms:.3f} ms (read kernel "
            f"{read_kernel_ms:.3f}, combine {combine_ms:.3f}, S {splits}; "
            f"plain {plain_read_ms:.3f}, sdpa {sdpa_ms:.3f}, bound "
            f"{timing['bank_read'][3]:.3f}, f32 bound "
            f"{timing['bank_read'][5]:.3f}); count {count_ms:.3f} ms (plain "
            f"{plain_count_ms:.3f}, bound {timing['bank_count'][3]:.3f}, f32 "
            f"bound {timing['bank_count'][5]:.3f}, cuBLAS f32 scores "
            f"{scores_ms:.3f}); combine plain {plain_combine_ms:.3f}")
    del keys, values, ragged, full, cases, kc, vc, parts
    torch.cuda.empty_cache()
    return errs, timing


def _sdpa_bf16(q, keys, values, valid):
    """One bf16 ``scaled_dot_product_attention`` call over every object
    (each on its query plane of q [P, dk] or [B, P, dk]) with the validity
    mask, on the first backend that takes it: (fn, backend name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qb = _per_object(q, keys.shape[0])[:, None]
    args = (qb, keys[:, None], values[:, None])
    mask = valid[:, None, None, :]
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def fn(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(*args, attn_mask=mask)
        try:
            fn()
        except RuntimeError:
            continue
        return fn, backend.name
    raise RuntimeError("no SDPA backend takes the bf16 read")


def _per_object(q, obj):
    """q [P, dk] or [B, P, dk] -> [obj, P, dk], each object's query plane
    (a view when it can be)."""
    if q.ndim == 2:
        return q[None].expand(obj, *q.shape)
    return q.repeat_interleave(obj // q.shape[0], dim=0)


def _exact_mem(q, keys, values, valid, n_visit):
    """The read of a bf16 bank with float32 probabilities: one softmax over
    the first ``n_visit`` (<= N) slots per object (each on its query
    plane), masked slots at -1e30."""
    out = []
    for o in range(keys.shape[0]):
        qo = attention.query_plane(q, o, keys.shape[0])
        s = (qo.float() @ keys[o, :n_visit].float().T) / math.sqrt(DK)
        s = torch.where(valid[o, :n_visit][None], s,
                        torch.full_like(s, attention.NEG_INF))
        out.append(torch.softmax(s, dim=1) @ values[o, :n_visit].float())
    return torch.stack(out)


def _time_bf16(q, keys, values, valid, occ_t, occ, splits, log_thres):
    """Times of the bf16 read (with the combine) and count on the visited
    slots of bound ``occ``, of their plain versions and yardsticks, and
    their bounds: {kernel row name: (ms, plain ms, library ms, bound ms,
    bound_by, extra)}."""
    chunk = attention.OCC_CHUNK
    n_vis = attention.visited_slots(N, chunk, occ)
    read_ms = time_ms(lambda: bank_read_cuda.bank_read(
        q, keys, values, valid, occ_t, chunk, THRES))
    read_kernel_ms = time_ms(lambda: bank_read_cuda.bank_read_partials(
        q, keys, values, valid, occ_t, chunk, splits))
    count_ms = time_ms(lambda: bank_read_cuda.bank_count(
        q, keys, valid, occ_t, log_thres, chunk))
    plain_read_ms = time_ms(lambda: [attention._read_occ_sweep(
        keys[o], values[o], valid[o], q, chunk, occ)
        for o in range(OBJ)], reps=5)
    plain_count_ms = time_ms(lambda: [attention._count_occ_sweep(
        keys[o], valid[o], q, log_thres[o], chunk, occ)
        for o in range(OBJ)], reps=5)
    # the yardsticks see only the visited slots
    kv, vv, okv = keys[:, :n_vis], values[:, :n_vis], valid[:, :n_vis]
    sdpa, backend = _sdpa_bf16(q, kv, vv, okv)
    sdpa_ms = time_ms(sdpa, reps=5)
    # a reference, not the same function: cuBLAS bf16 q @ keys^T, the
    # scores the count compares, written out in full
    scores_ms = time_ms(lambda: torch.matmul(q, kv.transpose(1, 2)), reps=5)
    read_flop = OBJ * 2 * P * n_vis * (DK + DV)
    read_bytes = 2 * (P * DK + OBJ * n_vis * (DK + DV)) \
        + 4 * OBJ * P * (DV + 3) + OBJ * n_vis
    count_flop = OBJ * 2 * P * n_vis * DK
    count_bytes = 2 * (P * DK + OBJ * n_vis * DK) \
        + 4 * (OBJ * P + OBJ * N) + OBJ * n_vis

    def bound(flop, n_bytes):
        t_ops, t_bytes = flop / BF16_PEAK, n_bytes / HBM_RATE
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops > t_bytes else "bytes")

    timing = dict(
        bank_read_bf16=(read_ms, plain_read_ms, sdpa_ms,
                        *bound(read_flop, read_bytes),
                        {"read_kernel_ms": read_kernel_ms,
                         "splits": splits, "sdpa_backend": backend}),
        bank_count_bf16=(count_ms, plain_count_ms, None,
                         *bound(count_flop, count_bytes),
                         {"reference_cublas_bf16_scores_ms": scores_ms}))
    log("kernels_bf16", f"occ {occ} ({n_vis} slots visited): read + combine "
        f"{read_ms:.3f} ms (read kernel {read_kernel_ms:.3f}, S {splits}; "
        f"plain {plain_read_ms:.3f}, sdpa {backend} {sdpa_ms:.3f}, bound "
        f"{timing['bank_read_bf16'][3]:.3f}); count {count_ms:.3f} ms "
        f"(plain {plain_count_ms:.3f}, bound "
        f"{timing['bank_count_bf16'][3]:.3f}, cuBLAS bf16 scores "
        f"{scores_ms:.3f})")
    return timing


def kernel_phase_bf16():
    """The bf16 read (with the float32 combine) and count against their
    plain versions on a bf16 bank at the main path's shapes."""
    dev, bf = DEV, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    keys = torch.randn(OBJ, N, DK, device=dev, generator=g).to(bf)
    values = torch.randn(OBJ, N, DV, device=dev, generator=g).to(bf)
    q = (3.0 * torch.randn(P, DK, device=dev, generator=g)).to(bf)
    rand_valid = (torch.rand(OBJ, N, device=dev, generator=g) < 0.9)
    none_valid = torch.zeros(OBJ, N, dtype=torch.bool, device=dev)
    cases = {   # name: (valid, occ, splits or None)
        "full": (rand_valid, N, None),
        "occ20000": (rand_valid, 20000, None),
        "occ9000_s5": (rand_valid, 9000, 5),
        "all_invalid_occ0": (none_valid, 0, None),
        # the main path's occupancy (~1.6-2.0k slots): one chunk visited
        "one_chunk": (rand_valid, 1700, None),
    }
    chunk = attention.OCC_CHUNK
    errs, timing = {}, {}
    for name, (valid, occ, splits) in cases.items():
        occ_t = torch.tensor([occ], dtype=torch.int32, device=dev)
        if splits is None:
            splits = bank_read_cuda.default_splits(
                OBJ, P, torch.cuda.get_device_properties(dev)
                .multi_processor_count)
        parts = bank_read_cuda.bank_read_partials(q, keys, values, valid,
                                                  occ_t, chunk, splits)
        mem_k, m_k, l_k, _ = bank_read_cuda.bank_read_combine(*parts, THRES)
        mem_p, m_p, l_p, log_thres, cnt_p = _plain(q, keys, values, valid,
                                                   occ)
        cnt_k = bank_read_cuda.bank_count(q, keys, valid, occ_t, log_thres,
                                          chunk)
        torch.cuda.synchronize()
        check(torch.isfinite(mem_k).all().item(), f"bf16 {name}: mem finite")
        mem_err = (mem_k - mem_p).abs().max().item()
        cnt_diff = (cnt_k - cnt_p).abs()
        n_visit = attention.visited_slots(N, chunk, occ)
        beyond = cnt_k[:, min(n_visit, N):].abs().sum().item()
        log("kernels_bf16", f"{name} (P {P}, N {N}, occ {occ}, S {splits}): "
            f"mem max|err| {mem_err:.3e}, m max|err| "
            f"{(m_k - m_p).abs().max().item():.3e}, l max rel err "
            f"{((l_k - l_p) / l_p).abs().max().item():.3e}, cnt slots "
            f"differing {int((cnt_diff > 0).sum())} (max |diff| "
            f"{cnt_diff.max().item()}), cnt total {cnt_k.sum().item():.0f}, "
            f"cnt beyond bound {beyond}")
        # mem is held to the plain version. In the one-chunk case the plain
        # version rounds its bf16 probabilities against the max of the whole
        # chunk and lies, on an element of this bank, farther than the bar
        # from the read with float32 probabilities (PERF.md section 6);
        # there, on such elements only, the kernel is held to that read
        near = torch.isclose(mem_k, mem_p, **MEM_TOL_BF16)
        if name == "one_chunk":
            exact = _exact_mem(q, keys, values, valid, n_visit)
            plain_off = ~torch.isclose(mem_p, exact, **MEM_TOL_BF16)
            kernel_off = ~torch.isclose(mem_k, exact, **MEM_TOL_BF16)
            log("kernels_bf16", f"{name}: mem elements off the plain "
                f"version {int((~near).sum())}; plain version off the "
                f"float32-probability read {int(plain_off.sum())}, kernel "
                f"off it {int(kernel_off.sum())}")
            near |= plain_off & ~kernel_off
        check(bool(near.all()), f"bf16 {name}: mem within rtol 1e-2 atol "
              f"2e-3")
        check(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-5),
              f"bf16 {name}: m within rtol 1e-5 atol 1e-5")
        check(torch.allclose(l_k, l_p, rtol=1e-4, atol=0),
              f"bf16 {name}: l within rtol 1e-4")
        check(cnt_diff.max().item() <= 1.0,
              f"bf16 {name}: cnt |diff| <= 1 per slot")
        check(beyond == 0, f"bf16 {name}: no counts beyond the bound")
        errs[name] = (mem_err, cnt_diff.max().item())
        if name == "all_invalid_occ0":
            want = values[:, :n_visit].float().mean(1, keepdim=True)
            check(cnt_k.sum().item() == 0, f"bf16 {name}: counts are 0")
            check(torch.allclose(mem_k, want.expand_as(mem_k),
                                 **MEM_TOL_BF16),
                  f"bf16 {name}: mem is the mean of the first {n_visit} "
                  f"values")
        if name == "occ20000":
            unbounded = _plain(q, keys, values, valid, N)[0]
            check(not torch.allclose(mem_k, unbounded, **MEM_TOL_BF16),
                  "bf16 occ20000: the unbounded read differs")
        if name not in ("full", "one_chunk"):
            continue
        check(cnt_k.sum().item() > 0, f"bf16 {name} has nonzero counts")
        timing[name] = _time_bf16(q, keys, values, valid, occ_t, occ,
                                  splits, log_thres)
    del keys, values, q, rand_valid, none_valid, cases, parts
    torch.cuda.empty_cache()
    return errs, timing


def synthetic_clip(n, h, w, seed):
    """Seeded frames with a textured sky above a rippling lower half, and a
    first mask of the lower half as water (label 1)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([90 + 60 * yy / h, 120 + 40 * xx / w,
                     200 - 80 * yy / h], axis=-1)
    water = yy > h * 0.55
    frames = []
    for t in range(n):
        ripple = 25 * np.sin(xx / 37.0 + t * 0.7) * np.cos(yy / 23.0)
        img = base + np.where(water, ripple, 0)[..., None]
        img[water] *= np.array([0.4, 0.6, 1.0], np.float32)
        img = img + rng.randn(h, w, 1) * 6
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames, water.astype(np.uint8)


def _no_sync_step(eng, state, frame, idx):
    """One step under ``torch.cuda.set_sync_debug_mode("error")``: any
    host sync inside it raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return eng.step(state, frame, idx)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def main_path_phase(model, kernels):
    """The eager engine of ``model`` (and a bank of its compute dtype) on
    eight synthetic 1080p frames; each of ``kernels`` (and no other bank
    kernel) must launch once per frame, and the CC kernel too. Every step
    after the first (which fills the engine's caches) runs under the sync
    debug mode "error". Returns (launches, state, engine, frames,
    labels)."""
    frames, mask0 = synthetic_clip(9, *FRAME_HW, SEED)
    fb = FeatureBank(obj_n=2, memory_budget=BUDGET, dtype=model.dtype,
                     device=DEV)
    check(fb.class_budget == N, "98,304 slots per object")
    eng = VideoSegEngine(model, fb, downsample=DOWNSAMPLE,
                         postprocess="device", cuda_graph=False)
    state = eng.bootstrap(frames[0], mask0)
    check(state.keys.dtype == model.dtype and
          state.usage.dtype == torch.float32, "bank dtypes")
    step_ms, labels = [], []
    bank_read_cuda.reset_launches()
    cc_cuda.reset_launches()
    for i, f in enumerate(frames[1:]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == 0:
            state, lab = eng.step(state, f, i + 1)
        else:
            state, lab = _no_sync_step(eng, state, f, i + 1)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        labels.append(lab)
    launches = {**bank_read_cuda.launches, **cc_cuda.launches}
    for lab in labels:
        arr = eng.fetch_label(lab)
        check(arr.shape == FRAME_HW and arr.dtype == np.uint8,
              f"label shape {arr.shape} {arr.dtype}")
        check(set(np.unique(arr)) <= {0, 1}, "labels in {0, 1}")
    want = {k: (len(frames) - 1 if k in kernels + ("largest_cc",) else 0)
            for k in launches}
    check(launches == want, f"main path launched {kernels} and the CC "
          f"kernel once per frame and no other bank kernel: {launches}")
    warm = step_ms[1:]
    water = float(np.mean([eng.fetch_label(lab).mean() for lab in labels]))
    h, w = short_side_size(*FRAME_HW, DOWNSAMPLE)
    log("main", f"{model.dtype}, trained weights, eager, 8 steps of "
        f"{FRAME_HW} -> {(h, w)} (P = {-(-h // 16) * -(-w // 16)}), steps "
        f"2-8 under sync debug mode 'error' (no sync raised): first step "
        f"{step_ms[0]:.1f} ms, then per step {['%.1f' % s for s in warm]} "
        f"ms, median {np.median(warm):.1f} ms = "
        f"{1e3 / np.median(warm):.2f} frames/s; occ {state.occ.tolist()}; "
        f"launches {launches}; water fraction {water:.3f}")
    return launches, state, eng, frames, labels


def _bank_equal(a, b, what):
    diff = [k for k in BANK_STATE
            if not torch.equal(getattr(a, k), getattr(b, k))]
    check(not diff, f"{what}: bank tensors differ: {diff}")


def _label_agreement(eng, got, want):
    return float(np.mean([(eng.fetch_label(g) == eng.fetch_label(w)).mean()
                          for g, w in zip(got, want)]))


def _timed_steps(eng, state, frames, first_idx, n_steps=None):
    """Milliseconds per step of ``step`` over ``frames`` (``step_n`` when
    ``n_steps``), unsynchronised, CUDA events at the run's ends."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    if n_steps:
        state, labels = eng.step_n(state, np.stack(frames), first_idx)
        labels = list(labels)
    else:
        labels = []
        for i, f in enumerate(frames):
            state, lab = eng.step(state, f, first_idx + i)
            labels.append(lab)
    b.record()
    b.synchronize()
    return state, labels, a.elapsed_time(b) / len(frames)


def _profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _busy_ms(prof, kernel_names):
    """Device time in a ``torch.profiler`` trace: (busy ms, {kernel name:
    (ms, launches)} for the names in ``kernel_names``)."""
    from torch.autograd import DeviceType
    busy, per = 0.0, {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        busy += evt.self_device_time_total / 1e3
        name = _kernel_name(evt.key)
        if name in kernel_names:
            ms, n = per.get(name, (0.0, 0))
            per[name] = (ms + evt.self_device_time_total / 1e3,
                         n + evt.count)
    return busy, per


def graph_phase(model, eager, eager_state, frames, eager_labels, kernels):
    """The graph engine of ``model`` (the default on the card) against the
    eager one of :func:`main_path_phase` on the same eight frames: the
    bank equal tensor for tensor and labels > 0.999; then four more frames
    as ``step_n`` against four eager steps (bank equal again), timed, with
    the device's busy time from ``torch.profiler``; the kernels counted by
    name in that profile must have launched from inside the graphs. Then a
    full bank on both engines (eager steps under sync debug "error"), 3
    frames with LFU eviction, banks equal."""
    torch.backends.cudnn.benchmark = False
    fb = FeatureBank(obj_n=2, memory_budget=BUDGET, dtype=model.dtype,
                     device=DEV)
    eng = VideoSegEngine(model, fb, downsample=DOWNSAMPLE,
                         postprocess="device")
    check(eng.cuda_graph, "the engine replays graphs on the card by default")
    state = eng.bootstrap(frames[0], synthetic_clip(1, *FRAME_HW, SEED)[1])
    bank_read_cuda.reset_launches()
    cc_cuda.reset_launches()
    labels = []
    for i, f in enumerate(frames[1:]):
        state, lab = eng.step(state, f, i + 1)
        labels.append(lab)
    torch.cuda.synchronize()
    counted = {**bank_read_cuda.launches, **cc_cuda.launches}
    agree = _label_agreement(eng, labels, eager_labels)
    _bank_equal(state, eager_state, "graph vs eager, 8 frames")
    check(agree > 0.999, f"graph vs eager labels agree {agree}")
    replays = sum(g.replays for g in eng.graphs.values())
    log("graph", f"{model.dtype}: 8 frames, {len(eng.graphs)} graphs "
        f"captured, {replays} replays; bank equal to the eager engine's, "
        f"labels agree {agree:.6f}; counted launches (eager steps and "
        f"captures) {counted}; launches by the replays "
        f"{eng.graph_launches()}")
    more, _ = synthetic_clip(5, *FRAME_HW, SEED + 5)
    more, n = np.stack(more[1:]), 4
    # From here each pass starts from the same bank with an exact
    # occupancy bound that is not refreshed within the pass, so every pass
    # meets the same graph keys: the first runs each new key eagerly, the
    # second captures, the timed and profiled passes only replay.
    snap = {k: getattr(state, k).clone() for k in BANK_STATE}
    engines = {"eager": (eager, eager_state), "graph": (eng, state)}
    for _, st in engines.values():
        st.occ_host.refresh = lambda occ: None

    def run(name, around=contextlib.nullcontext):
        e, st = engines[name]
        for k in BANK_STATE:
            getattr(st, k).copy_(snap[k])
        st.occ_host.reset(st.occ)
        with around():
            if name == "graph":
                return list(e.step_n(st, more, 9)[1])
            return [e.step(st, f, 9 + i)[1] for i, f in enumerate(more)]

    labels_n = {name: run(name) for name in engines}
    _bank_equal(state, eager_state, "step_n vs eager steps")
    agree_n = _label_agreement(eng, labels_n["graph"], labels_n["eager"])
    check(agree_n > 0.999, f"step_n vs steps labels agree {agree_n}")
    run("graph")                                         # captures
    captured = len(eng.graphs)
    ms, busy, per = {}, {}, {}
    names = kernels + ("cc_init_kernel", "cc_keep_kernel")
    for name in engines:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        @contextlib.contextmanager
        def timed():
            torch.cuda.synchronize()
            events[0].record()
            yield
            events[1].record()
            events[1].synchronize()
        run(name, timed)
        ms[name] = events[0].elapsed_time(events[1]) / n
        before = eng.graph_launches()
        holder = {}

        @contextlib.contextmanager
        def profiled():
            with _profile() as prof:
                yield
                torch.cuda.synchronize()
            holder["prof"] = prof
        run(name, profiled)
        t_busy, per[name] = _busy_ms(holder["prof"], names)
        busy[name] = t_busy / n
        if name == "graph":
            replay_launches = {k: v - before.get(k, 0)
                               for k, v in eng.graph_launches().items()}
    check(len(eng.graphs) == captured, "the timed passes only replayed")
    for name in names:
        check(per["graph"].get(name, (0, 0))[1] >= n,
              f"{name} launched from the graph replays: {per['graph']}")
    for st in (state, eager_state):
        del st.occ_host.refresh
    timing = {"eager_ms": ms["eager"], "graph_ms": ms["graph"],
              "eager_busy_ms": busy["eager"], "graph_busy_ms": busy["graph"],
              "eager_idle": 1 - busy["eager"] / ms["eager"],
              "graph_idle": 1 - busy["graph"] / ms["graph"],
              "graph_kernels": {k: {"ms_per_step": v[0] / n,
                                    "launches": v[1]}
                                for k, v in per["graph"].items()},
              "eager_kernels": {k: {"ms_per_step": v[0] / n,
                                    "launches": v[1]}
                                for k, v in per["eager"].items()},
              "replay_launches": replay_launches}
    log("graph", f"{model.dtype}: step_n of {n} frames equal to {n} eager "
        f"steps (labels {agree_n:.6f}); ms per step, unsynchronised: eager "
        f"{ms['eager']:.2f} (device busy {busy['eager']:.2f}, idle "
        f"{timing['eager_idle']:.1%}), graph {ms['graph']:.2f} (busy "
        f"{busy['graph']:.2f}, idle {timing['graph_idle']:.1%}); kernels "
        f"in the replays (profiler, ms and launches over {n} steps) "
        f"{per['graph']}; eager {per['eager']}; launches the replays "
        f"recorded {replay_launches}")
    full = full_bank_phase(eager, eager_state, eng, state)
    return timing, full


def small_agreement_phase(model, memorize_every=1):
    """The same engine on a 240-px clip, on the card (kernels, graph
    replays) and on the CPU (plain versions), from the same weights, at
    ``memorize_every``: (label agreement, the CPU's labels)."""
    frames, mask0 = synthetic_clip(5, 240, 427, SEED + 1)
    out = {}
    for dev in (DEV, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev)
        eng = VideoSegEngine(m, FeatureBank(obj_n=2, memory_budget=65_536,
                                            dtype=model.dtype, device=dev),
                             downsample=240, postprocess="device",
                             memorize_every=memorize_every)
        state = eng.bootstrap(frames[0], mask0)
        labs = []
        for i, f in enumerate(frames[1:]):
            state, lab = eng.step(state, f, i + 1)
            labs.append(eng.fetch_label(lab))
        out[dev.type] = np.stack(labs)
    agree = float((out[DEV.type] == out["cpu"]).mean())
    log("main", f"{model.dtype}, small clip 240x427, 4 steps, "
        f"memorize_every {memorize_every}: card vs CPU label agreement "
        f"{agree:.6f}")
    return agree, out["cpu"]


def _cc_cases():
    """name -> uint8 maps [B, H, W] on the card: the video step's 1/16
    grid, 416 x 416 batches, empty, one pixel, a snake, equal-size ties."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 6)
    h16, w16 = (d // 16 for d in short_side_size(*FRAME_HW, DOWNSAMPLE))

    def blobs(b, h, w, p):
        noise = torch.rand(b, 1, h, w, device=DEV, generator=g)
        smooth = F.avg_pool2d(noise, 5, 1, 2)
        return (smooth > p).to(torch.uint8)[:, 0]

    snake = torch.zeros(1, 64, 64, dtype=torch.uint8, device=DEV)
    snake[0, ::4, 1:63] = 1
    snake[0, 1::8, 62] = snake[0, 2::8, 62] = snake[0, 3::8, 62] = 1
    snake[0, 5::8, 1] = snake[0, 6::8, 1] = snake[0, 7::8, 1] = 1
    ties = torch.zeros(1, 40, 40, dtype=torch.uint8, device=DEV)
    ties[0, 2:6, 30:34] = ties[0, 20:24, 3:7] = ties[0, 30:34, 30:34] = 1
    one = torch.zeros(2, 416, 416, dtype=torch.uint8, device=DEV)
    one[1, 200, 300] = 1
    return {"grid_1_16": blobs(1, h16, w16, 0.5),
            "batch_416": blobs(4, 416, 416, 0.5),
            "batch_416_sparse": blobs(4, 416, 416, 0.53),
            "empty": torch.zeros(1, h16, w16, dtype=torch.uint8, device=DEV),
            "one_pixel": one, "snake": snake, "ties": ties}


def cc_phase(launches):
    """The CC kernel against its plain version, exactly, on every case;
    its time, the plain version's and scipy's on the host, at the video
    step's grid and at a 416 x 416 batch of 4."""
    rows = {}
    for name, maps in _cc_cases().items():
        got = cc_cuda.largest_cc(maps)
        want = cc.largest_cc_plain(maps)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"cc {name}: kernel equals plain")
        if name == "snake":
            check(int(got.sum()) == int(maps.sum()), "the snake is one "
                  "component")
        if name == "ties":
            check(int(got[0, 2, 30]) == 1 and int(got.sum()) == 16,
                  "ties go to the smaller root")
        rows[name] = int(got.sum())
    timing = {}
    cases = _cc_cases()
    for name in ("grid_1_16", "batch_416"):
        maps = cases[name]
        host = maps.cpu().numpy()
        host_largest_cc(host[0])            # imports scipy
        t = time.perf_counter()
        for _ in range(5):
            [host_largest_cc(m) for m in host]
        scipy_ms = 1e3 * (time.perf_counter() - t) / 5
        n_bytes = 2 * maps.numel()      # the mask in, the keep mask out
        timing[name] = {
            "ms": time_ms(lambda: cc_cuda.largest_cc(maps)),
            "plain_ms": time_ms(lambda: cc.largest_cc_plain(maps), reps=5),
            "scipy_host_ms": scipy_ms,
            "bound_ms": 1e3 * n_bytes / HBM_RATE, "bound_by": "bytes",
            "shape": list(maps.shape)}
    log("cc", f"kernel equals plain on {rows} (kept cells); times "
        f"{timing}; main-path launches {launches}")
    return timing


def linknet_phase():
    """The trained LinkNet's device pipeline at 416 on a frame of the lake
    clip (``records/port_fixtures/lake_frame0_480x270.npy``, decoded and
    downsized ahead: the card's machine has no image decoder), on the card
    against the port on the CPU: > 0.999 of pixels agree; its time on the
    card, and that of a batch of 4 through the device tail."""
    img = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "records", "port_fixtures",
                               "lake_frame0_480x270.npy"))
    img = img.astype(np.float32) / 255.0
    out = {}
    for dev in (DEV, torch.device("cpu")):
        model = load_linknet(device=dev)
        x = torch.from_numpy(img).to(dev)
        cc_cuda.reset_launches()
        out[dev.type] = image_seg.device_pipeline(model, x).cpu().numpy()
        if dev.type == "cuda":
            check(cc_cuda.launches["largest_cc"] == 1, "the image pipeline "
                  "ran the CC kernel")
            ms = time_ms(lambda: image_seg.device_pipeline(model, x))
            g = torch.Generator(device=dev).manual_seed(SEED + 8)
            batch = torch.rand(4, 416, 416, 3, device=dev, generator=g)
            tail_ms = time_ms(lambda: image_seg.device_tail(
                model, batch, FRAME_HW))
    agree = float((out["cuda"] == out["cpu"]).mean())
    log("image", f"trained LinkNet device pipeline, {img.shape[:2]} -> 416 "
        f"-> {img.shape[:2]}: card vs CPU agreement {agree:.6f}, water "
        f"fraction "
        f"{out['cuda'].mean():.3f}; card {ms:.2f} ms a frame; batch of 4 "
        f"at 416 with the device tail to {FRAME_HW} {tail_ms:.2f} ms")
    check(agree > 0.999, "image pipeline: card and CPU agree on > 0.999")
    check(0.0 < out["cuda"].mean() < 1.0, "the mask is not uniform")
    return {"pipeline_ms": ms, "batch4_tail_ms": tail_ms, "agree": agree}


def full_bank_phase(eager, eager_state, eng, state):
    """Both banks filled to capacity alike, then three frames with LFU
    eviction on the eager engine (under sync debug "error") and on the
    graph engine (eager, capture, replay): the banks stay equal."""
    frames, _ = synthetic_clip(3, *FRAME_HW, SEED + 3)
    cap = state.capacity
    out, banks = {}, {}
    for name, e, st in (("eager", eager, eager_state), ("graph", eng, state)):
        g = torch.Generator(device=DEV).manual_seed(SEED + 2)
        st.keys.normal_(generator=g)
        st.values.normal_(generator=g)
        st.valid.fill_(True)
        st.usage.uniform_(0.0, 5.0, generator=g)
        st.birth.zero_()
        st.occ.fill_(cap)
        st.replace_n.zero_()
        st.occ_host.reset(st.occ)
        step_ms = []
        for i, f in enumerate(frames):
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, lab = (_no_sync_step(e, st, f, 20 + i) if name == "eager"
                       else e.step(st, f, 20 + i))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            check(e.fetch_label(lab).shape == FRAME_HW, "full-bank label")
        evicted = st.replace_n.tolist()
        check(st.occ.tolist() == [cap, cap], f"occ stays {cap}: {st.occ}")
        check(min(evicted) > 0, f"eviction ran: {evicted}")
        check(bool(torch.isfinite(st.keys).all() and
                   torch.isfinite(st.values).all()), "bank finite")
        out[name] = step_ms
        log("full_bank", f"{st.keys.dtype} bank, {name}, 3 steps at occ "
            f"{cap}: {['%.1f' % s for s in step_ms]} ms (synchronised); "
            f"evicted {evicted}")
    _bank_equal(state, eager_state, "full bank, graph vs eager")
    return out


def kernel_rows(errs, timing, launches, build, errs16, timing16,
                launches16):
    """One row per kernel for the result's JSON line."""
    rows = []
    for name, kernel, idx in (("bank_read", "read_kernel", 0),
                              ("bank_read_combine", "combine_kernel", 1),
                              ("bank_count", "count_kernel", 2)):
        ms, plain_ms, lib_ms, bound_ms, bound_by, f32_ms, extra = \
            timing[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "vfloodnet_tpu_torch/csrc/bank_read.cu",
            "replaces": "vfloodnet_tpu/ops/attention_pallas.py:"
                        f"{67 if name == 'bank_count' else 29}",
            "launches": launches[name],
            "max_abs_err": max(e[idx] for e in errs.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "bound_f32_cuda_cores_ms": f32_ms, **(extra or {}),
            **build[kernel]})
    for name, kernel, idx in (("bank_read_bf16", "read_bf16_kernel", 0),
                              ("bank_count_bf16", "count_bf16_kernel", 1)):
        ms, plain_ms, lib_ms, bound_ms, bound_by, extra = \
            timing16["full"][name]
        one = timing16["one_chunk"][name]
        extra = {**extra, "one_chunk": {
            "ms": one[0], "plain_ms": one[1], "library_ms": one[2],
            "bound_ms": one[3], "bound_by": one[4], **one[5]}}
        rows.append({
            "name": name, "route": "cuda",
            "source": "vfloodnet_tpu_torch/csrc/bank_read_bf16.cu",
            "replaces": "vfloodnet_tpu/ops/attention_pallas.py:"
                        f"{67 if name == 'bank_count_bf16' else 29}",
            "launches": launches16[name],
            "max_abs_err": max(e[idx] for e in errs16.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, **extra,
            **build[kernel]})
    return rows


def cc_row(cc_timing, launches, launches16):
    """The CC kernel's row: times at the video step's 1/16 grid, the 416
    batch beside them."""
    t = cc_timing["grid_1_16"]
    return {
        "name": "largest_cc", "route": "cuda",
        "source": "vfloodnet_tpu_torch/csrc/cc.cu",
        "replaces": "vfloodnet_tpu/ops/cc.py:202",
        "replaces_kind": "an XLA while_loop, not a Pallas kernel",
        "launches": launches["largest_cc"], "max_abs_err": 0.0,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "scipy_host_ms": t["scipy_host_ms"], "shape": t["shape"],
        "launches_bf16_main_path": launches16["largest_cc"],
        "batch_416": cc_timing["batch_416"]}


def _host_levels(label, boxes, scale):
    """Levels [T] of the JAX package's arithmetic on a host scan of an
    operating-size label: the first water row strictly below each box's
    bottom centre."""
    out = []
    for x, y, w, h in boxes:
        col, row = int((x + w / 2) * scale), int((y + h) * scale)
        below = np.nonzero(label[row + 1:, col] == 1)[0]
        lv = np.nan if below.size == 0 else (1 + below[0]) / scale
        out.append(np.nan if lv <= 1.0 / scale else float(lv))
    return out


def _captures_next(eng, state, frame):
    """Whether ``eng.step`` of ``frame`` will capture a graph (the second
    step of a graph key) rather than replay it or run eagerly."""
    m = eng._features(frame.shape[-3:-1])
    key = (tuple(frame.shape), True, eng.fb.plan(state, m))
    return key in eng._seen and key not in eng.graphs


def _same_levels(a, b):
    return all((np.isnan(x) and np.isnan(y)) or x == y for x, y in zip(a, b))


def streaming_phase(model16, kernels):
    """(a) of phase 11: the bf16 streaming path at full width; returns
    its numbers and the kernels' launches."""
    frames, _ = synthetic_clip(17, *FRAME_HW, SEED + 9)
    mask0 = np.zeros(FRAME_HW, np.uint8)
    mask0[540:] = 1
    box_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "records", "groundtruth", "LSU_demo",
                            "ref_bbox.txt")
    # the LSU site's stored box, and one over the middle of the frame
    boxes = [tuple(int(v) for v in np.atleast_2d(np.loadtxt(box_path))[0]),
             (900, 300, 40, 100)]
    fb = FeatureBank(obj_n=2, memory_budget=BUDGET, dtype=torch.bfloat16,
                     device=DEV)
    eng = VideoSegEngine(model16, fb, downsample=DOWNSAMPLE,
                         postprocess="none")
    check(eng.cuda_graph, "the streaming engine replays graphs")
    state = eng.bootstrap(frames[0], mask0)
    stream = StreamingWaterLevel(eng, boxes)
    resolver = BoundedResolver(stream, len(boxes), lag=4)
    bank_read_cuda.reset_launches()
    cc_cuda.reset_launches()
    pendings, smalls, guarded = [], [], 0
    for i, f in enumerate(frames[1:]):
        # the first step fills the engine's caches; a capture synchronises
        if i > 0 and not _captures_next(eng, state, f):
            torch.cuda.set_sync_debug_mode("error")
            guarded += 1
        try:
            state, pending, small = stream.step_async(state, f, i + 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        resolver.push(pending)
        check(len(resolver.pending) <= 4, "the resolver holds at most 4")
        pendings.append(pending)
        smalls.append(small)
    levels = resolver.finish()
    torch.cuda.synchronize()
    counted = {**bank_read_cuda.launches, **cc_cuda.launches}
    captured = sum((collections.Counter(g.launches)
                    for g in eng.graphs.values()), collections.Counter())
    replayed = eng.graph_launches()
    launches = {k: counted[k] - captured.get(k, 0) + replayed.get(k, 0)
                for k in counted}
    n = len(frames) - 1
    want = {k: (n if k in kernels else 0) for k in launches}
    check(launches == want, f"streaming launched {kernels} once per frame "
          f"and no other bank or CC kernel: {launches}")
    check(guarded == n - 1 - len(eng.graphs), f"{guarded} of {n} steps "
          f"ran under sync debug: all but the first and the "
          f"{len(eng.graphs)} captures")
    check(resolver.max_live == 4, f"resolver held {resolver.max_live}")
    scale = smalls[0].shape[0] / FRAME_HW[0]
    raw, filled, prev = [], [], [0.0] * len(boxes)
    for pending, small in zip(pendings, smalls):
        lv = stream.resolve(pending)
        host = _host_levels(small.cpu().numpy(), boxes, scale)
        check(_same_levels(lv, host), f"levels {lv} equal the host scan "
              f"{host}")
        prev = [p if np.isnan(v) else v for v, p in zip(lv, prev)]
        raw.append(lv)
        filled.append(prev)
    check(levels == filled, "the resolver forward-fills the levels")
    check(any(np.isfinite(lv).any() for lv in raw), f"water found below "
          f"a box: {raw}")
    first_rows = [[int(np.argmax(sm[:, c] == 1)) if (sm[:, c] == 1).any()
                   else None for c in (int((x + w / 2) * scale)
                                       for x, y, w, h in boxes)]
                  for sm in (smalls[0].cpu().numpy(),
                             smalls[-1].cpu().numpy())]
    # the same 8 frames from the same bank, plain steps and streaming
    # steps in turns; the occupancy bound is not refreshed within a pass,
    # so every pass meets the same graph key (the first pass captures it)
    snap = {k: getattr(state, k).clone() for k in BANK_STATE}
    state.occ_host.refresh = lambda occ: None
    window = frames[1:9]

    def run(streaming, around=contextlib.nullcontext):
        for k in BANK_STATE:
            getattr(state, k).copy_(snap[k])
        state.occ_host.reset(state.occ)
        res = BoundedResolver(stream, len(boxes), lag=4)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with around():
            torch.cuda.synchronize()
            a.record()
            for i, f in enumerate(window):
                if streaming:
                    res.push(stream.step_async(state, f, 17 + i)[1])
                else:
                    eng.step(state, f, 17 + i)
            b.record()
            b.synchronize()
        res.finish()
        return a.elapsed_time(b) / len(window)

    run(True)
    run(True)                                     # captures, if it must
    graphs = len(eng.graphs)
    times = {"plain": [], "streaming": []}
    for streaming in (False, True, True, False):
        times["streaming" if streaming else "plain"].append(run(streaming))
    busy = {}
    for streaming in (False, True):
        holder = {}

        @contextlib.contextmanager
        def profiled():
            with _profile() as prof:
                yield
            holder["prof"] = prof
        run(streaming, profiled)
        busy["streaming" if streaming else "plain"] = _busy_ms(
            holder["prof"], ())[0] / len(window)
    check(len(eng.graphs) == graphs, "the timed passes only replayed")
    del state.occ_host.refresh
    plain_ms = float(np.median(times["plain"]))
    stream_ms = float(np.median(times["streaming"]))
    out = {"steps": n, "graphs": len(eng.graphs),
           "replays": sum(g.replays for g in eng.graphs.values()),
           "steps_under_sync_debug": guarded, "launches": launches,
           "resolver_max_live": resolver.max_live,
           "boxes": [list(b) for b in boxes],
           "levels_px": [[None if np.isnan(v) else v for v in lv]
                         for lv in raw],
           "plain_step_ms": times["plain"], "stream_step_ms":
           times["streaming"], "overhead_ms": stream_ms - plain_ms,
           "plain_busy_ms": busy["plain"],
           "stream_busy_ms": busy["streaming"],
           "stream_idle": 1 - busy["streaming"] / stream_ms}
    log("waterlevel", f"bf16 streaming, {n} steps of {FRAME_HW} -> "
        f"{tuple(smalls[0].shape)}, boxes {boxes}: {out['graphs']} graphs, "
        f"{out['replays']} replays, {guarded} steps under sync debug "
        f"'error' (none raised); launches {launches}; levels equal the host "
        f"scan on every frame (first {raw[0]}, last {raw[-1]} px; first "
        f"water row in the boxes' columns, first and last frame: "
        f"{first_rows}); "
        f"resolver held at most {resolver.max_live}; ms per step over "
        f"{len(window)} frames, plain {times['plain']} / streaming "
        f"{times['streaming']}: overhead {out['overhead_ms']:.4f} ms; "
        f"device busy a step (profiler) plain {busy['plain']:.3f}, "
        f"streaming {busy['streaming']:.3f} ms, idle share of the "
        f"streaming step {out['stream_idle']:.1%}")
    del eng, state, smalls, pendings
    torch.cuda.empty_cache()
    return out, launches


def streaming_agreement_phase(model):
    """(b) of phase 11: the float32 streaming path on the card against
    the port on the CPU on phase 6's 240-px clip."""
    frames, mask0 = synthetic_clip(5, 240, 427, SEED + 1)
    boxes = [(60, 100, 20, 20), (200, 90, 16, 30), (350, 60, 20, 40)]
    out = {}
    for dev in (DEV, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev)
        eng = VideoSegEngine(m, FeatureBank(obj_n=2, memory_budget=65_536,
                                            device=dev),
                             downsample=240, postprocess="none")
        stream = StreamingWaterLevel(eng, boxes)
        state = eng.bootstrap(frames[0], mask0)
        rows = []
        for i, f in enumerate(frames[1:]):
            state, lv, small = stream.step(state, f, i + 1)
            rows.append((lv, small.cpu().numpy()))
        out[dev.type] = rows
    cols = [int(x + w / 2) for x, y, w, h in boxes]
    agree = equal = 0
    for (lv_c, s_c), (lv_h, s_h) in zip(out["cuda"], out["cpu"]):
        if np.array_equal(s_c[:, cols], s_h[:, cols]):
            agree += 1
            check(_same_levels(lv_c, lv_h), f"card levels {lv_c} equal "
                  f"the CPU's {lv_h} where the columns agree")
            equal += 1
    share = agree / len(out["cuda"])
    log("waterlevel", f"float32 streaming, 240x427 clip, 4 steps, 3 boxes: "
        f"label columns under the boxes agree card vs CPU on {agree} of "
        f"{len(out['cuda'])} frames ({share:.2f}); levels equal on all "
        f"{equal}; card {out['cuda'][-1][0]}, CPU {out['cpu'][-1][0]}")
    return {"frames_columns_agree": share}


def tracker_phase():
    """(c) of phase 11: MOSSE on the card against the CPU."""
    rng = np.random.RandomState(SEED + 10)
    size, side, cx, cy = 480, 40.0, 200.0, 220.0
    frames = []
    for _ in range(21):
        img = rng.uniform(0, 60, (size, size)).astype(np.float32)
        s = int(round(side))
        tex = (np.indices((s, s)).sum(0) % 7) * 25.0 + 120.0
        x1, y1 = int(cx - s / 2), int(cy - s / 2)
        img[y1:y1 + s, x1:x1 + s] = tex
        frames.append(img)
        cx, cy, side = cx + 3.0, cy + 2.0, side * 1.015
    box = (180, 200, 40, 40)
    out = {}
    for dev in ("cuda", "cpu"):
        tr = MosseTracker(device=dev)
        tr.init(frames[0], box)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out[dev] = [tr.update(f) for f in frames[1:]]
        out[dev + "_ms"] = 1e3 * (time.perf_counter() - t) / 20
    worst = 0
    for (ok_c, b_c), (ok_h, b_h) in zip(out["cuda"], out["cpu"]):
        check(ok_c == ok_h, "tracker ok flags equal, card vs CPU")
        worst = max(worst, max(abs(a - b) for a, b in zip(b_c, b_h)))
    check(worst <= 1, f"tracker boxes within 1 px, card vs CPU: {worst}")
    log("waterlevel", f"MOSSE tracker, 20 frames of a translating, growing "
        f"object: boxes card vs CPU within {worst} px, ok flags equal "
        f"({sum(ok for ok, _ in out['cuda'])} of 20 ok); "
        f"last box {out['cuda'][-1][1]}; {out['cuda_ms']:.2f} ms a frame "
        f"on the card (host clock, includes its PSR read), "
        f"{out['cpu_ms']:.2f} on the CPU")
    return {"box_max_diff_px": worst, "card_ms": out["cuda_ms"],
            "cpu_ms": out["cpu_ms"]}


def warp_phase():
    """(d) of phase 11: the bilinear perspective warp of a 1080p frame,
    card against CPU."""
    frame = synthetic_clip(1, *FRAME_HW, SEED + 11)[0][0]
    h, w = FRAME_HW
    src = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                   np.float64)
    hm = find_homography(src, src + np.array([[20, 10], [-30, 15],
                                              [12, -18], [-25, -22]]))
    host = torch.from_numpy(frame)
    dev = host.to(DEV)
    warp = perspective_map(hm, FRAME_HW, device=DEV)
    got = warp(dev).cpu()
    want = warp_perspective(host, hm)
    diff = int((got.int() - want.int()).abs().max())
    check(diff <= 1, f"warp card vs CPU within 1 grey level: {diff}")
    ms = time_ms(lambda: warp(dev))
    map_ms = time_ms(lambda: perspective_map(hm, FRAME_HW, device=DEV),
                     reps=5)
    log("waterlevel", f"bilinear perspective warp of {FRAME_HW}: card vs "
        f"CPU max |diff| {diff} grey level(s), "
        f"{float((got != want).float().mean()):.2e} of values differ; "
        f"{ms:.3f} ms a frame on the card with the map made once "
        f"({map_ms:.3f} ms to make it)")
    return {"max_diff": diff, "ms": ms, "map_ms": map_ms}


STREAMS = 4


def _bound(flop, n_bytes, peak):
    """(bound ms, bound_by): the larger of ``flop`` at ``peak`` FLOP/s and
    ``n_bytes`` at the memory rate."""
    t_ops, t_bytes = flop / peak, n_bytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes")


def _stream_rows(b):
    return slice(OBJ * b, OBJ * (b + 1))


def stream_kernel_phase(dtype):
    """12(a): the read (with the combine) and the count of ``dtype`` with
    the stream axis, B = 4 streams of 2 objects folded into 8 (q [4, P,
    dk]), at the full bank and at one chunk: against their plain versions
    (the bounds of phases 3 and 9), against 4 single-stream launches on
    the same planes and segments (equal), and timed beside those 4
    launches; bounds from the folded shapes."""
    dev, rows, chunk = DEV, STREAMS * OBJ, attention.OCC_CHUNK
    f32 = dtype == torch.float32
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    keys = torch.randn(rows, N, DK, device=dev, generator=g).to(dtype)
    values = torch.randn(rows, N, DV, device=dev, generator=g).to(dtype)
    q = (3.0 * torch.randn(STREAMS, P, DK, device=dev, generator=g)).to(dtype)
    valid = torch.rand(rows, N, device=dev, generator=g) < 0.9
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = bank_read_cuda.default_splits(rows, P, sms)
    tol = MEM_TOL if f32 else MEM_TOL_BF16
    read_name = "bank_read" if f32 else "bank_read_bf16"
    count_name = "bank_count" if f32 else "bank_count_bf16"
    out = {read_name: {}, count_name: {}}
    if f32:
        out["bank_read_combine"] = {}
    for case, occ in (("full", N), ("one_chunk", 1700)):
        occ_t = torch.tensor([occ], dtype=torch.int32, device=dev)
        parts = bank_read_cuda.bank_read_partials(q, keys, values, valid,
                                                  occ_t, chunk, splits)
        mem_k, m_k, l_k, lt_k = bank_read_cuda.bank_read_combine(*parts,
                                                                 THRES)
        # the combine alone, on the same partials (as phase 3)
        combined = attention.combine_partials(*parts, THRES)
        comb_err = max((a - b).abs().max().item()
                       for a, b in zip((mem_k, m_k, l_k, lt_k), combined))
        check(all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                  for a, b in zip((mem_k, m_k, l_k, lt_k), combined)),
              f"{dtype} B=4 {case}: combine kernel within rtol 1e-5 atol "
              f"1e-6 of combine_partials on the kernel's partials")
        del combined
        mem_p, m_p, l_p, log_thres, cnt_p = _plain(q, keys, values, valid,
                                                   occ)
        cnt_k = bank_read_cuda.bank_count(q, keys, valid, occ_t, log_thres,
                                          chunk)
        n_visit = attention.visited_slots(N, chunk, occ)
        near = torch.isclose(mem_k, mem_p, **tol)
        if not f32 and case == "one_chunk":   # as phase 9's one-chunk case
            exact = _exact_mem(q, keys, values, valid, n_visit)
            near |= ~torch.isclose(mem_p, exact, **tol) & \
                torch.isclose(mem_k, exact, **tol)
        cnt_err = (cnt_k - cnt_p).abs().max().item()
        check(bool(near.all()), f"{dtype} B=4 {case}: mem within {tol}")
        check(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-5) and
              torch.allclose(l_k, l_p, rtol=1e-4, atol=0),
              f"{dtype} B=4 {case}: m and l")
        check(cnt_err <= 1.0 and cnt_k.sum().item() > 0,
              f"{dtype} B=4 {case}: cnt within 1, nonzero")
        for b in range(STREAMS):    # one stream's launch on the same planes
            r = _stream_rows(b)
            one = bank_read_cuda.bank_read_partials(
                q[b], keys[r], values[r], valid[r], occ_t, chunk, splits)
            mem_b = bank_read_cuda.bank_read_combine(*one, THRES)[0]
            cnt_b = bank_read_cuda.bank_count(q[b], keys[r], valid[r],
                                              occ_t, log_thres[r], chunk)
            check(torch.equal(mem_b, mem_k[r]) and torch.equal(cnt_b,
                                                               cnt_k[r]),
                  f"{dtype} B=4 {case}: stream {b} equals its own launch")
        mem_err = (mem_k - mem_p).abs().max().item()

        def singles(fn):
            return lambda: [fn(b, _stream_rows(b)) for b in range(STREAMS)]

        read_ms = time_ms(lambda: bank_read_cuda.bank_read(
            q, keys, values, valid, occ_t, chunk, THRES))
        read4_ms = time_ms(singles(lambda b, r: bank_read_cuda.bank_read(
            q[b], keys[r], values[r], valid[r], occ_t, chunk, THRES)))
        count_ms = time_ms(lambda: bank_read_cuda.bank_count(
            q, keys, valid, occ_t, log_thres, chunk))
        count4_ms = time_ms(singles(lambda b, r: bank_read_cuda.bank_count(
            q[b], keys[r], valid[r], occ_t, log_thres[r], chunk)))
        plain_read_ms = time_ms(lambda: [attention._read_occ_sweep(
            keys[o], values[o], valid[o], q[o // OBJ], chunk, occ)
            for o in range(rows)], reps=3)
        plain_count_ms = time_ms(lambda: [attention._count_occ_sweep(
            keys[o], valid[o], q[o // OBJ], log_thres[o], chunk, occ)
            for o in range(rows)], reps=3)
        kv, vv, okv = (t[:, :n_visit] for t in (keys, values, valid))
        if f32:
            qb, mask = _per_object(q, rows)[:, None], okv[:, None, None, :]
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qb, kv[:, None], vv[:, None], attn_mask=mask), reps=5)
        else:
            sdpa_ms = time_ms(_sdpa_bf16(q, kv, vv, okv)[0], reps=5)
        el = 4 if f32 else 2
        read_flop = rows * 2 * P * n_visit * (DK + DV)
        read_bytes = el * (STREAMS * P * DK + rows * n_visit * (DK + DV)) \
            + 4 * rows * P * (DV + 3) + rows * n_visit
        count_flop = rows * 2 * P * n_visit * DK
        count_bytes = el * (STREAMS * P * DK + rows * n_visit * DK) \
            + 4 * (rows * P + rows * N) + rows * n_visit
        # the float32 kernels' bound is 3xTF32: three products a product
        peak = TF32_PEAK / 3 if f32 else BF16_PEAK
        out[read_name][case] = dict(
            ms=read_ms, ms_4_single=read4_ms, plain_ms=plain_read_ms,
            library_ms=sdpa_ms, max_abs_err=mem_err, splits=splits,
            **dict(zip(("bound_ms", "bound_by"),
                       _bound(read_flop, read_bytes, peak))))
        out[count_name][case] = dict(
            ms=count_ms, ms_4_single=count4_ms, plain_ms=plain_count_ms,
            library_ms=None, max_abs_err=cnt_err,
            **dict(zip(("bound_ms", "bound_by"),
                       _bound(count_flop, count_bytes, peak))))
        if f32:
            comb_bytes = 4 * (rows * splits * P * (DV + 2)
                              + rows * P * (DV + 3))
            out["bank_read_combine"][case] = dict(
                ms=time_ms(lambda: bank_read_cuda.bank_read_combine(
                    *parts, THRES)),
                ms_4_single=None,
                plain_ms=time_ms(lambda: attention.combine_partials(
                    *parts, THRES), reps=5),
                library_ms=None, max_abs_err=comb_err,
                **dict(zip(("bound_ms", "bound_by"), _bound(
                    rows * splits * P * 2 * DV, comb_bytes, F32_PEAK))))
        log("batch_kernels", f"{dtype} B={STREAMS} ({rows} objects, q "
            f"{tuple(q.shape)}), {case} (occ {occ}, {n_visit} slots "
            f"visited, S {splits}): mem max|err| {mem_err:.3e}, combine vs "
            f"plain combine {comb_err:.3e}, cnt max "
            f"|diff| {cnt_err}; every stream equal to its own launch; read "
            f"+ combine {read_ms:.3f} ms (4 single-stream calls "
            f"{read4_ms:.3f}, plain {plain_read_ms:.3f}, SDPA "
            f"{sdpa_ms:.3f}, bound {out[read_name][case]['bound_ms']:.3f}),"
            f" count {count_ms:.3f} ms (4 single {count4_ms:.3f}, plain "
            f"{plain_count_ms:.3f}, bound "
            f"{out[count_name][case]['bound_ms']:.3f})")
    del keys, values, q, valid, parts
    torch.cuda.empty_cache()
    return out


def _stream_frames(clip, t):
    """Frame t of each of the STREAMS streams: stream s plays the clip
    from frame s on, cyclically (as bench.py's batched stage does)."""
    return np.stack([clip[(t + s) % len(clip)] for s in range(STREAMS)])


def _kernels_per_step(prof, steps, top=10):
    """Kernel launches a step in a ``torch.profiler`` trace (copies and
    fills not counted), and the ``top`` kernels by device time: [(name,
    ms a step, launches a step)]."""
    from torch.autograd import DeviceType
    evts = [evt for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and not evt.key.startswith(("Memcpy", "Memset"))]
    evts.sort(key=lambda e: -e.self_device_time_total)
    return (sum(evt.count for evt in evts) / steps,
            [(evt.key[:80], evt.self_device_time_total / 1e3 / steps,
              evt.count / steps) for evt in evts[:top]])


def _path_launches(eng):
    """Kernel launches of a run: the counted ones (eager steps and
    captures) less the captures' plus the graph replays'."""
    counted = {**bank_read_cuda.launches, **cc_cuda.launches}
    captured = sum((collections.Counter(g.launches)
                    for g in eng.graphs.values()), collections.Counter())
    replayed = eng.graph_launches()
    return {k: counted[k] - captured.get(k, 0) + replayed.get(k, 0)
            for k in counted}


def _fill_bank(state, seed):
    """Every slot of every row valid, random keys, values and usage."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    state.keys.normal_(generator=g)
    state.values.normal_(generator=g)
    state.valid.fill_(True)
    state.usage.uniform_(0.0, 5.0, generator=g)
    state.birth.zero_()
    state.occ.fill_(state.capacity)
    state.replace_n.zero_()
    state.occ_host.reset(state.occ)


def _window_timer(runs):
    """``run(name, around)`` over ``runs`` {name: (engine, state, frames
    of each step, first frame index)}: each pass restores its state's
    bank as it was when this was made (the bound exact and not refreshed
    within the pass) and returns ms a step, unsynchronised, CUDA events at
    the pass's ends."""
    snaps = {name: {k: getattr(st, k).clone() for k in BANK_STATE}
             for name, (_, st, _, _) in runs.items()}
    for _, st, _, _ in runs.values():
        st.occ_host.refresh = lambda occ: None

    def run(name, around=contextlib.nullcontext):
        eng, st, frames, first = runs[name]
        for k in BANK_STATE:
            getattr(st, k).copy_(snaps[name][k])
        st.occ_host.reset(st.occ)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with around():
            torch.cuda.synchronize()
            a.record()
            for i, f in enumerate(frames):
                eng.step(st, f, first + i)
            b.record()
            b.synchronize()
        return a.elapsed_time(b) / len(frames)

    def release():
        for _, st, _, _ in runs.values():
            del st.occ_host.refresh

    return run, release


def _timed_windows(runs, kernel_names):
    """Warm-up passes (eager, capture), then passes in turns (a, b, b, a)
    and one profiled pass each: {name: {"step_ms": [...], "busy_ms",
    "idle", "kernels_per_step", "kernels": {name: (ms, launches)}}}."""
    run, release = _window_timer(runs)
    names = list(runs)
    for name in names:
        run(name)
        run(name)                                # captures, if it must
    graphs = {name: len(runs[name][0].graphs) for name in names}
    out = {name: {"step_ms": []} for name in names}
    for name in names + names[::-1]:
        out[name]["step_ms"].append(run(name))
    for name in names:
        holder = {}

        @contextlib.contextmanager
        def profiled():
            with _profile() as prof:
                yield
            holder["prof"] = prof
        run(name, profiled)
        steps = len(runs[name][2])
        busy, per = _busy_ms(holder["prof"], kernel_names)
        ms = float(np.median(out[name]["step_ms"]))
        n_kernels, top = _kernels_per_step(holder["prof"], steps)
        out[name].update(busy_ms=busy / steps, idle=1 - busy / steps / ms,
                         kernels_per_step=n_kernels, top_kernels=top,
                         kernels={k: (v[0] / steps, v[1])
                                  for k, v in per.items()},
                         frames_per_s=1e3 * (STREAMS if name.startswith(
                             "batch") else 1) / ms)
        check(all(per.get(k, (0, 0))[1] == steps for k in kernel_names),
              f"{name}: each of {kernel_names} launched once a replay: "
              f"{per}")
    check({name: len(runs[name][0].graphs) for name in names} == graphs,
          "the timed passes only replayed")
    release()
    return out


def _update_isolation(eng, state, frames, last_labels, frame_idx,
                      fill_seed=None):
    """The batched bank update against one update per stream on that
    stream's rows alone, from one bank (``state``'s, or with
    ``fill_seed`` every slot valid and random, so that every feature
    evicts), the same features (memorized from ``frames`` [B, H, W, 3]
    with ``last_labels`` [B, H, W] as masks) and the same bound: no
    convolution rounds differently between the two, so keys, values,
    usage and birth must agree within 1e-6 and valid, occ and evictions
    be equal. ``state`` is left as it was. -> {field: max |diff|}."""
    model, fb = eng.model, eng.fb
    small_hw = short_side_size(*frames.shape[1:3], DOWNSAMPLE)
    x = torch.from_numpy(frames).to(DEV).to(model.dtype) / 255.0
    fs = resize(x, small_hw, "bicubic", spatial_axes=(1, 2))
    masks = torch.from_numpy(np.stack([to_onehot(lab, fb.obj_n)
                                       for lab in last_labels])).to(DEV)
    masks = resize(masks, small_hw, "nearest_torch", spatial_axes=(-2, -1))
    k4, v4 = model.memorize_streams(fs, masks)
    snap = {k: getattr(state, k).clone() for k in BANK_STATE}
    if fill_seed is not None:
        filled = FeatureBankState(**snap, occ_host=OccupancyBound(
            0, state.capacity))
        _fill_bank(filled, fill_seed)
    bound = int(snap["occ"].max())
    batched = FeatureBankState(**{k: v.clone() for k, v in snap.items()})
    fb.update_device(batched, k4, v4, frame_idx, bound)
    diffs = dict.fromkeys(BANK_STATE, 0.0)
    for s in range(STREAMS):
        r = _stream_rows(s)
        one = FeatureBankState(**{k: v[r].clone() for k, v in snap.items()})
        fb.update_device(one, k4[r], v4[r], frame_idx, bound)
        for k in BANK_STATE:
            a, b = getattr(batched, k)[r], getattr(one, k)
            diffs[k] = max(diffs[k], (a.double() - b.double()).abs().max()
                           .item())
        del one
    check(all(diffs[k] <= 1e-6 for k in ("keys", "values", "usage",
                                         "birth")) and
          all(diffs[k] == 0 for k in ("valid", "occ", "peak_n",
                                      "replace_n")),
          f"{model.dtype} B={STREAMS} batched update against each stream's "
          f"own update, {'full' if fill_seed is not None else 'live'} bank "
          f"(bound {bound}): {diffs}")
    evicted = batched.replace_n.sum().item() - snap["replace_n"].sum().item()
    del snap, batched, k4, v4
    torch.cuda.empty_cache()
    return {"bound": bound, "evicted": evicted, "max_abs": diffs}


def _strided_bicubic_bf16(x, out_hw):
    """The bf16 bicubic as it stood before its passes made their operand
    contiguous: ``@`` on the strided float32 view, a batched product."""
    for ax, n_out in ((x.ndim - 3, out_hw[0]), (x.ndim - 2, out_hw[1])):
        taps = _cubic_taps(x.shape[ax], n_out, x.device)
        x = (x.movedim(ax, -1).float() @ taps).to(torch.bfloat16) \
            .movedim(-1, ax)
    return x


def resize_phase():
    """The bf16 bicubic prep resize (1080p -> 480) of the B = 4 step
    beside four single-frame calls, and both beside the strided form it
    replaced: results within one bf16 ulp of 1 of each other, times."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 15)
    x = torch.rand((STREAMS,) + FRAME_HW + (3,), device=DEV,
                   generator=g).to(torch.bfloat16)
    hw = short_side_size(*FRAME_HW, DOWNSAMPLE)
    out = {}
    ys = []
    for name, fn in (("folded", lambda t: resize(
            t, hw, "bicubic", spatial_axes=(-3, -2))),
                     ("strided", lambda t: _strided_bicubic_bf16(t, hw))):
        y4 = fn(x).float()
        ones = torch.stack([fn(x[s]) for s in range(STREAMS)]).float()
        out[name] = {"b4_ms": time_ms(lambda: fn(x)),
                     "4x1_ms": time_ms(lambda: [fn(x[s])
                                                for s in range(STREAMS)]),
                     "b1_ms": time_ms(lambda: fn(x[0])),
                     "b4_vs_4x1_max_abs": (y4 - ones).abs().max().item()}
        ys.append(y4)
    out["folded_vs_strided_max_abs"] = (ys[0] - ys[1]).abs().max().item()
    check(max(out["folded"]["b4_vs_4x1_max_abs"],
              out["strided"]["b4_vs_4x1_max_abs"],
              out["folded_vs_strided_max_abs"]) <= 2 ** -7,
          f"bf16 bicubic: B = 4, four single calls and the strided form "
          f"within one bf16 ulp of 1: {out}")
    log("batch_resize", f"bf16 bicubic {tuple(x.shape)} -> {hw}: {out}")
    return out


def batch_main_phase(model, kernels, prof_kernels, gap=None, steps=8,
                     full_bank=False):
    """12(b)/(c)/(d): the batch engine of ``model`` at B = 4 on the main
    path (trained weights, 1080p -> 480, 2 objects, budget 250,000 a
    stream, each stream a phase of one synthetic clip), ``steps`` steps:
    every step but the first and the captures under sync debug "error",
    each kernel of ``kernels`` and the CC kernel once a step; each
    stream's labels against the single-stream engine's on the same frames
    (bf16: >= ``gap`` - 0.01; float32: > 0.999, the banks' valid and
    occ equal, and the bootstrapped keys within rtol 1e-4 / atol 1e-4);
    the batched update against each stream's own update from one bank
    (:func:`_update_isolation`, the live banks and full ones); then the
    replayed step timed and
    profiled beside the single-stream one, and with ``full_bank`` both
    again with every bank full."""
    clip, mask0 = synthetic_clip(8, *FRAME_HW, SEED + 12)
    fb = FeatureBank(obj_n=2, memory_budget=BUDGET, dtype=model.dtype,
                     device=DEV)
    eng = BatchVideoSegEngine(model, fb, batch=STREAMS,
                              downsample=DOWNSAMPLE, postprocess="device")
    check(eng.cuda_graph, "the batch engine replays graphs on the card")
    state = eng.bootstrap([clip[s] for s in range(STREAMS)],
                          [mask0] * STREAMS)
    check(state.keys.shape == (STREAMS * 2, N, DK), "folded bank")
    bank_read_cuda.reset_launches()
    cc_cuda.reset_launches()
    labels, guarded = [], 0
    f32 = model.dtype == torch.float32
    keys0 = state.keys.clone() if f32 else None     # the bootstrapped banks
    for t in range(1, steps + 1):
        frames = _stream_frames(clip, t)
        if t > 1 and not _captures_next(eng, state, frames):
            torch.cuda.set_sync_debug_mode("error")
            guarded += 1
        try:
            state, lab = eng.step(state, frames, t)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        labels.append(lab)
    torch.cuda.synchronize()
    launches = _path_launches(eng)
    want = {k: (steps if k in kernels + ("largest_cc",) else 0)
            for k in launches}
    check(launches == want, f"B=4 launched {kernels} and the CC kernel "
          f"once a step: {launches}")
    check(guarded == steps - 1 - len(eng.graphs), f"{guarded} of {steps} "
          f"steps under sync debug")
    got = np.stack([eng.fetch_labels(lab) for lab in labels], axis=1)
    check(got.shape == (STREAMS, steps) + FRAME_HW, f"labels {got.shape}")
    agree, singles, key_diffs = [], None, []
    for s in range(STREAMS):
        e1 = VideoSegEngine(model, FeatureBank(
            obj_n=2, memory_budget=BUDGET, dtype=model.dtype, device=DEV),
            downsample=DOWNSAMPLE, postprocess="device")
        st = e1.bootstrap(clip[s], mask0)
        ref, r = [], _stream_rows(s)
        if f32:
            # the bootstrapped keys differ by the convolutions' rounding
            # at batch 8 and 2; each merge after it may take another slot
            # where two slots' cosines with a feature tie within that
            # rounding, so later keys are compared, not held (PERF.md 6)
            boot = {"bootstrap_max_abs": (keys0[r] - st.keys).abs().max()
                    .item(), "bootstrap_within_1e-4": torch.allclose(
                        keys0[r], st.keys, rtol=1e-4, atol=1e-4)}
        for t in range(1, steps + 1):
            st, lab = e1.step(st, clip[(t + s) % len(clip)], t)
            ref.append(e1.fetch_label(lab))
        agree.append(float((got[s] == np.stack(ref)).mean()))
        if f32:
            check(torch.equal(state.valid[r], st.valid) and
                  torch.equal(state.occ[r], st.occ), f"stream {s}: valid "
                  f"and occ equal to the single-stream bank")
            off = ~torch.isclose(state.keys[r], st.keys, rtol=1e-4,
                                 atol=1e-4)
            key_diffs.append({
                **boot, "max_abs": (state.keys[r] - st.keys).abs().max()
                .item(), "max_key": st.keys.abs().max().item(),
                "slots_off": int(off.any(dim=-1).sum()),
                "valid_slots": int(st.valid.sum())})
        if s == 0:
            singles = (e1, st)
        else:
            del e1, st
    bar = 0.999 if gap is None else gap - 0.01
    check(min(agree) > bar if gap is None else min(agree) >= bar,
          f"every stream's labels agree with the single-stream engine's: "
          f"{agree}, bar {bar}")
    if key_diffs:
        log("batch", f"{model.dtype} B={STREAMS}: banks against the "
            f"single-stream banks, keys per stream: {key_diffs}")
    # the update alone, batched against per stream, from one bank
    nxt = _stream_frames(clip, steps + 1)
    isolation = {"live": _update_isolation(eng, state, nxt, got[:, -1],
                                           steps + 1)}
    isolation["full"] = _update_isolation(eng, state, nxt, got[:, -1],
                                          steps + 1, fill_seed=SEED + 16)
    log("batch", f"{model.dtype} B={STREAMS}: batched update against each "
        f"stream's own update on the same bank and features: {isolation}")
    window = [_stream_frames(clip, t) for t in range(steps + 1,
                                                     steps + 7)]
    e1, st1 = singles
    runs = {"single": (e1, st1, [w[0] for w in window], steps + 1),
            "batch": (eng, state, window, steps + 1)}
    timing = _timed_windows(runs, prof_kernels)
    out = {"steps": steps, "streams": STREAMS, "graphs": len(eng.graphs),
           "steps_under_sync_debug": guarded, "launches": launches,
           "agreement": agree, "bar": bar, "occ": state.occ.tolist(),
           "key_diffs": key_diffs, "update_isolation": isolation,
           "main": timing}
    msg = (f"{model.dtype} B={STREAMS}: {steps} steps, {len(eng.graphs)} "
           f"graphs, {guarded} steps under sync debug 'error' (none "
           f"raised), launches {launches}; labels vs single-stream "
           f"{['%.6f' % a for a in agree]} (bar {bar:.6f}); occ "
           f"{state.occ.tolist()}")
    if full_bank:
        for _, st, _, _ in runs.values():
            _fill_bank(st, SEED + 14)
        out["full_bank"] = _timed_windows(runs, prof_kernels)
        check(min(state.replace_n.tolist()) > 0, "eviction ran")
    for kind in ("main", "full_bank"):
        if kind in out:
            t = out[kind]
            msg += (f"; {kind}: ms a step single {t['single']['step_ms']} /"
                    f" batch {t['batch']['step_ms']}, frames/s "
                    f"{t['single']['frames_per_s']:.2f} / "
                    f"{t['batch']['frames_per_s']:.2f}, device busy "
                    f"{t['single']['busy_ms']:.3f} / "
                    f"{t['batch']['busy_ms']:.3f} ms (idle "
                    f"{t['single']['idle']:.1%} / {t['batch']['idle']:.1%}),"
                    f" kernels a step {t['single']['kernels_per_step']:.0f} "
                    f"/ {t['batch']['kernels_per_step']:.0f}, in a batch "
                    f"replay {t['batch']['kernels']}; top kernels (ms, "
                    f"launches a step) single {t['single']['top_kernels']} "
                    f"/ batch {t['batch']['top_kernels']}")
    log("batch", msg)
    del eng, state, runs, singles, e1, st1, keys0
    torch.cuda.empty_cache()
    check(all(d["bootstrap_within_1e-4"] for d in key_diffs), "every "
          "stream's bootstrapped keys within rtol 1e-4, atol 1e-4 of the "
          "single-stream bank's")
    return out, launches


def batch_cpu_phase(model):
    """12(e): the float32 batch engine at B = 2 on phase 6's 240-px clip,
    on the card against the port on the CPU: labels > 0.999."""
    clip, mask0 = synthetic_clip(5, 240, 427, SEED + 1)
    out = {}
    for dev in (DEV, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev)
        eng = BatchVideoSegEngine(m, FeatureBank(obj_n=2,
                                                 memory_budget=65_536,
                                                 device=dev),
                                  batch=2, downsample=240,
                                  postprocess="device")
        state = eng.bootstrap(clip[:2], [mask0] * 2)
        labs = []
        for t in range(1, 5):
            frames = np.stack([clip[(t + s) % len(clip)] for s in range(2)])
            state, lab = eng.step(state, frames, t)
            labs.append(eng.fetch_labels(lab))
        out[dev.type] = np.stack(labs)
    agree = float((out[DEV.type] == out["cpu"]).mean())
    log("batch", f"float32 B=2, 240x427 clip, 4 steps: card vs CPU label "
        f"agreement {agree:.6f}")
    check(agree > 0.999, "batch engine card vs CPU > 0.999")
    return {"card_vs_cpu": agree}


# ---------------------------------------------------------------------------
# 13. stop-sign detection and depth
# ---------------------------------------------------------------------------

DET_HW = (768, 1344)     # a 1080p frame at 800 / 1333, padded to /32
SCENE_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "records", "port_fixtures",
                             "stopsign_scene{}_{}.npy")


def _nms_cases():
    """name -> (boxes [N, 4], scores [N], IoU threshold, max_out, score
    threshold) on the card: the RPN's shape (negative, -inf and tied
    scores, duplicate boxes), the box head's (class offsets, thousands of
    0.0 scores and ties), an all-dead case and N < max_out."""
    rng = np.random.RandomState(SEED + 13)

    def boxes(n, w, h, size):
        xy = rng.uniform(-size / 2, [w, h], (n, 2))
        b = np.concatenate([xy, xy + rng.exponential(size, (n, 2)) + 1], 1)
        b[:, 0::2] = b[:, 0::2].clip(0, w)
        b[:, 1::2] = b[:, 1::2].clip(0, h)
        return b

    n = 4756
    b = boxes(n, DET_HW[1], DET_HW[0], 120.0)
    s = rng.randn(n)
    s[::7] = np.round(s[::7], 1)
    s[rng.rand(n) < 0.05] = -np.inf
    dup = rng.choice(n, 300, replace=False)
    b[dup[150:]], s[dup[150:]] = b[dup[:150]], s[dup[:150]]
    cases = {"rpn": (b, s, 0.7, 1000, 0.0)}
    n = 2048
    b = boxes(n, DET_HW[1], DET_HW[0], 150.0)
    cls = rng.randint(0, 80, n)
    s = np.where(rng.rand(n) < 0.4, 0.0,
                 np.round(rng.uniform(0.3, 1.0, n), 2))
    cases["box"] = (b + cls[:, None] * (DET_HW[1] + 1.0), s, 0.5, 100, 0.5)
    cases["all_dead"] = (b[:500], np.full(500, -np.inf), 0.7, 100, 0.0)
    cases["n_lt_max_out"] = (b[:37], rng.randn(37), 0.5, 100, 0.0)
    return {k: (torch.tensor(v[0], dtype=torch.float32, device=DEV),
                torch.tensor(v[1], dtype=torch.float32, device=DEV)) + v[2:]
            for k, v in cases.items()}


def _nms_pairs(boxes, scores, iou_thr, max_out, score_thr):
    """IoUs greedy NMS needs on these inputs: each pick against every box
    still alive at its step (the bound's operations)."""
    iou = nms_ops.box_iou(boxes, boxes)
    alive = scores > score_thr
    pairs = 0
    for _ in range(max_out):
        s = torch.where(alive, scores, float("-inf"))
        best = int(torch.argmax(s))
        if not math.isfinite(float(s[best])):
            break
        pairs += int(alive.sum()) - 1
        alive &= ~(iou[best] > iou_thr)
        alive[best] = False
    return pairs


def _nms_equal(name, args):
    got = nms_cuda.nms(*args)
    want = nms_ops.nms_plain(*args)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("keep_idx", "keep_scores", "valid")):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"nms {name}: the kernel's {what} equals the plain version's")
    return int(want[2].sum())


def nms_phase(captured=None, cases=None, timed=("rpn", "box")):
    """13(a): the NMS kernel against its plain version on the card, exactly
    (keep_idx, keep_scores, valid), on ``cases`` (:func:`_nms_cases`) and on
    the two calls the detector made in (b); times (median of 10, CUDA
    events) and bounds at the ``timed`` cases' shapes (the RPN's and the
    box head's)."""
    cases = dict(_nms_cases() if cases is None else cases)
    for i, args in enumerate(captured or []):
        cases[f"detector_call_{i}"] = args
    out = {}
    for name, args in cases.items():
        kept = _nms_equal(name, args)
        row = {"n": int(args[0].shape[0]), "max_out": args[3], "kept": kept}
        if name in timed:
            pairs = _nms_pairs(*args)
            n, max_out = row["n"], args[3]
            bound = _bound(20.0 * pairs, n * 20 + max_out * 13, F32_PEAK)
            row.update(
                ms=time_ms(lambda: nms_cuda.nms(*args)),
                plain_ms=time_ms(lambda: nms_ops.nms_plain(*args)),
                bound_ms=bound[0], bound_by=bound[1], iou_pairs=pairs)
        out[name] = row
        log("nms", f"{name}: {row}")
    return out


def _detector(cfg, state, dev):
    model = GeneralizedRCNN(cfg)
    model.load_state_dict(state)
    return build_detector(model.to(dev))


def _device_span_ms(prof):
    """(sum of the device events' times, the length of their union) in
    ms: the union is the time the card was busy when kernels overlap."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    total = sum(b - a for a, b in spans)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return total / 1e3, union / 1e3


STOPSIGN_STAGES = ("coarse_mask_head", "pointrend", "host_paste_and_geometry")
PEOPLE_STAGES = ("keypoint_head", None, "host_heatmaps_to_keypoints")


def _stage_ms(det, frame, host_fn, names=STOPSIGN_STAGES):
    """One image in stages, CUDA events between the device stages (ms):
    the upload and resize of the frame, backbone, FPN, RPN with its NMS,
    box inference, the tail's heads (the coarse mask head or the keypoint
    head with their ROIAlign), PointRend (a name of None: no stage), then on
    the host the download, the postprocess and ``host_fn(inst)``."""
    m = det.model
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    with torch.no_grad():
        ev[0].record()
        padded, scale = det.preprocess(frame)
        ev[1].record()
        c = m.backbone((padded - m.pixel_mean)[None].permute(0, 3, 1, 2))
        ev[2].record()
        pyr = m.fpn(c)
        ev[3].record()
        prop, _, pv = m.rpn(pyr, DET_HW)
        ev[4].record()
        feats = LevelTable([p[0].permute(1, 2, 0) for p in pyr[:4]],
                           STRIDES)
        det_out = m.infer_boxes(feats, prop, pv, DET_HW)
        ev[5].record()
        out = m.infer_tail(feats, *det_out)
        ev[6].record()
        out = m.refine(out)
        ev[7].record()
        ev[7].synchronize()
        t = time.perf_counter()
        host = {k: v.cpu().numpy() for k, v in out.items()}
        host_fn(det.postprocess(host, scale, frame.shape[:2]))
        host_ms = 1e3 * (time.perf_counter() - t)
    dev_names = ("upload_and_resize", "backbone", "fpn", "rpn_with_nms",
                 "box_inference") + names[:2]
    return {**{k: ev[i].elapsed_time(ev[i + 1])
               for i, k in enumerate(dev_names) if k},
            names[2]: host_ms}


def detector_phase(state, cfg=None, host_fn=None, stages=STOPSIGN_STAGES,
                   heads=("mask_logits", (100, 56, 56)), label="stopsign"):
    """13(b): the PointRend X-101-32x8d detector at full width
    (``stopsign_rcnn_config``: FPN P2-P6, 1,000 proposals, 80 classes, 100
    detections, the coarse head and 3 subdivisions of 784 points), seeded
    weights, float32 with TF32 off, on a seeded synthetic 1080p frame
    (750 x 1333, padded to 768 x 1344). The forward to its static outputs
    runs under sync debug "error"; the NMS kernel launches exactly twice an
    image and the plain loop never runs. Times: an image end to end
    (median of 5 after 2 warm-ups), each stage, the forward's device busy
    time and idle share (``torch.profiler``: the union of the kernels'
    spans, which overlap here, against the profiled forward's own span),
    peak memory. Returns its numbers and the detector's two NMS
    inputs. Phase 14(b) runs it with the people detector's ``cfg``, the
    people chain as ``host_fn(frame, water, instances)`` (default: the
    stop-sign one) and the keypoint head's ``stages`` and ``heads`` (the
    static head output that is checked)."""
    cfg = cfg or stopsign_rcnn_config()
    det = _detector(cfg, state, DEV)
    frames, water = synthetic_clip(1, *FRAME_HW, SEED + 13)
    frame = np.ascontiguousarray(frames[0][..., ::-1])        # BGR
    host_fn = host_fn or (lambda f, w, inst: stopsign_depth(f, inst, w))

    def chain(inst):
        return host_fn(frame, water, inst)
    padded, _ = det.preprocess(frame)
    check(tuple(padded.shape) == DET_HW + (3,), f"1080p pads to {DET_HW}")
    plain_calls = [0]
    plain = nms_ops.nms_plain

    def counting_plain(*a, **k):
        plain_calls[0] += 1
        return plain(*a, **k)

    def run_image():
        return chain(det(frame))

    nms_ops.nms_plain = counting_plain
    captured = []
    try:
        for _ in range(2):
            run_image()
        torch.cuda.synchronize()
        nms_cuda.reset_launches()
        kernel = nms_cuda.nms

        def capturing(*a):
            captured.append(tuple(x.clone() if torch.is_tensor(x) else x
                                  for x in a))
            return kernel(*a)

        nms_cuda.nms = capturing
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = det.forward(padded)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            nms_cuda.nms = kernel
        launches = nms_cuda.launches["nms"]
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            run_image()
            times.append(1e3 * (time.perf_counter() - t))
    finally:
        nms_ops.nms_plain = plain
    check(launches == 2, f"the NMS kernel launched twice an image "
          f"({launches})")
    check(plain_calls[0] == 0, "the plain NMS loop never ran on the card")
    host = {k: v.cpu().numpy() for k, v in out.items()}
    check(host["boxes"].shape == (100, 4) and
          host[heads[0]].shape == heads[1] and
          all(np.isfinite(v).all() for v in host.values()
              if v.dtype.kind == "f"), "static outputs of the expected "
          "shapes, finite")
    stages = [_stage_ms(det, frame, chain, stages) for _ in range(5)]
    stages = {k: float(np.median([s[k] for s in stages])) for k in stages[0]}
    fwd_ms = time_ms(lambda: det.forward(padded), reps=5)
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with _profile() as prof:
        ends[0].record()
        det.forward(padded)
        ends[1].record()
        torch.cuda.synchronize()
    prof_ms = ends[0].elapsed_time(ends[1])
    _, per = _busy_ms(prof, NMS_KERNELS)
    kernel_sum, busy = _device_span_ms(prof)
    torch.cuda.reset_peak_memory_stats()
    det.forward(padded)
    torch.cuda.synchronize()
    res = {"image_ms": float(np.median(times)), "image_ms_all": times,
           "forward_ms": fwd_ms, "stages_ms": stages,
           "profiled_forward_ms": prof_ms, "device_busy_ms": busy,
           "device_event_sum_ms": kernel_sum,
           "idle_share": 1.0 - busy / prof_ms,
           "nms_kernels_ms": {k: v[0] for k, v in per.items()},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "nms_launches_an_image": launches,
           "valid_detections": int(host["valid"].sum()),
           "padded_hw": list(DET_HW)}
    log(label, f"full width, seeded: {res}")
    return res, captured, launches


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def card_cpu_phase(state):
    """13(c): the full-width detector on the card against itself on the
    CPU, same seeded weights, on scene 0 (``records/port_fixtures``, 320 x
    320 -> 800 x 800) with ``score_thresh=0.0``, so that all 100 detection
    slots hold distinct boxes and the mask and PointRend heads see real
    boxes: P2-P6 within rtol 1e-4 of each map's max; the proposals (as
    many valid; >= 95 % of slots equal within 1e-3 of the image size and
    >= 97 % found among the CPU's: near-tied logits may swap); then the
    card's box half on the CPU's maps and proposals against the CPU's (>=
    95 of 100 slots the same class and box), and the card's mask heads
    and PointRend on the CPU's detections against the CPU's (coarse logits
    within 1e-4 of their scale, refined masks' signs on >= 0.999 of
    cells)."""
    cfg = dataclasses.replace(stopsign_rcnn_config(), score_thresh=0.0)
    frame = np.load(SCENE_FIXTURE.format(0, "frame"))
    dets = {"card": _detector(cfg, state, DEV),
            "cpu": _detector(cfg, state, torch.device("cpu"))}
    padded, _ = dets["cpu"].preprocess(frame)
    hw = tuple(padded.shape[:2])
    res = {"padded_hw": list(hw)}
    with torch.no_grad():
        front = {}
        for k, d in dets.items():
            x = padded.to(d.device)
            pyr = d.model.pyramid(x)
            prop, _, pv = d.model.rpn(pyr, hw)
            feats = LevelTable([p[0].permute(1, 2, 0) for p in pyr[:4]],
                               STRIDES)
            front[k] = (pyr, feats, prop, pv)
        res["pyramid_rel_err"] = [
            _rel(a.cpu(), b) for a, b in zip(front["card"][0],
                                             front["cpu"][0])]
        check(max(res["pyramid_rel_err"]) < 1e-4, "P2-P6 within 1e-4 of "
              "each map's max")
        pc, pg = front["cpu"][2].numpy(), front["card"][2].cpu().numpy()
        vc, vg = front["cpu"][3].numpy(), front["card"][3].cpu().numpy()
        tol = 1e-3 * max(hw)
        close = np.abs(pc - pg).max(axis=1) <= tol
        dist = np.abs(pg[vg][:, None] - pc[vc][None]).max(axis=-1)
        res["proposals"] = {"valid_cpu": int(vc.sum()),
                            "valid_card": int(vg.sum()),
                            "same_slot_share": float((close & (vc == vg))
                                                     .mean()),
                            "matched_share": float((dist <= tol).any(axis=1)
                                                   .mean()),
                            "max_abs": float(np.abs(pc - pg).max())}
        # the back half on the CPU's front
        _, feats_c, prop_c, pv_c = front["cpu"]
        feats_g = LevelTable([f.to(DEV) for f in feats_c.maps], STRIDES)
        box_c = dets["cpu"].model.infer_boxes(feats_c, prop_c, pv_c, hw)
        box_g = dets["card"].model.infer_boxes(feats_g, prop_c.to(DEV),
                                               pv_c.to(DEV), hw)
        bc = [t.numpy() for t in box_c]
        bg = [t.cpu().numpy() for t in box_g]
        same = (bc[2] == bg[2]) & (bc[3] == bg[3]) & \
            (np.abs(bc[0] - bg[0]).max(axis=1) <= 1e-3 * max(hw))
        res["detections"] = {
            "valid": int(bc[3].sum()), "same_slot_share": float(same.mean()),
            "max_abs_box": float(np.abs(bc[0] - bg[0]).max()),
            "max_abs_score": float(np.abs(bc[1] - bg[1]).max())}
        tail_c = dets["cpu"].model.refine(
            dets["cpu"].model.infer_tail(feats_c, *box_c))
        tail_g = dets["card"].model.infer_tail(
            feats_g, *(t.to(DEV) for t in box_c))
        coarse_g = tail_g["mask_logits"].cpu()
        tail_g = dets["card"].model.refine(tail_g)
        coarse_c = dets["cpu"].model.infer_tail(feats_c, *box_c)
        res["coarse_rel_err"] = _rel(coarse_g, coarse_c["mask_logits"])
        ref_g = tail_g["mask_logits"].cpu().numpy()
        ref_c = tail_c["mask_logits"].numpy()
        res["refined_rel_err"] = _rel(ref_g, ref_c)
        res["refined_sign_agree"] = float(((ref_g > 0) == (ref_c > 0))
                                          .mean())
    log("stopsign", f"card vs CPU, full width, score_thresh 0: {res}")
    check(res["proposals"]["valid_card"] == res["proposals"]["valid_cpu"],
          "as many valid proposals on the card as on the CPU")
    # near-tied objectness logits (float32 convolution sums in another
    # order) may swap their slots, and then their NMS picks
    check(res["proposals"]["same_slot_share"] >= 0.95 and
          res["proposals"]["matched_share"] >= 0.97, "proposals: >= 95 % "
          "of slots equal within 1e-3 of the image size, >= 97 % of the "
          "card's found among the CPU's")
    check(bc[3].sum() == 100, "100 valid detections at score_thresh 0")
    check(res["detections"]["same_slot_share"] >= 0.95, "the box half on "
          "the same input: >= 95 of 100 slots hold the same class and box")
    check(res["coarse_rel_err"] < 1e-4, "coarse mask logits within 1e-4 "
          "of scale")
    check(res["refined_sign_agree"] >= 0.999, "refined masks agree on >= "
          "0.999 of cells")
    return res


def _octagon_case():
    """A stop sign drawn in numpy under a known homography (scaled 1.6,
    moved to (700, 150), a mild perspective) over water below row 620 of
    a 1080p frame: (image, Instances, water mask, the expected ratio)."""
    plate, top, bottom = make_stopsign_template()
    h = np.array([[1.6, 0.05, 700.0], [0.02, 1.6, 150.0], [0.0, 1e-5, 1.0]])
    poly = perspective_transform(plate, h)
    mask = np.zeros(FRAME_HW, np.uint8)
    _fill_convex(mask, [(int(round(x * (1 << XY_SHIFT))),
                         int(round(y * (1 << XY_SHIFT)))) for x, y in poly],
                 np.uint8(1))
    water = np.zeros(FRAME_HW, np.uint8)
    water[620:] = 1
    p_top, p_bot = perspective_transform(np.stack([top, bottom]), h)
    expected = (p_bot[1] - 620) / (p_bot[1] - p_top[1])
    inst = Instances(boxes=np.zeros((1, 4), np.float32),
                     scores=np.ones(1, np.float32),
                     classes=np.array([11], np.int32), masks=mask[None])
    img = np.full(FRAME_HW + (3,), 128, np.uint8)
    return img, inst, water, float(expected)


def chain_phase(state):
    """13(d): the per-image stop-sign function on the card's machine (no
    cv2, no PIL): both scene fixtures through the full-width detector on
    the card and on the CPU, equal rows; then an octagon drawn under a
    known homography through fit_octagon, the homography and the pole
    march: its ratio within 0.02 of the geometric one."""
    cfg = stopsign_rcnn_config()
    dets = {"card": _detector(cfg, state, DEV),
            "cpu": _detector(cfg, state, torch.device("cpu"))}
    rows = {}
    for i in (0, 1):
        frame = np.load(SCENE_FIXTURE.format(i, "frame"))
        water = np.load(SCENE_FIXTURE.format(i, "mask"))
        for k, d in dets.items():
            ratio, depth, _ = stopsign_depth(frame, d(frame), water)
            rows.setdefault(f"scene{i}", {})[k] = [round(ratio, 4),
                                                   round(depth, 4)]
        check(rows[f"scene{i}"]["card"] == rows[f"scene{i}"]["cpu"],
              f"scene {i}: card and CPU rows are equal")
    img, inst, water, expected = _octagon_case()
    ratio, depth, canvases = stopsign_depth(img, inst, water)
    res = {"rows": rows, "octagon": {"ratio": ratio, "depth_cm": depth,
                                     "expected_ratio": expected}}
    log("stopsign", f"chain without cv2: {res}")
    check(canvases is not None and abs(ratio - expected) < 0.02,
          "the drawn octagon's ratio is the geometric one within 0.02")
    return res


def stopsign_phase():
    """Phase 13: (b) the detector at full width (which also gives the NMS
    kernel's launches and the detector's two NMS inputs), (a) the kernel
    against its plain version, (c) card against CPU, (d) the chain."""
    model = seeded_init(GeneralizedRCNN(stopsign_rcnn_config()), SEED)
    state = model.state_dict()
    res, captured, launches = detector_phase(state)
    res["nms"] = nms_phase(captured)
    res["card_vs_cpu"] = card_cpu_phase(state)
    res["chain"] = chain_phase(state)
    return res, launches


def nms_row(stop, launches, build, people, launches_people):
    """The NMS kernel's row: times at the RPN's shape, the box head's
    beside them, and the people detector's (phase 14): its launches an
    image, its two calls' shapes and the one-class box head's times."""
    rpn, box = stop["nms"]["rpn"], stop["nms"]["box"]
    one = people["nms"]["box_one_class"]
    return {
        "name": "nms", "route": "cuda",
        "source": "vfloodnet_tpu_torch/csrc/nms.cu",
        "replaces": "vfloodnet_tpu/ops/nms.py:30",
        "replaces_kind": "an XLA fori_loop, not a Pallas kernel",
        "launches": launches, "max_abs_err": 0.0,
        "ms": rpn["ms"], "plain_ms": rpn["plain_ms"],
        "bound_ms": rpn["bound_ms"], "bound_by": rpn["bound_by"],
        "library_ms": None, "shape": {"n": rpn["n"],
                                      "max_out": rpn["max_out"]},
        "box_head": {k: box[k] for k in ("n", "max_out", "ms", "plain_ms",
                                         "bound_ms", "bound_by")},
        "people": {
            "launches_an_image": launches_people,
            "calls": [{k: v[k] for k in ("n", "max_out", "kept")}
                      for name, v in people["nms"].items()
                      if name.startswith("detector_call")],
            "box_one_class": {k: one[k] for k in (
                "n", "max_out", "ms", "plain_ms", "bound_ms", "bound_by")}},
        "build": {k: build[k] for k in NMS_KERNELS}}


# ---------------------------------------------------------------------------
# 14. people detection and depth
# ---------------------------------------------------------------------------

PEOPLE_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "records", "port_fixtures",
                              "people_scene{}_{}.npy")


def _nms_one_class_case():
    """The one-class box head's NMS input: min(2048, 1,000 x 1) = 1,000
    candidates (15 chunks of 64 and a ragged one), IoU 0.5, 100 kept,
    score > 0.7; 40 % zero scores, two-decimal ties, 100 duplicates."""
    rng = np.random.RandomState(SEED + 14)
    n = 1000
    xy = rng.uniform(-75, [DET_HW[1], DET_HW[0]], (n, 2))
    b = np.concatenate([xy, xy + rng.exponential(150.0, (n, 2)) + 1], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, DET_HW[1])
    b[:, 1::2] = b[:, 1::2].clip(0, DET_HW[0])
    s = np.where(rng.rand(n) < 0.4, 0.0,
                 np.round(rng.uniform(0.3, 1.0, n), 2))
    b[900:], s[900:] = b[:100], s[:100]
    return {"box_one_class": (
        torch.tensor(b, dtype=torch.float32, device=DEV),
        torch.tensor(s, dtype=torch.float32, device=DEV), 0.5, 100, 0.7)}


def people_card_cpu_phase(state):
    """14(c): the full-width Keypoint R-CNN on the card against itself on
    the CPU, same seeded weights, on people scene 0 (320 x 320 -> 800 x
    800) with ``score_thresh=0.0``, so that all 100 detection slots hold
    distinct boxes: P2-P6 within 1e-4 of each map's max; the card's box
    half on the CPU's maps and proposals against the CPU's (>= 95 of 100
    slots the same box); the card's keypoint head on the CPU's detections
    against the CPU's: heatmaps within 1e-4 of their scale, and each
    keypoint's cell (the heatmap's argmax) equal wherever its top two
    values differ by more than 1e-4 of that scale."""
    cfg = dataclasses.replace(keypoint_rcnn_config(), score_thresh=0.0)
    frame = np.load(PEOPLE_FIXTURE.format(0, "frame"))
    dets = {"card": _detector(cfg, state, DEV),
            "cpu": _detector(cfg, state, torch.device("cpu"))}
    padded, _ = dets["cpu"].preprocess(frame)
    hw = tuple(padded.shape[:2])
    res = {"padded_hw": list(hw)}
    with torch.no_grad():
        pyr_g = dets["card"].model.pyramid(padded.to(DEV))
        feats_c, prop_c, pv_c = dets["cpu"].model.infer_front(padded)
        pyr_c = dets["cpu"].model.pyramid(padded)
        res["pyramid_rel_err"] = [_rel(a.cpu(), b)
                                  for a, b in zip(pyr_g, pyr_c)]
        feats_g = LevelTable([f.to(DEV) for f in feats_c.maps], STRIDES)
        box_c = dets["cpu"].model.infer_boxes(feats_c, prop_c, pv_c, hw)
        box_g = dets["card"].model.infer_boxes(feats_g, prop_c.to(DEV),
                                               pv_c.to(DEV), hw)
        bc = [t.numpy() for t in box_c]
        bg = [t.cpu().numpy() for t in box_g]
        same = (bc[3] == bg[3]) & \
            (np.abs(bc[0] - bg[0]).max(axis=1) <= 1e-3 * max(hw))
        heat_c = dets["cpu"].model.infer_tail(
            feats_c, *box_c)["keypoint_heatmaps"].numpy()
        heat_g = dets["card"].model.infer_tail(
            feats_g, *(t.to(DEV) for t in box_c))["keypoint_heatmaps"]
        heat_g = heat_g.cpu().numpy()
    d, side, _, k = heat_c.shape
    flat_c = heat_c.reshape(d, side * side, k)
    flat_g = heat_g.reshape(d, side * side, k)
    top2 = np.sort(flat_c, axis=1)[:, -2:]
    scale = float(np.abs(heat_c).max())
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4 * scale
    equal = flat_c.argmax(axis=1) == flat_g.argmax(axis=1)
    res.update({
        "detections": {"valid": int(bc[3].sum()),
                       "same_slot_share": float(same.mean()),
                       "max_abs_box": float(np.abs(bc[0] - bg[0]).max())},
        "heatmap_rel_err": _rel(heat_g, heat_c),
        "keypoints_clear": int(clear.sum()),
        "keypoints_clear_equal": int((equal & clear).sum()),
        "keypoints_equal_all": int(equal.sum()),
        "keypoints": int(equal.size)})
    log("people", f"card vs CPU, full width, score_thresh 0: {res}")
    check(max(res["pyramid_rel_err"]) < 1e-4, "P2-P6 within 1e-4 of each "
          "map's max")
    check(bc[3].sum() == 100, "100 valid detections at score_thresh 0")
    check(res["detections"]["same_slot_share"] >= 0.95, "the box half on "
          "the same input: >= 95 of 100 slots hold the same box")
    check(res["heatmap_rel_err"] < 1e-4, "heatmaps within 1e-4 of scale")
    check(res["keypoints_clear_equal"] == res["keypoints_clear"] > 0,
          "keypoint cells equal wherever the top two heatmap values differ "
          "by more than 1e-4 of scale")
    return res


def regressor_phase(cpu_regs, card_regs):
    """14(d): both body-mesh regressors at full width (the bundled
    ``BodyMeshRegressor`` configuration and ``METRONetwork`` with
    HRNet-W64, 1024/256/128, 4 layers, 4 heads, MLP 3,072), seeded, a batch
    of 4 seeded 224 x 224 crops on the card against the CPU: projected
    vertices within 1e-4 in [-1, 1] units. Times: ms a crop at batch 1 and
    4, uint8 crops in and vertices out (card: median of 5, CUDA events;
    CPU: one call after the comparison's)."""
    crops = (np.random.RandomState(SEED + 14).rand(4, 224, 224, 3)
             * 255).astype(np.uint8)
    out = {}
    for name, card in card_regs.items():
        cpu = cpu_regs[name]
        got, want = card(crops), cpu(crops)
        row = {"max_abs_err": float(np.abs(got - want).max()),
               "spread": float(want.std(axis=1).mean()),
               "params_m": sum(p.numel() for p in card.model.parameters())
               / 1e6}
        for b in (1, 4):
            row[f"card_ms_a_crop_b{b}"] = time_ms(
                lambda: card(crops[:b]), reps=5) / b
            t = time.perf_counter()
            cpu(crops[:b])
            row[f"cpu_ms_a_crop_b{b}"] = 1e3 * (time.perf_counter() - t) / b
        log("people", f"{name}, full width, seeded: {row}")
        check(got.shape == (4, 431, 2) and np.isfinite(got).all(),
              f"{name}: [4, 431, 2] finite vertices")
        check(row["max_abs_err"] <= 1e-4, f"{name}: card and CPU vertices "
              "within 1e-4")
        out[name] = row
    return out


def people_chain_phase(cpu_regs, card_regs, template):
    """14(e): the per-image people function on the card's machine (no cv2,
    no PIL) on both people fixtures (``records/port_fixtures``), with the
    trained tiny detector's boxes and scores that the JAX package finds
    there (seeded detectors find no person at 0.9) and each seeded
    regressor, on the card and on the CPU: equal rows."""
    rows = {}
    for i in (0, 1):
        frame = np.load(PEOPLE_FIXTURE.format(i, "frame"))
        water = np.load(PEOPLE_FIXTURE.format(i, "mask"))
        det = np.load(PEOPLE_FIXTURE.format(i, "det"))
        inst = Instances(boxes=det[:, :4], scores=det[:, 4],
                         classes=np.zeros(len(det), np.int32))
        for name in card_regs:
            got = {}
            for where, regs in (("card", card_regs), ("cpu", cpu_regs)):
                ratio, depth, canvases = people_depth(
                    frame, inst, water, regs[name], template)
                got[where] = [None if v is None else round(float(v), 4)
                              for v in (ratio, depth)]
                check(canvases is not None, "a person scores >= 0.9")
            rows.setdefault(f"scene{i}", {})[name] = got
            check(got["card"] == got["cpu"], f"scene {i}, {name}: card and "
                  "CPU rows are equal")
    res = {"rows": rows, "image_libraries": sorted(
        m for m in ("cv2", "PIL") if m in sys.modules)}
    log("people", f"chain without cv2: {res}")
    check(not res["image_libraries"], "the chain imported no cv2 or PIL")
    return res


def people_phase():
    """Phase 14: (b) the Keypoint R-CNN R-101 at full width (its two NMS
    inputs and launches), (a) the NMS kernel at the one-class box head's
    shape and on those inputs, (c) card against CPU, (d) both body-mesh
    regressors, (e) the chain."""
    cfg = keypoint_rcnn_config()
    state = seeded_init(GeneralizedRCNN(cfg), SEED).state_dict()
    cpu_regs = {"bodymesh": MeshRegressor(mesh_seeded_init(
                    BodyMeshRegressor(), SEED)),
                "metro_hrnet_w64": MeshRegressor(mesh_seeded_init(
                    METRONetwork(), SEED))}
    card_regs = {k: MeshRegressor(copy.deepcopy(r.model).to(DEV))
                 for k, r in cpu_regs.items()}
    template = load_template_3d()

    def chain(frame, water, inst):
        return people_depth(frame, inst, water, card_regs["bodymesh"],
                            template)

    res, captured, launches = detector_phase(
        state, cfg, chain, PEOPLE_STAGES,
        ("keypoint_heatmaps", (100, 56, 56, 17)), "people")
    res["keypoint_head_share"] = (res["stages_ms"]["keypoint_head"]
                                  / res["forward_ms"])
    res["nms"] = nms_phase(captured, _nms_one_class_case(),
                           ("box_one_class",))
    res["card_vs_cpu"] = people_card_cpu_phase(state)
    res["regressors"] = regressor_phase(cpu_regs, card_regs)
    res["chain"] = people_chain_phase(cpu_regs, card_regs, template)
    return res, launches


TRAIN_LR = 1e-5          # the trainer CLI's default (train_video_seg.py)
DEMO_LR = 1e-4           # scripts/train_demo_checkpoints.py's video rate


def training_clips(n, clip_n, obj_n, size, seed):
    """``n`` seeded pseudo-video clips as the trainer takes them: frames
    [n, clip_n, S, S, 3] float32 in [0, 1] and one-hot masks [n, clip_n,
    obj_n, S, S]: a sky over water below a wavy waterline that moves from
    frame to frame, with ``obj_n`` 3 a drifting boat (label 2) on it; a
    ripple and noise on top. The card's machine has no image decoder."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float32) / size
    frames = np.zeros((n, clip_n, size, size, 3), np.float32)
    masks = np.zeros((n, clip_n, obj_n, size, size), np.float32)
    for i in range(n):
        sky, sea, boat = (rng.uniform(lo, hi, 3) for lo, hi in
                          ((0.5, 0.9), (0.1, 0.4), (0.6, 1.0)))
        phase, level = rng.uniform(0, 6), rng.uniform(0.45, 0.6)
        cx, cy = rng.uniform(0.3, 0.7), level + 0.15
        for t in range(clip_n):
            d = 0.02 * t
            label = (yy + 0.05 * np.sin(9 * xx + phase + d)
                     > level + 0.3 * d).astype(np.int64)
            if obj_n > 2:
                label[(xx - cx - d) ** 2 + (yy - cy) ** 2 < 0.01] = 2
            img = np.stack([sky, sea, boat])[label]
            img = img + 0.08 * np.sin(40 * xx + 13 * yy + d)[..., None] \
                * (label > 0)[..., None]
            frames[i, t] = np.clip(img + 0.03 * rng.standard_normal(
                img.shape), 0, 1)
            masks[i, t] = np.eye(obj_n, dtype=np.float32)[label].transpose(
                2, 0, 1)
    return frames, masks


def wavy_clip(size, seed=0):
    """One seeded clip of 3 frames and 2 objects, as the trainer takes it:
    a sky over a wavy waterline that rises from frame to frame, noise on
    top; its loss sits at 1.5 where the scene clips' start near 5."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    frames = np.zeros((1, 3, size, size, 3), np.float32)
    masks = np.zeros((1, 3, 2, size, size), np.float32)
    for t in range(3):
        water = yy + 0.05 * np.sin(9 * xx + t) > 0.5 + 0.02 * t
        img = np.where(water[..., None], [0.2, 0.3, 0.4], [0.8, 0.8, 0.9])
        frames[0, t] = np.clip(img + 0.03 * rng.standard_normal(img.shape),
                               0, 1)
        masks[0, t, 1], masks[0, t, 0] = water, ~water
    return frames, masks


# phase 15(b)'s clips, 240 px, 3 frames, 2 objects
CARD_CPU_CLIPS = {
    "wavy": lambda: wavy_clip(240),
    "scene": lambda: training_clips(1, 3, 2, 240, SEED + 16),
}


def training_form(variables, dev, dtype=torch.float32):
    """The training form of the AFB-URR with ``variables``, computing in
    ``dtype`` (float32, or float64 for a reference)."""
    model = AFBURR(trainable_bn=True, dtype=dtype)
    model.load_state_dict(convert_afb_urr_variables(variables,
                                                    trainable_bn=True))
    return model.to(dev, dtype)


def _train_cfg(**kw):
    return VideoTrainConfig(**{"lr": TRAIN_LR, **kw})


def timed_steps(step, inputs, warm=2, last=None):
    """Run ``step(*x)`` for each ``x`` of ``inputs`` (an iterable of tuples
    of tensors on the card, made outside the timed span): (median ms of
    the steps after the first ``warm`` and up to ``last``, CUDA events
    around each step; peak memory allocated over all of them, bytes,
    counting what earlier phases left allocated; every step's output)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, outs = [], []
    for x in inputs:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = step(*x)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        outs.append(out)
    return (float(np.median(times[warm:last])),
            int(torch.cuda.max_memory_allocated()), outs)


def _timed_train_steps(model, cfg, frames, masks, steps=7, warm=2):
    """(median ms a step over ``steps - warm`` steps after ``warm``, CUDA
    events; peak memory allocated over all of them, bytes, counting what
    earlier phases left allocated; every step's loss)."""
    opt = init_video_train_state(model, cfg)
    step = make_video_train_step(model, opt, cfg)
    x = (torch.from_numpy(frames).to(DEV), torch.from_numpy(masks).to(DEV))
    ms, peak, outs = timed_steps(step, [x] * steps, warm)
    losses = [loss.item() for loss in outs]
    check(all(np.isfinite(losses)), f"finite training losses {losses}")
    return ms, peak, losses


def train_recipe_phase(variables):
    """15(a): the reference recipe at full width (400 x 400, clip_n 6,
    obj_n 3, lr 1e-5, lambda_u 0.5, frozen BN) from the trained weights, at
    batch 1 and 4, each also with ``remat`` (each clip recomputed in the
    backward pass), whose losses must equal the plain step's and whose
    peak memory must be lower at batch 4, where one clip's activations
    are held at a time instead of four."""
    out = {}
    for name, batch, remat in (("batch1", 1, False), ("batch4", 4, False),
                               ("batch1_remat", 1, True),
                               ("batch4_remat", 4, True)):
        cfg = _train_cfg(remat=remat)
        frames, masks = training_clips(batch, cfg.clip_n, cfg.max_obj_n,
                                       cfg.output_size, SEED + 15)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()     # earlier phases' leftovers
        model = training_form(variables, DEV)
        ms, peak, losses = _timed_train_steps(model, cfg, frames, masks)
        peak -= base                 # model, optimiser, gradients, steps
        out[name] = {"ms_step": ms, "peak_gb": peak / 1e9,
                     "losses": losses}
        log("train", f"{name}: {ms:.2f} ms a step (median of 5 after 2), "
            f"peak {peak / 1e9:.3f} GB, losses {losses[0]:.5f} -> "
            f"{losses[-1]:.5f}")
        del model
        torch.cuda.empty_cache()
    for b in ("batch1", "batch4"):
        check(out[b + "_remat"]["losses"] == out[b]["losses"],
              f"{b}: remat gives the plain step's losses")
    check(out["batch4_remat"]["peak_gb"] < out["batch4"]["peak_gb"],
          "remat lowers the peak memory at batch 4")
    return out


def train_grads(variables, dev, frames, masks, dtype=torch.float32):
    """One training step (frozen BN, lr 1e-5) of the trained weights on
    ``dev`` in ``dtype`` -> (loss, gradients by name in float64 on the
    CPU)."""
    cfg = _train_cfg(clip_n=frames.shape[1], max_obj_n=masks.shape[2],
                     output_size=frames.shape[2])
    model = training_form(variables, dev, dtype)
    step = make_video_train_step(model, init_video_train_state(model, cfg),
                                 cfg)
    loss = step(torch.from_numpy(frames).to(dev, dtype),
                torch.from_numpy(masks).to(dev, dtype)).item()
    return loss, {n: p.grad.double().cpu()
                  for n, p in model.named_parameters()}


def compare_steps(got, want, floor=0.0):
    """How far the step ``got`` is from ``want`` (two results of
    :func:`train_grads`): the loss and the gradients' global norm
    relative, and the largest gap of a gradient leaf over that leaf's
    largest magnitude (and its name). ``floor`` > 0 floors a leaf's scale
    at that share of the largest leaf: a leaf whose gradient vanishes (a
    bias feeding a live BatchNorm) is rounding noise on either device."""
    (lg, gg), (lw, gw) = got, want
    norm_g = torch.stack([g.norm() for g in gg.values()]).norm().item()
    norm_w = torch.stack([g.norm() for g in gw.values()]).norm().item()
    top = max(g.abs().max().item() for g in gw.values())
    leaf = {n: ((gg[n] - g).abs().max()
                / max(g.abs().max().item(), floor * top)).item()
            for n, g in gw.items() if g.abs().max() > 0}
    worst = max(leaf, key=leaf.get)
    return {"loss": lg, "loss_ref": lw, "loss_rel": abs(lg - lw) / abs(lw),
            "grad_norm": norm_g, "grad_norm_ref": norm_w,
            "grad_norm_rel": abs(norm_g - norm_w) / norm_w,
            "leaf_rel": leaf[worst], "leaf": worst}


def train_card_cpu_phase(variables, clips=tuple(CARD_CPU_CLIPS)):
    """15(b): one step of the trained weights on each clip, card against
    CPU, in float64 and in float32.

    In float64 the two must agree as far as the port's code goes: losses
    within 1e-9 relative, every gradient leaf within 1e-6 of its largest
    magnitude (on the H100, 5.6e-14 and 9.0e-11 at worst over 8 seeded
    clips, ``scripts/torch_train_card_cpu.py``). In float32 each device
    strays from the float64 step by its own rounding, which the trained
    decoder's log-odds (up to |1458|) amplify: over those 8 clips the
    CPU's float32 loss strays up to 1.2e-5 relative and its gradients'
    global norm up to 5.7e-4, the card's (cuDNN) up to 2.5e-5 and
    4.2e-4, and the two float32 steps differ by up to 2.5e-5 and 2.5e-4.
    So the float32 bounds are twice those card-against-CPU readings:
    losses within 5e-5 relative, the gradients' global norms within 5e-4.
    A float32 gradient leaf strays up to 13 % of its scale from float64
    on either device, so leaves are held only in float64. Parameter
    changes are not compared: a first AdamW step moves each parameter by
    lr times the sign of its gradient, so two steps differ by 2 lr
    wherever a sign does, however close their gradients. The CPU's
    float32 step is also compared with its float64 one, and the card's
    with the CPU's float64, for the record."""
    out = {}
    for name in clips:
        frames, masks = CARD_CPU_CLIPS[name]()
        card32, cpu32, card64, cpu64 = (
            train_grads(variables, dev, frames, masks, dtype)
            for dev, dtype in ((DEV, torch.float32),
                               (torch.device("cpu"), torch.float32),
                               (DEV, torch.float64),
                               (torch.device("cpu"), torch.float64)))
        res = out[name] = {"float32": compare_steps(card32, cpu32),
                           "float64": compare_steps(card64, cpu64),
                           "cpu_float32_vs_float64":
                               compare_steps(cpu32, cpu64),
                           "card_float32_vs_cpu_float64":
                               compare_steps(card32, cpu64)}
        f32, f64 = res["float32"], res["float64"]
        own, card = (res["cpu_float32_vs_float64"],
                     res["card_float32_vs_cpu_float64"])
        log("train", f"card vs CPU, clip {name}, 240 px: float64 loss rel "
            f"{f64['loss_rel']:.2e}, leaf gap {f64['leaf_rel']:.2e} of "
            f"scale ({f64['leaf']}); float32 loss {f32['loss']:.7f} / "
            f"{f32['loss_ref']:.7f} (rel {f32['loss_rel']:.2e}), grad norm "
            f"{f32['grad_norm']:.6f} / {f32['grad_norm_ref']:.6f} (rel "
            f"{f32['grad_norm_rel']:.2e}), leaf gap {f32['leaf_rel']:.2e}; "
            f"off the CPU's float64, the CPU's float32 loss {own['loss_rel']:.2e}"
            f" and grad norm {own['grad_norm_rel']:.2e}, the card's "
            f"{card['loss_rel']:.2e} and {card['grad_norm_rel']:.2e}")
        check(f64["loss_rel"] <= 1e-9,
              f"clip {name}: float64 card and CPU losses within 1e-9")
        check(f64["leaf_rel"] <= 1e-6, f"clip {name}: in float64 every "
              f"gradient leaf within 1e-6 of its scale")
        check(f32["loss_rel"] <= 5e-5,
              f"clip {name}: float32 card and CPU losses within 5e-5")
        check(f32["grad_norm_rel"] <= 5e-4,
              f"clip {name}: float32 gradient norms within 5e-4")
    return out


class _ClipSet:
    """Four seeded 240-px clips of 4 frames and 2 objects; sample ``idx``
    of epoch ``e`` is a pure function of (e, idx)."""

    def __len__(self):
        return 4

    def get(self, idx, epoch=0):
        frames, masks = training_clips(1, 4, 2, 240,
                                       SEED + 1000 * epoch + idx)
        return frames[0], masks[0], 2


def _epoch_losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f)
                if r["event"] == "epoch"]


def train_loop_phase(variables):
    """15(c): ``run_video_training`` on the card, the demo recipe (240 px,
    clip_n 4, obj_n 2, lr 1e-4, live BN) over 4 seeded clips: 3 epochs
    straight, and 2 epochs then a third resumed from ``final.pt``, which
    must end equal; then ``best.npz`` through ``load_afb_urr`` segments a
    frame on the graph engine."""
    cfg = dict(clip_n=4, max_obj_n=2, output_size=240, update_bn=True,
               lr=DEMO_LR, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        whole, part = os.path.join(tmp, "whole"), os.path.join(tmp, "part")
        t0 = time.perf_counter()
        run_video_training(training_form(variables, DEV),
                           VideoTrainConfig(epochs=3, **cfg), _ClipSet(),
                           whole, log_every=4)
        dt = time.perf_counter() - t0
        run_video_training(training_form(variables, DEV),
                           VideoTrainConfig(epochs=2, **cfg), _ClipSet(),
                           part, log_every=4)
        for name in ("final.pt", "best.pt", "best.npz", "metrics.jsonl"):
            check(os.path.exists(os.path.join(part, name)),
                  f"the loop wrote {name}")
        run_video_training(training_form(variables, DEV),
                           VideoTrainConfig(epochs=3, **cfg), _ClipSet(),
                           part, log_every=4,
                           resume=os.path.join(part, "final.pt"))
        a = torch.load(os.path.join(whole, "final.pt"), weights_only=True)
        b = torch.load(os.path.join(part, "final.pt"), weights_only=True)
        losses = _epoch_losses(whole)
        check(_epoch_losses(part) == losses and a["step"] == b["step"] == 12,
              "resumed epoch losses and step equal the straight run's")
        check(all(torch.equal(v, b["model"][k]) for k, v in
                  a["model"].items()), "resumed weights and statistics "
              "equal the straight run's")
        check(all(torch.equal(v, b["optimizer"][part_][k])
                  for part_ in ("mu", "nu")
                  for k, v in a["optimizer"][part_].items()),
              "resumed optimiser state equals the straight run's")
        model = load_afb_urr(os.path.join(whole, "best.npz"), device=DEV)
        clip, mask0 = synthetic_clip(2, 240, 427, SEED + 17)
        eng = VideoSegEngine(model, FeatureBank(obj_n=2, memory_budget=65_536,
                                                device=DEV),
                             downsample=240, postprocess="device")
        state = eng.bootstrap(clip[0], mask0)
        state, label = eng.step(state, clip[1], 1)
        label = eng.fetch_label(label)
        check(label.shape == clip[1].shape[:2] and label.max() <= 1,
              "best.npz segments a frame on the graph engine")
    log("train", f"loop: 3 epochs of 4 steps in {dt:.1f} s (checkpoints "
        f"included), epoch losses {[round(x, 5) for x in losses]}; resumed "
        f"run equal; best.npz segments ({label.mean():.3f} water)")
    return {"epoch_losses": losses, "seconds_3_epochs": dt,
            "resume_equal": True, "segment_water_share": float(label.mean())}


def train_repeat_phase(variables, steps=30):
    """15(d): 30 steps on one repeated 240-px clip (lr 1e-4, frozen BN):
    the last loss below the first."""
    cfg = _train_cfg(clip_n=3, max_obj_n=2, output_size=240, lr=DEMO_LR)
    frames, masks = training_clips(1, 3, 2, 240, SEED + 18)
    model = training_form(variables, DEV)
    _, _, losses = _timed_train_steps(model, cfg, frames, masks, steps=steps,
                                      warm=0)
    log("train", f"repeated clip: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
        f"in {steps} steps")
    check(losses[-1] < losses[0], "the loss falls on a repeated clip")
    return {"first": losses[0], "last": losses[-1], "steps": steps}


def train_phase():
    """Phase 15: AFB-URR training on the card in float32, and in float64
    for (b)'s reference (TF32 off, cuDNN deterministic, as the trainer CLI
    sets it): (a), (b) and (d) may launch
    none of the port's kernels (the training read is the plain dense
    read); (c) ends with the serving engine, which does."""
    variables = load_flat_npz(default_checkpoint("video"))
    for counter in (bank_read_cuda, cc_cuda, nms_cuda):
        counter.reset_launches()
    torch.backends.cudnn.deterministic = True
    try:
        res = {"recipe": train_recipe_phase(variables),
               "card_vs_cpu": train_card_cpu_phase(variables),
               "repeat": train_repeat_phase(variables)}
        launched = {**bank_read_cuda.launches, **cc_cuda.launches,
                    **nms_cuda.launches}
        check(not any(launched.values()),
              f"the training steps launched none of the port's kernels: "
              f"{launched}")
        res["loop"] = train_loop_phase(variables)
    finally:
        torch.backends.cudnn.deterministic = False
    return res


# --------------------------------------------------------------------------
# Phase 16: the image, detection and body-mesh trainers
# --------------------------------------------------------------------------

# The float32 card-against-CPU bounds of one step of each trainer, (loss
# relative, gradients' global norm relative): twice the largest gaps that
# scripts/torch_trainers_card_cpu.py read over 8 seeds on the H100
# (PERF.md: image 5.24e-7 and 2.77e-6, detection 2.32e-7
# and 3.61e-5, body mesh 2.40e-5 and 3.44e-4).
TRAINER_F32_BOUNDS = {"image": (1.1e-6, 5.6e-6),
                      "detection": (4.7e-7, 7.3e-5),
                      "bodymesh": (4.8e-5, 6.9e-4)}
NOISE_FLOOR = 1e-9       # of the largest leaf: a vanishing leaf's scale


def image_batch(n, size, seed):
    """``n`` seeded stills as the image trainer takes them: images [n, S,
    S, 3] float32 in [0, 1], a sky over water below a wavy waterline with
    a ripple and noise, and their water masks [n, S, S]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float32) / size
    images = np.zeros((n, size, size, 3), np.float32)
    masks = np.zeros((n, size, size), np.float32)
    for i in range(n):
        sky, sea = rng.uniform(0.5, 0.9, 3), rng.uniform(0.1, 0.4, 3)
        phase, level = rng.uniform(0, 6), rng.uniform(0.4, 0.65)
        water = yy + 0.05 * np.sin(9 * xx + phase) > level
        img = np.where(water[..., None], sea, sky) + 0.08 * np.sin(
            40 * xx + 13 * yy)[..., None] * water[..., None]
        images[i] = np.clip(img + 0.03 * rng.standard_normal(img.shape),
                            0, 1)
        masks[i] = water
    return images, masks


def image_training_form(variables, dev, dtype=torch.float32):
    """The LinkNet training form with ``variables`` in ``dtype``."""
    model = LinkNet(dtype=dtype, norm=TrainBN)
    model.load_state_dict(convert_linknet_variables(variables,
                                                    trainable_bn=True))
    return model.to(dev, dtype)


def _grads(model):
    return {n: p.grad.double().cpu() for n, p in model.named_parameters()}


def image_grads(variables, dev, dtype, images, masks):
    """One image-trainer step (frozen BN, lr 1e-4) of ``variables`` on
    ``dev`` in ``dtype`` -> (loss, gradients by name)."""
    model = image_training_form(variables, dev, dtype)
    cfg = timg.ImageTrainConfig()
    step = timg.make_image_train_step(
        model, timg.init_image_train_state(model, cfg))
    loss, _ = step(torch.from_numpy(images).to(dev, dtype),
                   torch.from_numpy(masks).to(dev, dtype))
    return loss.item(), _grads(model)


DET_CARD_CPU = dict(image_size=96, keypoint_rois=4)


def detection_grads(dev, dtype, seed):
    """One detection-trainer step of the seeded tiny people detector (masks
    and keypoints) at 96 px on people scene ``seed`` on ``dev`` in
    ``dtype`` -> (loss, gradients by name); the random proposals are the
    trainer's own (drawn on the CPU)."""
    tc = tdet.DetectionTrainConfig(**DET_CARD_CPU)
    model = seeded_init(GeneralizedRCNN(tdet.tiny_people_config(96),
                                        trainable_bn=True), SEED)
    model = model.to(dev, dtype)
    step = tdet.make_detection_train_step(
        model, tdet.init_detection_train_state(model, tc), tc)
    sample = SyntheticPeopleDataset(n=seed + 1, size=96).get(seed)
    x = [a.to(dtype) if a.is_floating_point() else a
         for a in tdet.to_device(sample, dev)]
    loss, _ = step(*x)
    return loss.item(), _grads(model)


def bodymesh_grads(dev, dtype, seed):
    """One body-mesh step (live BN, one crop) of the seeded regressor on
    the training sample ``(13, seed)`` on ``dev`` in ``dtype`` -> (loss,
    gradients by name)."""
    ref = tbm.init_body_mesh(1, "cpu")
    model = BodyMeshRegressor(trainable_bn=True, dtype=dtype)
    model.load_state_dict(ref.state_dict())
    model = model.to(dev, dtype)
    step = tbm.make_bodymesh_train_step(
        model, tbm.init_bodymesh_train_state(model, tbm.BodyMeshTrainConfig()))
    crop, target = tbm.make_training_sample(
        np.random.default_rng(np.random.SeedSequence([13, seed])),
        load_template_3d(None))
    loss = step(torch.from_numpy(crop).to(dev, dtype),
                torch.from_numpy(target).to(dev, dtype))
    return loss.item(), _grads(model)


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block, as the image
    trainer's CLI runs (its resume is exact) and as the float32 bounds
    were read."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def trainer_card_cpu(name, grads_fn):
    """One step of a trainer on the card (cuDNN deterministic) and on the
    CPU, in float64 (the losses within 1e-9 relative, every gradient leaf
    within 1e-6 of its scale) and in float32 (within
    :data:`TRAINER_F32_BOUNDS`, the gaps printed)."""
    with cudnn_deterministic():
        card32, cpu32, card64, cpu64 = (
            grads_fn(dev, dtype) for dev, dtype in (
                (DEV, torch.float32), (torch.device("cpu"), torch.float32),
                (DEV, torch.float64), (torch.device("cpu"), torch.float64)))
    f64 = compare_steps(card64, cpu64, NOISE_FLOOR)
    f32 = compare_steps(card32, cpu32, NOISE_FLOOR)
    bound_loss, bound_norm = TRAINER_F32_BOUNDS[name]
    log("trainers", f"{name} card vs CPU: float64 loss rel "
        f"{f64['loss_rel']:.2e}, leaf gap {f64['leaf_rel']:.2e} of scale "
        f"({f64['leaf']}); float32 loss {f32['loss']:.7f} / "
        f"{f32['loss_ref']:.7f} (rel {f32['loss_rel']:.2e}, bound "
        f"{bound_loss:.0e}), grad norm rel {f32['grad_norm_rel']:.2e} "
        f"(bound {bound_norm:.0e}), leaf gap {f32['leaf_rel']:.2e}")
    check(f64["loss_rel"] <= 1e-9, f"{name}: float64 losses within 1e-9")
    check(f64["leaf_rel"] <= 1e-6,
          f"{name}: in float64 every gradient leaf within 1e-6 of its scale")
    check(f32["loss_rel"] <= bound_loss,
          f"{name}: float32 losses within {bound_loss}")
    check(f32["grad_norm_rel"] <= bound_norm,
          f"{name}: float32 gradient norms within {bound_norm}")
    return {"float64": f64, "float32": f32,
            "float32_bounds": TRAINER_F32_BOUNDS[name]}


class _ImageSet:
    """Four seeded 128-px stills; sample ``idx`` of epoch ``e`` is a pure
    function of (e, idx). Asking for a sample of epoch ``stop`` raises
    :class:`_Stopped`: a run killed after its earlier epochs."""

    def __init__(self, seed, stop=None):
        self.seed, self.stop = seed, stop

    def __len__(self):
        return 4

    def get(self, idx, epoch=0):
        if epoch == self.stop:
            raise _Stopped
        images, masks = image_batch(1, 128, self.seed + 1000 * epoch + idx)
        return images[0], masks[0]


class _Stopped(Exception):
    pass


def image_loop_phase(variables):
    """16(a): ``run_image_training`` (128 px, batch 2, live BN, a
    validation set) for 3 epochs straight, and stopped after 2 then
    resumed from ``final.pt``: the two must end equal. ``best.npz`` then
    segments through the serving ``load_linknet``."""
    cfg = timg.ImageTrainConfig(epochs=3, batch_size=2, input_size=128,
                                update_bn=True, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        whole, part = os.path.join(tmp, "whole"), os.path.join(tmp, "part")
        val = _ImageSet(SEED + 500)
        t0 = time.perf_counter()
        run_image_training(image_training_form(variables, DEV), cfg,
                           _ImageSet(SEED), whole, val_dataset=val)
        dt = time.perf_counter() - t0
        try:
            run_image_training(image_training_form(variables, DEV), cfg,
                               _ImageSet(SEED, stop=2), part,
                               val_dataset=val)
            check(False, "the stopped run stopped")
        except _Stopped:
            pass
        run_image_training(image_training_form(variables, DEV), cfg,
                           _ImageSet(SEED), part, val_dataset=val,
                           resume=os.path.join(part, "final.pt"))
        a = torch.load(os.path.join(whole, "final.pt"), weights_only=True)
        b = torch.load(os.path.join(part, "final.pt"), weights_only=True)

        metrics = [_image_epochs(d) for d in (whole, part)]
        check(metrics[0] == metrics[1] and a["step"] == b["step"] == 6,
              "resumed epoch metrics and step equal the straight run's")
        check(all(torch.equal(v, b["model"][k])
                  for k, v in a["model"].items()),
              "resumed image weights and statistics equal the straight run's")
        check(all(torch.equal(v, b["optimizer"][m][k]) for m in ("mu", "nu")
                  for k, v in a["optimizer"][m].items()),
              "resumed image optimiser state equals the straight run's")
        model = load_linknet(os.path.join(whole, "best.npz"), device=DEV)
        images, _ = image_batch(1, 128, SEED + 21)
        with torch.no_grad():
            prob = model(torch.from_numpy(images).to(DEV))
        check(prob.shape == (1, 128, 128, 1) and bool(
            torch.isfinite(prob).all()), "best.npz segments an image")
    log("trainers", f"image loop: 3 epochs of 2 steps in {dt:.1f} s "
        f"(validation and checkpoints included), epoch (dice, iou, val "
        f"iou) {metrics[0]}; the resumed run equal; best.npz segments")
    return {"epoch_metrics": metrics[0], "seconds_3_epochs": dt,
            "resume_equal": True}


def _image_epochs(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [[round(r[k], 6) for k in ("dice", "iou", "select_iou")]
                for r in map(json.loads, f)]


def image_trainer_phase():
    """16(a): the image trainer from the bundled trained LinkNet: the CLI's
    recipe (416 x 416, batch 8, lr 1e-4) timed with frozen and with live
    BN, one step card against CPU (128 px, batch 2), and the loop."""
    variables = load_flat_npz(default_checkpoint("image"))
    out = {}
    for name, update_bn in (("frozen_bn", False), ("update_bn", True)):
        cfg = timg.ImageTrainConfig(update_bn=update_bn)
        images, masks = image_batch(cfg.batch_size, cfg.input_size,
                                    SEED + 20)
        x = (torch.from_numpy(images).to(DEV),
             torch.from_numpy(masks).to(DEV))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        model = image_training_form(variables, DEV)
        step = timg.make_image_train_step(
            model, timg.init_image_train_state(model, cfg), update_bn)
        ms, peak, outs = timed_steps(step, [x] * 7)
        dice = [o[0].item() for o in outs]
        iou = [o[1].item() for o in outs]
        check(all(np.isfinite(dice)) and all(0 <= v <= 1 for v in iou),
              f"image {name}: finite dice and IoU in [0, 1]")
        out[name] = {"ms_step": ms, "peak_gb": (peak - base) / 1e9,
                     "dice": dice, "iou": iou}
        log("trainers", f"image {name}, 416 px, batch 8: {ms:.2f} ms a step "
            f"(median of 5 after 2), peak {(peak - base) / 1e9:.3f} GB, dice "
            f"{dice[0]:.5f} -> {dice[-1]:.5f}, IoU {iou[0]:.4f} -> "
            f"{iou[-1]:.4f}")
        del model, step
        torch.cuda.empty_cache()
    images, masks = image_batch(2, 128, SEED + 22)
    out["card_vs_cpu"] = trainer_card_cpu(
        "image", lambda dev, dt: image_grads(variables, dev, dt, images,
                                             masks))
    out["loop"] = image_loop_phase(variables)
    return out


def detection_run(people, steps=150):
    """16(b): the tiny detector (seeded weights, 320 px, the trainer's
    defaults) for ``steps`` steps on the cv2-free scenes, one a step:
    (median ms of steps 2..6, CUDA events around the step only; peak
    memory; losses; the model)."""
    tc = tdet.DetectionTrainConfig()
    mc = (tdet.tiny_people_config if people else
          tdet.tiny_stopsign_config)(tc.image_size)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = seeded_init(GeneralizedRCNN(mc, trainable_bn=True),
                        SEED).to(DEV)
    step = tdet.make_detection_train_step(
        model, tdet.init_detection_train_state(model, tc), tc)
    ds = (SyntheticPeopleDataset if people else SyntheticStopsignDataset)(
        n=steps, size=tc.image_size, seed=tc.seed)
    ms, peak, outs = timed_steps(
        step, (tdet.to_device(ds.get(i), DEV) for i in range(steps)),
        last=7)
    return ms, peak - base, [o[0].item() for o in outs], model


def detection_trainer_phase():
    """16(b): both tiny detectors trained 150 steps (the mean loss of the
    last 25 below the first 25's), the full-width Keypoint R-CNN R-101
    step timed, one step card against CPU at 96 px, and the trained stop-
    sign weights through ``export_rcnn_variables`` and the serving
    ``load_default_detector`` on a rendered scene (the NMS kernel)."""
    out = {}
    for name, people in (("stopsign", False), ("people", True)):
        ms, peak, losses, model = detection_run(people)
        first, last = np.mean(losses[:25]), np.mean(losses[-25:])
        check(all(np.isfinite(losses)), f"{name}: finite losses")
        check(last < first, f"{name}: the mean loss of the last 25 steps "
              f"({last:.4f}) below the first 25's ({first:.4f})")
        out[name] = {"ms_step": ms, "peak_gb": peak / 1e9, "steps": 150,
                     "loss_first25": float(first),
                     "loss_last25": float(last)}
        log("trainers", f"detector {name}, tiny, 320 px: {ms:.2f} ms a step "
            f"(median of 5 after 2), peak {peak / 1e9:.3f} GB, mean loss "
            f"{first:.4f} (steps 0-24) -> {last:.4f} (steps 125-149)")
        if not people:
            trained = model
        del model
        torch.cuda.empty_cache()
    # full width: Keypoint R-CNN R-101 (1 class, keypoints, no masks)
    tc = tdet.DetectionTrainConfig()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = seeded_init(GeneralizedRCNN(keypoint_rcnn_config(),
                                        trainable_bn=True), SEED).to(DEV)
    n_params = sum(p.numel() for p in model.parameters())
    step = tdet.make_detection_train_step(
        model, tdet.init_detection_train_state(model, tc), tc)
    ds = SyntheticPeopleDataset(n=7, size=tc.image_size, seed=tc.seed)
    ms, peak, outs = timed_steps(
        step, [tdet.to_device(ds.get(i), DEV) for i in range(7)])
    losses = [o[0].item() for o in outs]
    check(all(np.isfinite(losses)), "Keypoint R-CNN: finite losses")
    out["keypoint_rcnn_r101"] = {"ms_step": ms,
                                 "peak_gb": (peak - base) / 1e9,
                                 "params": n_params, "losses": losses}
    log("trainers", f"Keypoint R-CNN R-101 ({n_params / 1e6:.1f} M), 320 px: "
        f"{ms:.2f} ms a step (median of 5 after 2), peak "
        f"{(peak - base) / 1e9:.3f} GB, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    del model, step
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = trainer_card_cpu(
        "detection", lambda dev, dt: detection_grads(dev, dt, 0))
    launched = {**bank_read_cuda.launches, **cc_cuda.launches,
                **nms_cuda.launches}
    check(not any(launched.values()), f"the training steps launched none of "
          f"the port's kernels: {launched}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "best.npz")
        save_flat_npz(path, export_rcnn_variables(trained.state_dict()))
        with open(os.path.join(tmp, "rcnn_config.json"), "w") as f:
            json.dump(dataclasses.asdict(trained.cfg), f)
        detector = load_default_detector("stopsign", model_path=path,
                                         device=DEV)
        sc = render_stopsign_scene(np.random.default_rng(SEED + 23), 320,
                                   water_level=0.25)
        inst = detector(sc["image"].astype(np.uint8))
    n_nms = nms_cuda.launches["nms"]
    check(n_nms >= 1, "the served detector launched the NMS kernel")
    out["served"] = {"detections": int(len(inst.boxes)),
                     "nms_launches": n_nms,
                     "best_score": float(inst.scores.max())
                     if len(inst.scores) else None}
    log("trainers", f"trained tiny stop-sign detector served: "
        f"{len(inst.boxes)} detections, NMS kernel launched {n_nms} times")
    return out


def bodymesh_trainer_phase(steps=150):
    """16(c): the ``BodyMeshRegressor`` (ResNet-50, live BN, one 224-px
    crop a step) from seeded weights for ``steps`` steps (the best 25-step
    mean from step 100 below the first 25's), and one step card against
    CPU."""
    cfg = tbm.BodyMeshTrainConfig(total_steps=steps)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = tbm.init_body_mesh(cfg.seed + 1, DEV)
    n_params = sum(p.numel() for p in model.parameters())
    step = tbm.make_bodymesh_train_step(
        model, tbm.init_bodymesh_train_state(model, cfg))
    template = load_template_3d(None)

    def samples():
        for i in range(steps):
            crop, target = tbm.make_training_sample(
                np.random.default_rng(np.random.SeedSequence(
                    [cfg.seed + 13, i])), template)
            yield (torch.from_numpy(crop).to(DEV),
                   torch.from_numpy(target).to(DEV))
    ms, peak, outs = timed_steps(step, samples(), last=7)
    peak -= base
    losses = [loss.item() for loss in outs]
    first = float(np.mean(losses[:25]))
    # the trainer's best: 25-step running means read every 25 steps from
    # step 100
    best = min(float(np.mean(losses[i - 24:i + 1]))
               for i in range(100, steps, 25))
    check(all(np.isfinite(losses)), "body mesh: finite losses")
    check(best < first, f"body mesh: the best 25-step mean ({best:.5f}) "
          f"below the first 25's ({first:.5f})")
    log("trainers", f"body mesh ({n_params / 1e6:.1f} M), 224 px: {ms:.2f} ms "
        f"a step (median of 5 after 2), peak {peak / 1e9:.3f} GB, mean loss "
        f"{first:.5f} (steps 0-24), best 25-step mean {best:.5f}")
    del model, step
    torch.cuda.empty_cache()
    return {"ms_step": ms, "peak_gb": peak / 1e9, "params": n_params,
            "steps": steps, "loss_first25": first, "best_mean25": best,
            "card_vs_cpu": trainer_card_cpu(
                "bodymesh", lambda dev, dt: bodymesh_grads(dev, dt, 0))}


def trainers_phase():
    """Phase 16: the image, detection and body-mesh trainers on the card
    in float32 (float64 for the card-against-CPU references), TF32 off,
    each as its CLI runs it: the image trainer with cuDNN deterministic,
    the others without; the training steps launch none of the port's
    kernels, the served detector the NMS kernel."""
    t0 = time.perf_counter()
    for counter in (bank_read_cuda, cc_cuda, nms_cuda):
        counter.reset_launches()
    with cudnn_deterministic():
        res = {"image": image_trainer_phase()}
    res["bodymesh"] = bodymesh_trainer_phase()
    res["detection"] = detection_trainer_phase()
    res["seconds"] = time.perf_counter() - t0
    log("trainers", f"phase 16 took {res['seconds']:.1f} s")
    return res


# --------------------------------------------------------------------------
# Phase 17: the bank sharded over ranks, data-parallel training, mask PNGs
# --------------------------------------------------------------------------

SHARD_COUNTS = (2, 4, 8)


@contextlib.contextmanager
def _plain_read_calls():
    """Calls of the sharded read's plain versions inside the block (a
    CUDA bank must take none)."""
    calls = {"read": 0, "count": 0}
    saved = sharded_read._read_occ_sweep, sharded_read._count_occ_sweep

    def counted(fn, name):
        def inner(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return inner
    sharded_read._read_occ_sweep = counted(saved[0], "read")
    sharded_read._count_occ_sweep = counted(saved[1], "count")
    try:
        yield calls
    finally:
        sharded_read._read_occ_sweep, sharded_read._count_occ_sweep = saved


def _host_steps(eng, state, frames):
    """Steps 1.. over ``frames``, each timed on the host clock between
    synchronisations: (state, host labels, ms a step)."""
    ms, labels = [], []
    for i, f in enumerate(frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, lab = eng.step(state, f, i + 1)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        labels.append(eng.fetch_label(lab))
    return state, labels, ms


def sharded_engine_phase(model, mesh, kernels, replay_ms, gap=None):
    """17(a) for ``model``'s dtype: the sharded engine on a world of one
    against the eager single engine on the same 8 synthetic 1080p frames
    (both timed; ``replay_ms``, the single engine's replayed step of phase
    5 or 10, beside them), trained weights, budget
    250,000, the device CC cleanup. Each of ``kernels`` and the CC kernel
    launch once a step, no other bank kernel, and the sharded read's plain
    versions never. float32: labels > 0.99 a frame, valid counts, occ and
    replace_n equal; bf16: labels at least ``gap`` (the CPU's bf16-vs-
    float32 agreement) less 0.01. Returns (results, launches, the final
    state and the last frame's query for 17(b))."""
    frames, mask0 = synthetic_clip(9, *FRAME_HW, SEED + 17)

    def engine(cls, *args, **kw):
        fb = FeatureBank(obj_n=2, memory_budget=BUDGET, dtype=model.dtype,
                         device=DEV)
        return cls(model, fb, *args, downsample=DOWNSAMPLE,
                   postprocess="device", **kw)
    single = engine(VideoSegEngine, cuda_graph=False)
    ref, ref_labels, eager_ms = _host_steps(
        single, single.bootstrap(frames[0], mask0), frames[1:])
    del single
    sharded = engine(ShardedVideoSegEngine, mesh)
    state = sharded.bootstrap(frames[0], mask0)
    bank_read_cuda.reset_launches()
    cc_cuda.reset_launches()
    with _plain_read_calls() as plain:
        state, labels, ms = _host_steps(sharded, state, frames[1:])
    launches = {**bank_read_cuda.launches, **cc_cuda.launches}
    steps = len(frames) - 1
    want = {k: steps if k in kernels + ("largest_cc",) else 0
            for k in launches}
    check(launches == want, f"sharded {model.dtype}: {kernels} and the CC "
          f"kernel once a step and no other bank kernel: {launches}")
    check(plain == {"read": 0, "count": 0}, f"sharded {model.dtype}: the "
          f"plain read and count never ran: {plain}")
    agree = [float((a == b).mean()) for a, b in zip(labels, ref_labels)]
    totals = {k: (getattr(state, k).tolist(), getattr(ref, k).tolist())
              for k in ("occ", "replace_n", "peak_n")}
    totals["valid"] = (state.valid.sum(1).tolist(),
                       ref.valid.sum(1).tolist())
    log("sharded", f"{model.dtype}, world of one (NCCL), 8 steps: labels "
        f"against the single engine {['%.6f' % a for a in agree]}; "
        f"(sharded, single) {totals}; eager step ms "
        f"{['%.1f' % t for t in ms]} (median of steps 2-8 "
        f"{np.median(ms[1:]):.2f}) beside the single engine's eager "
        f"{np.median(eager_ms[1:]):.2f} on these frames and replayed "
        f"{replay_ms:.2f} (phase 5 or 10); launches {launches}")
    if model.dtype == torch.float32:
        check(min(agree) > 0.99, "float32 sharded labels > 0.99 a frame")
        check(all(a == b for a, b in totals.values()),
              "float32 sharded valid counts, occ, replace_n and peak_n "
              "equal the single engine's")
    else:
        check(min(agree) >= gap - 0.01, f"bf16 sharded labels at least "
              f"the CPU's bf16-vs-float32 agreement less 0.01 "
              f"({gap - 0.01:.6f})")
    frame = torch.from_numpy(frames[-1]).to(DEV)
    small = resize(frame.to(model.dtype) / 255.0,
                   short_side_size(*FRAME_HW, DOWNSAMPLE), "bicubic",
                   spatial_axes=(0, 1))
    with torch.no_grad():
        q = sharded.model.encode_query(small[None])[0][0].contiguous()
    res = {"agreement": agree, "totals": totals, "ms": ms,
           "ms_median": float(np.median(ms[1:])),
           "single_eager_ms": float(np.median(eager_ms[1:])),
           "single_replay_ms": replay_ms,
           "launches": launches}
    return res, launches, state, q


def _combine_over_shards(parts, valids):
    """The all-reduce combine with a stacked shard axis: every shard's
    (mem, m, l) and valid -> (mem, log_thres)."""
    mem, m, l = (torch.stack([p[i] for p in parts]) for i in range(3))
    has = torch.stack([v.any(dim=-1) for v in valids])

    def reduce(op):
        return lambda t: t.copy_(op(t).expand_as(t))
    out = sharded_read.combine_shards(
        mem, m, l, has, reduce(lambda t: t.amax(0, keepdim=True)),
        reduce(lambda t: t.sum(0, keepdim=True)), THRES)
    return out[0][0], out[1][0]


def _mem_close(got, want, exact, tol):
    """``got`` within ``tol`` of ``want``; for bf16, an element where
    ``want`` (a plain version) is itself off the float32-probability read
    ``exact`` and ``got`` is not is held to ``exact`` (as phase 9)."""
    near = torch.isclose(got, want, **tol)
    if exact is not None:
        near |= ~torch.isclose(want, exact, **tol) & \
            torch.isclose(got, exact, **tol)
    return bool(near.all())


def _shards_against_plain(q, shards, tol, bf16):
    """Each shard's read kernel (with its combine) against the plain
    version on that shard: mem within ``tol`` (bf16: phase 9's rule), m
    within rtol 1e-5 / atol 1e-5, l within rtol 1e-4; its largest mem
    error."""
    errs = []
    for kr, vr, okr in shards:
        bound = sharded_read.shard_occ_bound(okr)
        b = int(bound)
        mem_k, m_k, l_k, _ = bank_read_cuda.bank_read(
            q, kr, vr, okr, bound, attention.OCC_CHUNK, THRES)
        mem_p, m_p, l_p, _, _ = _plain(q, kr, vr, okr, b)
        n_visit = attention.visited_slots(kr.shape[1], attention.OCC_CHUNK,
                                          b)
        exact = _exact_mem(q, kr, vr, okr, n_visit) if bf16 else None
        check(_mem_close(mem_k, mem_p, exact, tol) and
              torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-5) and
              torch.allclose(l_k, l_p, rtol=1e-4, atol=0),
              f"a shard's kernel read within the bounds of its plain "
              f"version (bound {b}, {kr.dtype}): mem max|err| "
              f"{(mem_k - mem_p).abs().max().item():.3e}")
        errs.append((mem_k - mem_p).abs().max().item())
    return max(errs)


def _shards_combined(q, shards, timed):
    """The shards read by the kernels and combined as the all-reduce
    combines them, each shard counted against the global log_thres by
    the kernel and by the plain version: (mem, log_thres, the kernel's and
    the plain counts of the whole bank, read ms and count ms per shard
    when ``timed``)."""
    parts, read_ms, count_ms, cnts, cnts_p = [], [], [], [], []
    bounds = [sharded_read.shard_occ_bound(okr) for _, _, okr in shards]
    for (kr, vr, okr), bound in zip(shards, bounds):
        parts.append(bank_read_cuda.bank_read(
            q, kr, vr, okr, bound, attention.OCC_CHUNK, THRES)[:3])
        if timed:
            read_ms.append(time_ms(lambda: bank_read_cuda.bank_read(
                q, kr, vr, okr, bound, attention.OCC_CHUNK, THRES)))
    mem_c, lt_c = _combine_over_shards(parts, [s[2] for s in shards])
    for (kr, _, okr), bound in zip(shards, bounds):
        cnt_k = bank_read_cuda.bank_count(q, kr, okr, bound, lt_c,
                                          attention.OCC_CHUNK)
        cnt_p = torch.stack([attention._count_occ_sweep(
            kr[o], okr[o], q, lt_c[o], attention.OCC_CHUNK, int(bound))
            for o in range(OBJ)])
        cnts.append(cnt_k)
        cnts_p.append(cnt_p)
        if timed:
            count_ms.append(time_ms(lambda: bank_read_cuda.bank_count(
                q, kr, okr, bound, lt_c, attention.OCC_CHUNK)))
    return (mem_c, lt_c, torch.cat(cnts, dim=1), torch.cat(cnts_p, dim=1),
            read_ms, count_ms)


def _scores64(q, keys, valid, o):
    """Object ``o``'s scores in float64 over every slot of ``keys``,
    invalid slots at the read's NEG_INF."""
    s = (q.double() @ keys[o].double().T) / math.sqrt(DK)
    return torch.where(valid[o][None], s,
                       torch.full_like(s, attention.NEG_INF))


def _shards_against_float64(q, shards, lt_c, cnt_k, cnt_p):
    """17(b) on the main path's bank against an exact reference: each
    shard that holds valid slots of an object is read in float64, and
    the kernel's read (with its combine) and the plain float32 version
    are each held to it; the shards' float64 partials are combined into
    the float64 log_thres, and the whole bank's counts of the kernel and
    of the plain version (both against the kernels' combined ``lt_c``)
    are held to the float64 counts against it. The kernel must be no
    further from float64 than float32 arithmetic is: its mem, m and l
    (relative) errors within twice the plain version's largest over the
    shards (mem at least phase 3's atol), its counts within the larger of
    1 and twice the plain counts' error. Returns the errors, (kernel,
    plain) for each of mem, m, l and counts."""
    err = {k: [0.0, 0.0] for k in ("mem", "m", "l", "cnt")}
    part64 = {}     # (shard, object): float64 (m, l)
    for r, (kr, vr, okr) in enumerate(shards):
        bound = sharded_read.shard_occ_bound(okr)
        mem_k, m_k, l_k, _ = bank_read_cuda.bank_read(
            q, kr, vr, okr, bound, attention.OCC_CHUNK, THRES)
        mem_p, m_p, l_p, _, _ = _plain(q, kr, vr, okr, int(bound))
        for o in range(OBJ):
            if not bool(okr[o].any()):
                continue      # such a shard has no part in the combine
            s = _scores64(q, kr, okr, o)
            m = s.amax(1)
            e = torch.exp(s - m[:, None])
            l = e.sum(1)
            mem = (e @ vr[o].double()) / l[:, None]
            part64[r, o] = (m, l)
            for i, (mem_x, m_x, l_x) in enumerate(((mem_k, m_k, l_k),
                                                   (mem_p, m_p, l_p))):
                err["mem"][i] = max(err["mem"][i],
                                    (mem_x[o] - mem).abs().max().item())
                err["m"][i] = max(err["m"][i],
                                  (m_x[o] - m).abs().max().item())
                err["l"][i] = max(err["l"][i],
                                  ((l_x[o] - l).abs() / l).max().item())
            del s, e
    n = N // len(shards)
    for o in range(OBJ):
        parts = [(r, *part64[r, o]) for r in range(len(shards))
                 if (r, o) in part64]
        if not parts:
            continue
        m_g = torch.stack([p[1] for p in parts]).amax(0)
        l_g = sum(l * torch.exp(m - m_g) for _, m, l in parts)
        lt64 = math.log(THRES) + torch.log(l_g) + m_g
        for r, _, _ in parts:
            kr, _, okr = shards[r]
            cnt64 = (_scores64(q, kr, okr, o) > lt64[:, None]).sum(0)
            for i, cnt in enumerate((cnt_k, cnt_p)):
                err["cnt"][i] = max(err["cnt"][i], (
                    cnt[o, r * n:(r + 1) * n].double() - cnt64
                ).abs().max().item())
    for key, (got, plain) in err.items():
        floor = {"mem": MEM_TOL["atol"], "m": 1e-5, "l": 1e-4,
                 "cnt": 1.0}[key]      # phase 3's bounds, counts 1
        check(got <= max(2 * plain, floor), f"main path's bank, "
              f"{len(shards)} shards: the kernels' {key} within twice the "
              f"plain float32 version's error against float64 "
              f"(kernel {got:.3e}, plain {plain:.3e})")
    return err


def shard_kernel_phase(state, q_main):
    """17(b) for the bank's dtype, each bank cut into R = 2, 4, 8 shards:
    the main path's bank of 17(a) (valid slots in rank order, as the
    sharded update fills them), the same with every slot valid (its valid
    prefix tiled over the capacity) and with none, read by the main path's
    query of 17(a); and phase 3's bank (seeded randn keys and values, its
    query 3 x randn) with the same valid prefix and with every slot valid.
    With every bank the shards are read by the kernels, combined as the
    all-reduce combines them and held against the unsharded kernel read
    (mem within phase 3's or 9's bounds, counts within 1), but for the
    empty bank, whose combined mem is 0 as in JAX (the unsharded read
    averages the visited values). On phase 3's banks each shard's kernel
    read and counts are held against the plain versions on that shard
    (the same bounds; m and l as phase 3). The trained bank's scores reach |1224|, where the
    float32 rounding of a score alone moves its exponential by 1e-3, so
    any two float32 summation orders (the kernel's and cuBLAS's) part by
    more than those bounds there; the kernels' own shard combine is exact
    to them. So on the main path's banks (but the empty one) each shard's
    kernel read and the counts are held against a float64 read and
    float64 counts instead, within twice the plain float32 version's
    error against the same (:func:`_shards_against_float64`). Each
    shard's read (with its combine) and count ms on the main path's
    banks."""
    dt = state.keys.dtype
    bf16 = dt == torch.bfloat16
    tol = MEM_TOL_BF16 if bf16 else MEM_TOL
    g = torch.Generator(device=DEV).manual_seed(SEED + 21)
    q_syn = (3.0 * torch.randn(P, DK, device=DEV, generator=g)).to(dt)
    k_syn = torch.randn(OBJ, N, DK, device=DEV, generator=g).to(dt)
    v_syn = torch.randn(OBJ, N, DV, device=DEV, generator=g).to(dt)
    q_main = q_main.to(dt).contiguous()
    occ = int(state.occ.max())
    reps = -(-N // occ)
    every = torch.ones(OBJ, N, dtype=torch.bool, device=DEV)
    cases = {   # name: (keys, values, valid, q, main path's)
        "main": (state.keys, state.values, state.valid, q_main, True),
        "full": (state.keys[:, :occ].repeat(1, reps, 1)[:, :N].contiguous(),
                 state.values[:, :occ].repeat(1, reps, 1)[:, :N]
                 .contiguous(), every, q_main, True),
        "empty": (state.keys, state.values, torch.zeros_like(state.valid),
                  q_main, True),
        "phase3_main": (k_syn, v_syn, state.valid, q_syn, False),
        "phase3_full": (k_syn, v_syn, every, q_syn, False)}
    out = {}
    for name, (keys, values, valid, q, main) in cases.items():
        bound_w = sharded_read.shard_occ_bound(valid)
        mem_w, _, _, lt_w = bank_read_cuda.bank_read(
            q, keys, values, valid, bound_w, attention.OCC_CHUNK, THRES)
        cnt_w = bank_read_cuda.bank_count(q, keys, valid, bound_w, lt_w,
                                          attention.OCC_CHUNK)
        exact_w = _exact_mem(q, keys, values, valid, N) if bf16 else None
        for r_n in SHARD_COUNTS:
            n = N // r_n
            shards = [tuple(t[:, r * n:(r + 1) * n].contiguous()
                            for t in (keys, values, valid))
                      for r in range(r_n)]
            shard_err = None if main else _shards_against_plain(
                q, shards, tol, bf16)
            mem_c, lt_c, cnt_c, cnt_pc, read_ms, count_ms = \
                _shards_combined(q, shards, main)
            cnt_plain_err = (cnt_c - cnt_pc).abs().max().item()
            exact_err = _shards_against_float64(
                q, shards, lt_c, cnt_c, cnt_pc) \
                if main and name != "empty" else None
            comb_err = (mem_c - mem_w).abs().max().item()
            cnt_err = (cnt_c - cnt_w).abs().max().item()
            where = f"{dt} {name} bank, R = {r_n}"
            if not main:
                check(cnt_plain_err <= 1.0, f"{where}: each shard's counts "
                      f"within 1 of the plain count's")
            check(cnt_err <= 1.0, f"{where}: counts within 1 of the "
                  f"unsharded count ({cnt_err})")
            if name == "empty":
                # the unsharded read averages the visited values (the
                # single engine's contract); sharded, JAX gives 0
                check(bool((mem_c == 0).all()) and cnt_c.sum().item() == 0,
                      f"{where}: mem 0 and no counts, as JAX")
            else:
                check(_mem_close(mem_c, mem_w, exact_w, tol),
                      f"{where}: the combined shards within the bounds of "
                      f"the unsharded kernel read ({comb_err:.3e})")
            res = {"combined_mem_err": comb_err, "combined_cnt_err": cnt_err}
            if main:
                res.update(read_ms=read_ms, count_ms=count_ms,
                           float64_err=exact_err)
            else:
                res.update(shard_mem_err=shard_err,
                           shard_cnt_err=cnt_plain_err)
            out[f"{name}_R{r_n}"] = res
            log("sharded", f"{where}: " + (
                f"per shard read + combine ms "
                f"{['%.3f' % t for t in read_ms]}, count ms "
                f"{['%.3f' % t for t in count_ms]}; " if main else
                f"shard vs plain mem max|err| {shard_err:.3e}, counts "
                f"{cnt_plain_err}; ") + f"combined vs unsharded mem max|err| "
                f"{comb_err:.3e}, counts {cnt_err}" + (
                    "" if exact_err is None else "; against float64 "
                    "(kernel, plain) " + ", ".join(
                        f"{k} ({a:.3e}, {b:.3e})"
                        for k, (a, b) in exact_err.items())))
    del cases, k_syn, v_syn
    torch.cuda.empty_cache()
    return out


def dp_train_phase(mesh):
    """17(c): the video and image trainers' ``mesh=`` step on the world of
    one against the plain step, frozen and live BN, 3 steps each from the
    bundled trained weights, cuDNN deterministic: losses and every state
    tensor equal bit for bit; ms a step, the median of steps 2-3 (CUDA
    events). Video: two 240-px clips of 3 frames; image: two 128-px
    stills."""
    variables = load_flat_npz(default_checkpoint("video"))
    image_vars = load_flat_npz(default_checkpoint("image"))
    clips = [torch.from_numpy(x).to(DEV)
             for x in training_clips(2, 3, 2, 240, SEED + 18)]
    stills = [torch.from_numpy(x).to(DEV) for x in image_batch(2, 128,
                                                              SEED + 19)]
    out = {}
    with cudnn_deterministic():
        for kind in ("video", "image"):
            for update_bn in (False, True):
                runs = []
                for use_mesh in (None, mesh):
                    if kind == "video":
                        model = training_form(variables, DEV)
                        cfg = _train_cfg(update_bn=update_bn)
                        step = make_video_train_step(
                            model, init_video_train_state(model, cfg), cfg,
                            mesh=use_mesh)
                        inputs = clips
                    else:
                        model = image_training_form(image_vars, DEV)
                        cfg = timg.ImageTrainConfig(update_bn=update_bn)
                        step = timg.make_image_train_step(
                            model, timg.init_image_train_state(model, cfg),
                            update_bn, mesh=use_mesh)
                        inputs = stills
                    ms, _, outs = timed_steps(step, [inputs] * 3, warm=1)
                    runs.append(([torch.stack(o) if isinstance(o, tuple)
                                  else o for o in outs],
                                 model.state_dict(), ms))
                (plain_out, plain_state, plain_ms), (dp_out, dp_state,
                                                     dp_ms) = runs
                name = f"{kind}_{'live' if update_bn else 'frozen'}_bn"
                check(all(torch.equal(a, b) for a, b in
                          zip(plain_out, dp_out)) and
                      all(torch.equal(plain_state[k], dp_state[k])
                          for k in plain_state),
                      f"{name}: the mesh step equals the plain step bit "
                      f"for bit over 3 steps")
                out[name] = {"plain_ms": plain_ms, "mesh_ms": dp_ms,
                             "losses": [float(o.reshape(-1)[0])
                                        for o in dp_out]}
                log("sharded", f"{name}: mesh= step on the world of one "
                    f"equals the plain step over 3 steps; ms a step {dp_ms:.2f}"
                    f" (plain {plain_ms:.2f}; medians of steps 2-3)")
                del runs, model, step
                torch.cuda.empty_cache()
    return out


def png_phase():
    """17(d): a 1080p two-label mask through the port's PNG writer and
    reader on this machine (no PIL here): read back equal; ms of each
    (median of 3)."""
    labels = (np.random.RandomState(SEED + 20).rand(*FRAME_HW) * 2).astype(
        np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mask.png")
        write_ms, read_ms = [], []
        for _ in range(3):
            t = time.perf_counter()
            native.write_palette_png(path, labels, COLOR_PALETTE)
            write_ms.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            back = native.read_palette_png(path)
            read_ms.append(1e3 * (time.perf_counter() - t))
            check(np.array_equal(back, labels), "the 1080p mask reads back "
                  "equal")
        size = os.path.getsize(path)
    res = {"write_ms": float(np.median(write_ms)),
           "read_ms": float(np.median(read_ms)), "bytes": size}
    log("sharded", f"1080p two-label mask PNG: write {res['write_ms']:.2f} "
        f"ms, read {res['read_ms']:.2f} ms (medians of 3, host clock), "
        f"{size} bytes, read back equal")
    return res


def sharded_phase(model, model16, gap, replay_ms):
    """Phase 17: (a) the sharded engine on a world of one over NCCL in
    this process (float32 and bf16), (b) the shard-local kernels at R = 2,
    4, 8, (c) the trainers' mesh= step, (d) the mask PNGs. Returns
    (results, {dtype name: the sharded engine's launches})."""
    t0 = time.perf_counter()
    init_local_world(DEV)
    try:
        mesh = make_mesh()
        res, launches = {}, {}
        for name, m, kernels in (
                ("float32", model, ("bank_read", "bank_read_combine",
                                    "bank_count")),
                ("bfloat16", model16, ("bank_read_bf16", "bank_read_combine",
                                       "bank_count_bf16"))):
            res[name], launches[name], state, q = sharded_engine_phase(
                m, mesh, kernels, replay_ms[name], gap)
            res[name]["shards"] = shard_kernel_phase(state, q)
            del state, q
            torch.cuda.empty_cache()
        res["training"] = dp_train_phase(mesh)
        res["png"] = png_phase()
    finally:
        close_world()
    res["seconds"] = time.perf_counter() - t0
    log("sharded", f"phase 17 took {res['seconds']:.1f} s")
    return res, launches


# --------------------------------------------------------------------------
# phase 18: the Atlantis PSPNet, the RGB PNG writer, the model axis
# --------------------------------------------------------------------------

ATLANTIS_PAD = 768


def _pspnet_npz(path, seed):
    """Seeded full-width PSPNet weights written as the JAX package's flat
    variables (through ``export_pspnet_variables``), for
    ``load_pspnet``."""
    form = seeded_psp_init(PSPNet(norm=TrainBN), seed)
    save_flat_npz(path, export_pspnet_variables(form.state_dict()))


def _atlantis_image(h, w, seed):
    """A float32 [h, w, 3] image in [0, 1]: sky over a wavy waterline."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32) / max(h, w)
    water = yy + 0.05 * np.sin(11 * xx) > 0.4
    img = np.where(water[..., None], rng.uniform(0.1, 0.4, 3),
                   rng.uniform(0.5, 0.9, 3))
    return np.clip(img + 0.05 * rng.standard_normal(img.shape), 0,
                   1).astype(np.float32)


def _normalised(img, dev):
    """A float32 [H, W, 3] image as the harness feeds PSPNet: [1, 3, H, W]
    on ``dev``, less the ImageNet mean, over its std."""
    x = torch.from_numpy(img).to(dev)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return ((x - mean) / std).permute(2, 0, 1)[None]


def pspnet_phase():
    """18(a): the Atlantis harness (``pipelines/atlantis.py``) with the
    full-width PSPNet (56 classes, seeded weights through the flat npz and
    ``load_pspnet``, float32, TF32 off) at the 768-px padding. Records the
    forward's ms (CUDA events, median of 10 after a warm call) and peak
    memory, the harness's ms an image (host clock around pad, upload,
    forward, upsample, argmax, download and water map; median of 5, no
    decode, no PNG) for a 540 x 720 image and for a 1080 x 1920 one (shrunk
    on the host first), card against CPU on the same weights for a 256-px
    image (the timed evaluator's model's logits within 1e-4 of their
    scale; the labels of its ``predict`` and of a CPU evaluator's, both
    padding to 768, >= 0.999 equal) and the bf16 forward's labels against
    the float32 ones at 768 (printed)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pspnet.npz")
        _pspnet_npz(path, SEED + 21)
        model = load_pspnet(path, device=DEV)
        cpu = load_pspnet(path, device="cpu")
        model16 = load_pspnet(path, device=DEV, dtype=torch.bfloat16)
    x = _normalised(_atlantis_image(ATLANTIS_PAD, ATLANTIS_PAD, SEED + 22),
                    DEV)
    with torch.no_grad():
        aux, logits = model(x)
        check(logits.shape == (1, 56, 96, 96) and aux.shape == logits.shape
              and bool(torch.isfinite(logits).all()),
              f"PSPNet logits at 1/8 of 768: {tuple(logits.shape)}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_ms = time_ms(lambda: model(x))
        peak = torch.cuda.max_memory_allocated() - base
    res = {"forward_ms": fwd_ms, "forward_peak_bytes": int(peak)}
    evaluator = AtlantisEvaluator(model, ATLANTIS_PAD)
    for name, hw in (("540x720", (540, 720)), ("1080x1920", (1080, 1920))):
        img = _atlantis_image(*hw, SEED + 23)
        times = []
        for _ in range(6):
            t = time.perf_counter()
            pred, shown = evaluator.predict(img)
            water = evaluator.water(pred)
            times.append(1e3 * (time.perf_counter() - t))
        check(pred.shape == shown.shape[:2] == water.shape and
              pred.dtype == np.uint8, f"{name}: labels of the image's size")
        res[f"harness_ms_{name}"] = float(np.median(times[1:]))
        res[f"water_share_{name}"] = float(water.mean())
    # card against CPU, same weights: the timed evaluator's model's
    # logits of a 256-px image, then the labels that the timed evaluator
    # and a CPU one predict for it (each pads it to 768)
    small = _atlantis_image(256, 256, SEED + 24)
    cpu_evaluator = AtlantisEvaluator(cpu, ATLANTIS_PAD)
    with torch.no_grad():
        card_lg, cpu_lg = [ev.model(_normalised(small, ev.device))[1].cpu()
                           for ev in (evaluator, cpu_evaluator)]
    card_lab, cpu_lab = (ev.predict(small)[0]
                         for ev in (evaluator, cpu_evaluator))
    scale = cpu_lg.abs().max().item()
    err = (card_lg - cpu_lg).abs().max().item()
    agree = float((card_lab == cpu_lab).mean())
    check(err <= 1e-4 * scale, f"PSPNet card vs CPU at 256 px: logits "
          f"{err:.3g} apart at scale {scale:.3g}")
    check(card_lab.shape == cpu_lab.shape == (256, 256) and agree >= 0.999,
          f"the harness's labels on the card vs the CPU agree {agree:.6f}")
    res["card_vs_cpu"] = {"max_abs_err": err, "scale": scale,
                          "label_agreement": agree}
    # bf16 against float32 on the card, the harness's labels at 768
    img = _atlantis_image(540, 720, SEED + 23)
    labels32 = evaluator.predict(img)[0]
    labels16 = AtlantisEvaluator(model16, ATLANTIS_PAD).predict(img)[0]
    res["bf16_vs_float32_labels"] = float((labels16 == labels32).mean())
    log("atlantis", f"PSPNet 768 px float32 forward {fwd_ms:.2f} ms, peak "
        f"{peak / 2**30:.2f} GiB; harness {res['harness_ms_540x720']:.2f} "
        f"ms an image at 540 x 720, {res['harness_ms_1080x1920']:.2f} at "
        f"1080 x 1920 (host clock, median of 5); card vs CPU at 256 px: "
        f"logits {err:.3g} at scale {scale:.3g}, labels {agree:.6f}; bf16 "
        f"vs float32 labels {res['bf16_vs_float32_labels']:.6f}")
    del model, model16, cpu
    torch.cuda.empty_cache()
    return res


def rgb_png_phase():
    """18(b): a 1080p water overlay (``add_overlay``) through the RGB PNG
    writer (no PIL on this machine), decoded back equal by
    ``native.read_rgb_png``; ms a write (median of 3, host clock)."""
    rng = np.random.RandomState(SEED + 25)
    bgr = (rng.rand(*FRAME_HW, 3) * 255).astype(np.uint8)
    mask = np.zeros(FRAME_HW, np.uint8)
    mask[FRAME_HW[0] // 2:] = 1
    overlay = add_overlay(bgr, mask)[..., ::-1]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "water.png")
        times = []
        for _ in range(3):
            t = time.perf_counter()
            native.write_rgb_png(path, overlay)
            times.append(1e3 * (time.perf_counter() - t))
        check(np.array_equal(native.read_rgb_png(path), overlay),
              "the 1080p RGB overlay decodes back equal")
        size = os.path.getsize(path)
    res = {"write_ms": float(np.median(times)), "bytes": size}
    log("atlantis", f"1080p RGB overlay PNG: write {res['write_ms']:.2f} ms "
        f"(median of 3, host clock), {size} bytes, decodes back equal")
    return res


def model_axis_phase():
    """18(c): the video trainer's model-axis step on a world of one over
    NCCL (mesh (1, 1): ``shard_train_state``, column-parallel convolutions
    over a model group of one) against the plain step, one step from the
    bundled trained weights with live BN on two 240-px clips, three steps
    each, cuDNN deterministic: the losses, every state tensor (gathered)
    and the AdamW moments equal bit for bit; ms a step, the median of steps
    2-3 (CUDA events). NCCL takes
    one rank a device, so m = 2 runs only on CPU ranks
    (tests/test_torch_train_tp.py)."""
    variables = load_flat_npz(default_checkpoint("video"))
    clips = [torch.from_numpy(x).to(DEV)
             for x in training_clips(2, 3, 2, 240, SEED + 26)]
    init_local_world(DEV)
    try:
        mesh = make_mesh((1, 1))
        runs = []
        with cudnn_deterministic():
            for use_mesh in (None, mesh):
                model = training_form(variables, DEV)
                cfg = _train_cfg(update_bn=True)
                opt = init_video_train_state(model, cfg)
                if use_mesh is not None:
                    shard_train_state(model, opt, use_mesh)
                step = make_video_train_step(model, opt, cfg, mesh=use_mesh)
                ms, _, losses = timed_steps(step, [clips] * 3, warm=1)
                state, opt_state = gather_train_state(model, opt)
                runs.append((torch.stack(losses), state, opt_state, ms,
                             len(opt.sharded)))
                del model, opt, step
    finally:
        close_world()
    (loss, state, opt_state, ms, _), (tp_loss, tp_state, tp_opt, tp_ms,
                                      n_sharded) = runs
    check(n_sharded == sum(t.ndim == 4 for t in state.values()),
          f"mesh (1, 1) shards every conv kernel ({n_sharded})")
    bad = [k for k in state if not torch.equal(state[k], tp_state[k])]
    bad += [f"{k}.{n}" for k in ("mu", "nu") for n in opt_state[k]
            if not torch.equal(opt_state[k][n], tp_opt[k][n])]
    check(torch.equal(loss, tp_loss) and not bad,
          f"the model-axis steps at mesh (1, 1) equal the plain steps bit "
          f"for bit (losses {loss.tolist()} vs {tp_loss.tolist()}; "
          f"{len(bad)} tensors differ: {bad[:6]})")
    res = {"plain_ms": ms, "model_axis_ms": tp_ms, "losses": loss.tolist(),
           "sharded_kernels": n_sharded}
    log("atlantis", f"model-axis video step at mesh (1, 1) equals the plain "
        f"step bit for bit over 3 steps ({n_sharded} kernels sharded); ms "
        f"a step {tp_ms:.2f} (plain {ms:.2f}; medians of steps 2-3, CUDA "
        f"events)")
    torch.cuda.empty_cache()
    return res


def atlantis_phase():
    """Phase 18: (a) the Atlantis PSPNet, (b) the RGB PNG writer, (c) the
    video trainer's model axis on one card."""
    t0 = time.perf_counter()
    res = {"pspnet": pspnet_phase(), "rgb_png": rgb_png_phase(),
           "model_axis": model_axis_phase()}
    res["seconds"] = time.perf_counter() - t0
    log("atlantis", f"phase 18 took {res['seconds']:.1f} s")
    return res


def bf16_model(model):
    """An ``AFBURR(dtype=torch.bfloat16)`` with the weights of ``model``,
    which is left as it was."""
    m16 = AFBURR(dtype=torch.bfloat16).to(DEV).eval()
    m16.load_state_dict(model.state_dict())
    return m16


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    device_phase()
    build = build_phase()
    errs, timing = kernel_phase()
    model = load_afb_urr(default_checkpoint("video"), device=DEV)
    f32_kernels = ("bank_read", "bank_read_combine", "bank_count")
    launches, state, eng, frames, labels = main_path_phase(model,
                                                           f32_kernels)
    steps = {"float32": graph_phase(model, eng, state, frames, labels,
                                    ("read_kernel", "combine_kernel",
                                     "count_kernel"))}
    del eng, state, labels
    torch.cuda.empty_cache()
    agree, cpu32 = small_agreement_phase(model)
    check(agree > 0.999, "card and CPU engines agree on > 99.9% of pixels")
    agree_m2, cpu32_m2 = small_agreement_phase(model, memorize_every=2)
    check(agree_m2 > 0.999, "memorize_every=2: card and CPU engines agree "
          "on > 99.9% of pixels")
    cc_timing = cc_phase(launches)
    image = linknet_phase()
    errs16, timing16 = kernel_phase_bf16()
    model16 = bf16_model(model)
    bf16_kernels = ("bank_read_bf16", "bank_read_combine", "bank_count_bf16")
    launches16, state16, eng16, frames, labels = main_path_phase(
        model16, bf16_kernels)
    check(eng16.model.keyval_r4.conv.weight.dtype == torch.bfloat16 and
          eng16.model.keyval_r4.conv.bias.dtype == torch.float32,
          "the bf16 engine cast its conv kernels and kept its biases")
    check(all(p.dtype == torch.float32 for p in model.parameters()) and
          all(p.dtype == torch.float32 for p in model16.parameters()),
          "building the bf16 engine left the callers' float32 weights")
    steps["bfloat16"] = graph_phase(model16, eng16, state16, frames, labels,
                                    ("read_bf16_kernel", "combine_kernel",
                                     "count_bf16_kernel"))
    del eng16, state16, labels
    torch.cuda.empty_cache()
    # bf16 labels on this clip move with any change of rounding order (the
    # convolutions of cuDNN and of the CPU sum in other orders), so the
    # card's bf16 labels are held to the CPU's as closely as bf16 itself
    # keeps to float32 on the CPU, less 0.01
    gaps = {}
    for every, cpu_f32 in ((1, cpu32), (2, cpu32_m2)):
        agree16, cpu16 = small_agreement_phase(model16, memorize_every=every)
        gap = gaps[every] = float((cpu16 == cpu_f32).mean())
        log("main", f"bf16, memorize_every {every}: card vs CPU agreement "
            f"{agree16:.6f}; bf16 vs float32 on the CPU {gap:.6f}; bar "
            f"{gap - 0.01:.6f}")
        check(agree16 >= gap - 0.01, "the bf16 card and CPU engines agree "
              "as well as bf16 and float32 do on the CPU, less 0.01")
    waterlevel, launches_wl = streaming_phase(model16, bf16_kernels)
    waterlevel["card_vs_cpu"] = streaming_agreement_phase(model)
    waterlevel["tracker"] = tracker_phase()
    waterlevel["warp"] = warp_phase()
    batch_k = {**stream_kernel_phase(torch.float32),
               **stream_kernel_phase(torch.bfloat16)}
    cc_names = KERNELS[5:]
    batch = {"resize": resize_phase()}
    batch["bfloat16"], launches_b16 = batch_main_phase(
        model16, bf16_kernels, ("read_bf16_kernel", "combine_kernel",
                                "count_bf16_kernel") + cc_names,
        gap=gaps[1], full_bank=True)
    batch["card_vs_cpu"] = batch_cpu_phase(model)
    batch["float32"], launches_b32 = batch_main_phase(
        model, f32_kernels, ("read_kernel", "combine_kernel",
                             "count_kernel") + cc_names)
    torch.cuda.empty_cache()
    stopsign, launches_nms = stopsign_phase()
    torch.cuda.empty_cache()
    people, launches_people = people_phase()
    torch.cuda.empty_cache()
    training = train_phase()
    torch.cuda.empty_cache()
    trainers = trainers_phase()
    torch.cuda.empty_cache()
    sharded, launches_sh = sharded_phase(
        model, model16, gaps[1],
        {k: v[0]["graph_ms"] for k, v in steps.items()})
    atlantis = atlantis_phase()
    kernels = kernel_rows(errs, timing, launches, build, errs16, timing16,
                          launches16)
    kernels.append(cc_row(cc_timing, launches, launches16))
    for row in kernels:
        row["launches_waterlevel"] = launches_wl[row["name"]]
        row["launches_batch"] = launches_b16[row["name"]]
        row["launches_batch_float32"] = launches_b32[row["name"]]
        row["launches_sharded"] = sum(launches_sh[dt][row["name"]]
                                      for dt in launches_sh)
        if row["name"] in batch_k:
            row["batch4"] = batch_k[row["name"]]
    kernels.append(nms_row(stopsign, launches_nms, build, people,
                           launches_people))
    log("done", f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels, "steps": steps, "image": image,
                      "waterlevel": waterlevel, "batch": batch,
                      "stopsign": stopsign, "people": people,
                      "training": training, "trainers": trainers,
                      "sharded": sharded, "atlantis": atlantis}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
