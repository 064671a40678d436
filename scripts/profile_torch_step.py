#!/usr/bin/env python3
"""Where the time of one video step goes in the PyTorch/CUDA port, on the
card.

Drives the port's main path (trained AFB-URR, 1080p synthetic frames at
the 480 operating point, two objects, 250,000-feature budget) in the
compute dtype ``--dtype`` (float32, or bfloat16: the model and the bank in
bf16, the bf16 read and count kernels), with the eager step and with the
step replayed as a CUDA graph (``--mode``), and reports, for a bank at the
main path's occupancy and for a full bank (98,304 slots per object):

- eager only: per-stage milliseconds of a step, each stage synchronised on
  both sides (host clock; the syncs add to these steps' time): query
  encode, bank read (read, combine and count kernels), decode, usage,
  memorize, bank update, the device largest-CC cleanup, and the rest
  (normalise, resizes, packing);
- the unsynchronised step time: the wall time of a run of steps with no
  synchronisation, timed with CUDA events at its two ends;
- from ``torch.profiler`` over the same steps once more: device time by
  kernel group and by each of the port's kernels. The device's idle share
  is one minus that busy time per step over the unsynchronised step time.

Every window starts from the same bank (restored in place) with an exact
occupancy bound that is not refreshed inside the window, so the graph
engine meets the same graph keys in every window: a warm-up window runs
each new key eagerly, a second captures it, and the measured windows only
replay. (Without the refresh the bound grows by every feature a frame
adds, merged ones too, so a window may visit a chunk more in the match
than the engine would.)

With ``--streams B`` (B > 1) the engine is the multi-stream
``BatchVideoSegEngine``: each step takes one frame of each of B streams
(stream s plays the clip from frame s on), the B banks are one state of
B x 2 rows, and a row's frames/s is B x 1000 / step ms.

Run from the repository root on a GPU machine:

    python3 scripts/profile_torch_step.py [--dtype bfloat16] [--mode graph]
        [--streams 4]

Prints one JSON line per mode and bank state.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (synthetic frames)
from vfloodnet_tpu_torch.memory import FeatureBank  # noqa: E402
from vfloodnet_tpu_torch.models import afb_urr  # noqa: E402
from vfloodnet_tpu_torch.pipelines import video_seg  # noqa: E402
from vfloodnet_tpu_torch.pipelines.video_seg_batch import (  # noqa: E402
    BatchVideoSegEngine)
from vfloodnet_tpu_torch.pipelines.loaders import (  # noqa: E402
    default_checkpoint, load_afb_urr)

STEPS = 6


def _timed(fn, name, acc):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[name].append(1e3 * (time.perf_counter() - t))
        return out
    return wrapper


OUR_KERNELS = ("read_bf16_kernel", "count_bf16_kernel", "read_kernel",
               "combine_kernel", "count_kernel")
CC_KERNEL = re.compile(r"(?<![a-z])cc_(init|merge|compress|argmax|keep)"
                       r"_kernel")
BANK = ("keys", "values", "valid", "birth", "usage", "occ", "peak_n",
        "replace_n")


def _group(name):
    n = name.lower()
    if CC_KERNEL.search(n):        # csrc/cc.cu
        return "largest_cc_kernel"
    # csrc/bank_read*.cu: the reads and the combine, then the counts (no
    # letter before the name, so not thread_kernel; before "gemm"'s sm90)
    if re.search(r"(?<![a-z])(read(_bf16)?|combine)_kernel", n):
        return "bank_read_kernel"
    if re.search(r"(?<![a-z])count(_bf16)?_kernel", n):
        return "bank_count_kernel"
    if any(s in n for s in ("conv", "cudnn", "xmma", "implicit", "winograd",
                            "fft", "nchw", "nhwc")):
        return "convolution"
    if any(s in n for s in ("gemm", "sgemm", "cutlass", "ampere", "sm90")):
        return "gemm"
    if "sort" in n or "radix" in n:
        return "sort"
    if "upsample" in n or "interp" in n:
        return "resize"
    return "other"


def stage_breakdown(eng, state, frames, first_idx):
    acc = defaultdict(list)
    model, fb = eng.model, eng.fb
    saved = (model.encode_query, model.decode_with_memory,
             model.memorize_streams, fb.record_usage, fb.update_device,
             afb_urr.bank_attention_read, video_seg.device_largest_cc)
    model.encode_query = _timed(model.encode_query, "query_encode", acc)
    model.decode_with_memory = _timed(model.decode_with_memory, "decode", acc)
    # memorize of one stream calls memorize_streams
    model.memorize_streams = _timed(model.memorize_streams, "memorize", acc)
    fb.record_usage = _timed(fb.record_usage, "usage", acc)
    fb.update_device = _timed(fb.update_device, "bank_update", acc)
    afb_urr.bank_attention_read = _timed(afb_urr.bank_attention_read,
                                         "bank_read", acc)
    video_seg.device_largest_cc = _timed(video_seg.device_largest_cc,
                                         "largest_cc", acc)
    try:
        for i, f in enumerate(frames):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, lab = eng.step(state, f, first_idx + i)
            torch.cuda.synchronize()
            acc["step"].append(1e3 * (time.perf_counter() - t))
    finally:
        (model.encode_query, model.decode_with_memory,
         model.memorize_streams, fb.record_usage, fb.update_device,
         afb_urr.bank_attention_read, video_seg.device_largest_cc) = saved
        for name in ("encode_query", "decode_with_memory",
                     "memorize_streams"):
            model.__dict__.pop(name, None)
        for name in ("record_usage", "update_device"):
            fb.__dict__.pop(name, None)
    med = {k: float(np.median(v)) for k, v in acc.items()}
    med["rest"] = med["step"] - sum(v for k, v in med.items() if k != "step")
    return state, med


def unsynced_steps(eng, state, frames, first_idx):
    """Milliseconds per step over ``frames`` with no synchronisation, from
    CUDA events at the run's two ends."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for i, f in enumerate(frames):
        state, _ = eng.step(state, f, first_idx + i)
    b.record()
    b.synchronize()
    return state, a.elapsed_time(b) / len(frames)


def device_profile(eng, state, frames, first_idx):
    """Device kernel time by group and by the port's kernels over
    ``frames``, and the profiled window's own wall time per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=acts) as prof:
        for i, f in enumerate(frames):
            state, lab = eng.step(state, f, first_idx + i)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t)
    groups, kernels = defaultdict(float), defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:   # kernels only, once each
            continue
        ms = evt.self_device_time_total / 1e3
        groups[_group(evt.key)] += ms
        name = next((k for k in OUR_KERNELS if k in evt.key), None)
        if CC_KERNEL.search(evt.key):
            name = "largest_cc (5 kernels)"
        if name is not None:
            kernels[name] += ms
    busy = sum(groups.values())
    n = len(frames)
    return state, {
        "profiled_wall_ms_per_step": wall_ms / n,
        "device_ms_per_step": busy / n,
        "device_ms_per_step_by_group": {k: v / n for k, v in
                                        sorted(groups.items())},
        "kernel_ms_per_step": {k: v / n for k, v in sorted(kernels.items())}}


def measure(eng, state, frames, mode):
    """The windows of one mode on one bank state (see the module doc)."""
    snap = {k: getattr(state, k).clone() for k in BANK}
    state.occ_host.refresh = lambda occ: None

    def restore():
        for k in BANK:
            getattr(state, k).copy_(snap[k])
        state.occ_host.reset(state.occ)

    for _ in range(2):                   # new keys: eager, then captured
        restore()
        unsynced_steps(eng, state, frames, 20)
    captured = len(eng.graphs)
    row = {}
    if mode == "eager":
        restore()
        row["stage_ms_median"] = stage_breakdown(eng, state, frames, 20)[1]
    restore()
    step_ms = unsynced_steps(eng, state, frames, 20)[1]
    restore()
    prof = device_profile(eng, state, frames, 20)[1]
    if len(eng.graphs) != captured:
        raise RuntimeError("a measured window captured a graph")
    del state.occ_host.refresh
    row.update({"unsynced_step_ms": step_ms, **prof,
                "device_idle_share": 1.0 - prof["device_ms_per_step"]
                / step_ms, "graphs": len(eng.graphs)})
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32",
                        help="compute dtype of the model and the bank")
    parser.add_argument("--mode", choices=("eager", "graph", "both"),
                        default="both",
                        help="the eager step, the graph replays, or both")
    parser.add_argument("--streams", type=int, default=1,
                        help="streams a step (B > 1: the batch engine)")
    args = parser.parse_args()
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        print("profile_torch_step: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    model = load_afb_urr(default_checkpoint("video"), device=dev,
                         dtype=dtype)
    b = args.streams
    clip, mask0 = chip_smoke.synthetic_clip(1 + 3 + STEPS, 1080, 1920, 0)
    frames = clip if b == 1 else [np.stack([clip[(t + s) % len(clip)]
                                            for s in range(b)])
                                  for t in range(len(clip))]
    modes = ("eager", "graph") if args.mode == "both" else (args.mode,)
    for mode in modes:
        fb = FeatureBank(obj_n=2, memory_budget=250_000, dtype=dtype,
                         device=dev)
        kw = dict(downsample=480, postprocess="device",
                  cuda_graph=mode == "graph")
        if b == 1:
            eng = video_seg.VideoSegEngine(model, fb, **kw)
            state = eng.bootstrap(frames[0], mask0)
        else:
            eng = BatchVideoSegEngine(model, fb, batch=b, **kw)
            state = eng.bootstrap(list(frames[0]), [mask0] * b)
        for i, f in enumerate(frames[1:4]):          # warm-up
            state, _ = eng.step(state, f, i + 1)
        for bank in ("main_path", "full_bank"):
            if bank == "full_bank":
                g = torch.Generator(device=dev).manual_seed(2)
                state.keys.normal_(generator=g)
                state.values.normal_(generator=g)
                state.valid.fill_(True)
                state.usage.uniform_(0.0, 5.0, generator=g)
                state.birth.zero_()
                state.occ.fill_(state.capacity)
                state.occ_host.reset(state.occ)
            occ = state.occ.tolist()
            row = {"mode": mode, "bank": bank, "dtype": str(dtype),
                   "streams": b, "occ_at_start": occ, "card": smi,
                   "weights": "trained", "steps": STEPS,
                   **measure(eng, state, frames[4:], mode)}
            row["frames_per_s"] = 1e3 * b / row["unsynced_step_ms"]
            print(json.dumps(row), flush=True)
        del eng, state, fb
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
