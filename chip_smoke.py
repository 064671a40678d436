#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``vfloodnet_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. build: ``nvcc`` builds the bank read / count kernels into
   ``vfloodnet_tpu_torch/_build/``.
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (P = 1620 query pixels, dk = 128, dv = 512, N = 98,304 slots,
   2 objects) for a full bank, a bound of 20,000 with valid slots past it
   (so a kernel that ignored the bound would disagree), an all-invalid bank
   and an all-invalid bank at occupancy 0 (one chunk visited); times
   of the kernel, the plain version and one ``scaled_dot_product_attention``
   call as a yardstick (the port never calls it).
4. main path: the trained AFB-URR (``records/checkpoints/video/best.npz``
   through the weight bridge) segments eight synthetic 1080p frames at the
   480 operating point
   with the device largest-CC cleanup; the kernels' launch counts of this
   run; then the same engine on a small clip against itself on the CPU,
   where the plain versions run.
5. full bank: the bank filled to capacity, two steps with LFU eviction.

Then one JSON line of the kernels' numbers and, last, ``{"ok": true,
"device": {...}}``. Any failed check raises and the exit code is not 0; the
script exits 1 with no result when CUDA is absent.
"""

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.ops import attention, bank_read_cuda, short_side_size
from vfloodnet_tpu_torch.pipelines.loaders import (default_checkpoint,
                                                   load_afb_urr)
from vfloodnet_tpu_torch.pipelines.video_seg import VideoSegEngine

T0 = time.perf_counter()
P, DK, DV, N, OBJ = 1620, 128, 512, 98304, 2
THRES = 1e-3
MEM_TOL = dict(rtol=2e-4, atol=2e-5)
F32_PEAK = 67e12     # H100 SXM float32 FLOP/s outside the tensor cores
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


def build_phase():
    t = time.perf_counter()
    path = bank_read_cuda.build()
    log("build", f"{path} in {time.perf_counter() - t:.2f}s (nvcc "
        f"{bank_read_cuda.build_seconds})")


def _plain(q, keys, values, valid, occ):
    """The plain versions per object: (mem, m, l) and the counts."""
    outs = [attention._read_occ_sweep(keys[o], values[o], valid[o], q,
                                      attention.OCC_CHUNK, occ)
            for o in range(OBJ)]
    mem = torch.stack([o[0] for o in outs])
    m = torch.stack([o[1] for o in outs])
    l = torch.stack([o[2] for o in outs])
    log_thres = math.log(THRES) + torch.log(l) + m
    cnt = torch.stack([attention._count_occ_sweep(
        keys[o], valid[o], q, log_thres[o], attention.OCC_CHUNK, occ)
        for o in range(OBJ)])
    return mem, log_thres, cnt


def kernel_phase():
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(SEED)
    keys = torch.randn(OBJ, N, DK, device=dev, generator=g)
    values = torch.randn(OBJ, N, DV, device=dev, generator=g)
    # q at 3x scale: a peaked softmax, so a few probabilities pass 1e-3
    q = 3.0 * torch.randn(P, DK, device=dev, generator=g)
    rand_valid = torch.rand(OBJ, N, device=dev, generator=g) < 0.9
    slot = torch.arange(N, device=dev)[None].expand(OBJ, N)
    none_valid = torch.zeros(OBJ, N, dtype=torch.bool, device=dev)
    cases = {
        "full": (rand_valid, N),
        "occ20000": (rand_valid, 20000),
        "all_invalid": (none_valid, N),
        "all_invalid_occ0": (none_valid, 0),
    }
    rows = {}
    for name, (valid, occ) in cases.items():
        valid = valid.contiguous()
        occ_t = torch.tensor([occ], dtype=torch.int32, device=dev)
        mem_k, _, _ = bank_read_cuda.bank_read(q, keys, values, valid, occ_t,
                                               attention.OCC_CHUNK)
        mem_p, log_thres, cnt_p = _plain(q, keys, values, valid, occ)
        cnt_k = bank_read_cuda.bank_count(q, keys, valid, occ_t, log_thres,
                                          attention.OCC_CHUNK)
        torch.cuda.synchronize()
        check(torch.isfinite(mem_k).all().item(), f"{name}: mem finite")
        mem_err = (mem_k - mem_p).abs().max().item()
        mem_ok = torch.allclose(mem_k, mem_p, **MEM_TOL)
        cnt_diff = (cnt_k - cnt_p).abs()
        n_mismatch = int((cnt_diff > 0).sum())
        cnt_err = cnt_diff.max().item()
        n_visit = attention.visited_slots(N, attention.OCC_CHUNK, occ)
        beyond = cnt_k[:, min(n_visit, N):].abs().sum().item()
        log("kernels", f"{name}: mem max|err| {mem_err:.3e}, cnt slots "
            f"differing {n_mismatch} (max |diff| {cnt_err}), cnt total "
            f"{cnt_k.sum().item():.0f}, cnt beyond bound {beyond}")
        check(mem_ok, f"{name}: mem within rtol 2e-4 atol 2e-5")
        check(cnt_err <= 1.0, f"{name}: cnt |diff| <= 1 per slot")
        check(beyond == 0, f"{name}: no counts beyond the bound")
        rows[name] = (mem_err, cnt_err)
        if name.startswith("all_invalid"):
            # every score is -1e30: a uniform mean over the visited slots
            want = values[:, :n_visit].mean(1, keepdim=True).expand_as(mem_k)
            check(cnt_k.sum().item() == 0, f"{name}: counts are 0")
            check(torch.allclose(mem_k, want, **MEM_TOL),
                  f"{name}: mem is the mean of the first {n_visit} values")
        if name == "occ20000":
            # the case tells a bounded loop from one over the whole bank
            unbounded = _plain(q, keys, values, valid, N)[0]
            check(not torch.allclose(mem_k, unbounded, **MEM_TOL),
                  "occ20000: the unbounded read differs from the bounded")
        if name != "full":
            continue
        check(cnt_k.sum().item() > 0, "full bank has nonzero counts")
        read_ms = time_ms(lambda: bank_read_cuda.bank_read(
            q, keys, values, valid, occ_t, attention.OCC_CHUNK))
        count_ms = time_ms(lambda: bank_read_cuda.bank_count(
            q, keys, valid, occ_t, log_thres, attention.OCC_CHUNK))
        plain_read_ms = time_ms(lambda: [attention._read_occ_sweep(
            keys[o], values[o], valid[o], q, attention.OCC_CHUNK, occ)
            for o in range(OBJ)], reps=5)
        plain_count_ms = time_ms(lambda: [attention._count_occ_sweep(
            keys[o], valid[o], q, log_thres[o], attention.OCC_CHUNK, occ)
            for o in range(OBJ)], reps=5)
        qb = q[None, None].expand(OBJ, 1, P, DK)
        mask = valid[:, None, None, :]
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qb, keys[:, None], values[:, None], attn_mask=mask), reps=5)
        n_vis = n_visit
        read_flop = OBJ * 2 * P * n_vis * (DK + DV)
        read_bytes = 4 * (P * DK + OBJ * n_vis * (DK + DV)
                          + OBJ * P * (DV + 2)) + OBJ * n_vis
        count_flop = OBJ * 2 * P * n_vis * DK
        count_bytes = 4 * (P * DK + OBJ * n_vis * DK + OBJ * P + OBJ * N) \
            + OBJ * n_vis
        timing = dict(
            read=(read_ms, plain_read_ms, sdpa_ms,
                  1e3 * max(read_flop / F32_PEAK, read_bytes / HBM_RATE),
                  "operations" if read_flop / F32_PEAK > read_bytes / HBM_RATE
                  else "bytes"),
            count=(count_ms, plain_count_ms, None,
                   1e3 * max(count_flop / F32_PEAK, count_bytes / HBM_RATE),
                   "operations" if count_flop / F32_PEAK >
                   count_bytes / HBM_RATE else "bytes"))
        log("kernels", f"full: read {read_ms:.3f} ms (plain "
            f"{plain_read_ms:.3f}, sdpa {sdpa_ms:.3f}, bound "
            f"{timing['read'][3]:.3f}); count "
            f"{count_ms:.3f} ms (plain {plain_count_ms:.3f}, bound "
            f"{timing['count'][3]:.3f})")
    del keys, values
    torch.cuda.empty_cache()
    return rows, timing


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


def main_path_phase(model):
    frames, mask0 = synthetic_clip(9, *FRAME_HW, SEED)
    fb = FeatureBank(obj_n=2, memory_budget=BUDGET, device=DEV)
    check(fb.class_budget == N, "98,304 slots per object")
    eng = VideoSegEngine(model, fb, downsample=DOWNSAMPLE,
                         postprocess="device")
    bank_read_cuda.reset_launches()
    state = eng.bootstrap(frames[0], mask0)
    step_ms, labels = [], []
    for i, f in enumerate(frames[1:]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, lab = eng.step(state, f, i + 1)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        labels.append(lab)
    launches = dict(bank_read_cuda.launches)
    for lab in labels:
        arr = eng.fetch_label(lab)
        check(arr.shape == FRAME_HW and arr.dtype == np.uint8,
              f"label shape {arr.shape} {arr.dtype}")
        check(set(np.unique(arr)) <= {0, 1}, "labels in {0, 1}")
    check(launches["bank_read"] > 0 and launches["bank_count"] > 0,
          f"main path launched both kernels: {launches}")
    warm = step_ms[1:]
    water = float(np.mean([eng.fetch_label(lab).mean() for lab in labels]))
    h, w = short_side_size(*FRAME_HW, DOWNSAMPLE)
    log("main", f"trained weights, 8 steps of {FRAME_HW} -> {(h, w)} (P = "
        f"{-(-h // 16) * -(-w // 16)}): first step {step_ms[0]:.1f} ms, "
        f"then per step {['%.1f' % s for s in warm]} ms, median "
        f"{np.median(warm):.1f} ms = {1e3 / np.median(warm):.2f} frames/s; "
        f"occ {state.occ.tolist()}; launches {launches}; water fraction "
        f"{water:.3f}")
    return launches, state, eng


def small_agreement_phase(model):
    """The same engine on a 240-px clip, on the card (kernels) and on the
    CPU (plain versions), from the same weights."""
    frames, mask0 = synthetic_clip(4, 240, 427, SEED + 1)
    out = {}
    for dev in (DEV, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev)
        eng = VideoSegEngine(m, FeatureBank(obj_n=2, memory_budget=65_536,
                                            device=dev),
                             downsample=240, postprocess="device")
        state = eng.bootstrap(frames[0], mask0)
        labs = []
        for i, f in enumerate(frames[1:]):
            state, lab = eng.step(state, f, i + 1)
            labs.append(eng.fetch_label(lab))
        out[dev.type] = np.stack(labs)
    agree = float((out[DEV.type] == out["cpu"]).mean())
    log("main", f"small clip 240x427, 3 steps: card vs CPU label agreement "
        f"{agree:.6f}")
    check(agree > 0.999, "card and CPU engines agree on > 99.9% of pixels")


def full_bank_phase(eng, state):
    g = torch.Generator(device=DEV).manual_seed(SEED + 2)
    state.keys.normal_(generator=g)
    state.values.normal_(generator=g)
    state.valid.fill_(True)
    state.usage.uniform_(0.0, 5.0, generator=g)
    state.birth.zero_()
    cap = state.capacity
    state.occ.fill_(cap)
    replaced0 = state.replace_n.clone()
    frames, _ = synthetic_clip(2, *FRAME_HW, SEED + 3)
    step_ms = []
    for i, f in enumerate(frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, lab = eng.step(state, f, 20 + i)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        check(eng.fetch_label(lab).shape == FRAME_HW, "full-bank label")
    evicted = (state.replace_n - replaced0).tolist()
    check(state.occ.tolist() == [cap, cap], f"occ stays {cap}: {state.occ}")
    check(min(evicted) > 0, f"eviction ran: {evicted}")
    check(bool(torch.isfinite(state.keys).all() and
               torch.isfinite(state.values).all()), "bank finite")
    log("full_bank", f"2 steps at occ {cap}: {['%.1f' % s for s in step_ms]} "
        f"ms; evicted {evicted}")


def kernel_rows(errs, timing, launches):
    """One row per kernel for the result's JSON line."""
    rows = []
    for name, key, line, idx in (("bank_read", "read", 29, 0),
                                 ("bank_count", "count", 67, 1)):
        ms, plain_ms, lib_ms, bound_ms, bound_by = timing[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": "vfloodnet_tpu_torch/csrc/bank_read.cu",
            "replaces": f"vfloodnet_tpu/ops/attention_pallas.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(e[idx] for e in errs.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms})
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    device_phase()
    build_phase()
    errs, timing = kernel_phase()
    model = load_afb_urr(default_checkpoint("video"), device=DEV)
    launches, state, eng = main_path_phase(model)
    small_agreement_phase(model)
    full_bank_phase(eng, state)
    kernels = kernel_rows(errs, timing, launches)
    log("done", f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
