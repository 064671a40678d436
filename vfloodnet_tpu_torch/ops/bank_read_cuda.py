"""Build, load and launch the bank read, combine and count kernels:
float32 (``csrc/bank_read.cu``: read, combine, count) and bf16
(``csrc/bank_read_bf16.cu``: read, count; its partials go through the
float32 combine). :func:`build` also builds the largest-CC library
(``csrc/cc.cu``) that :mod:`.cc_cuda` loads and the greedy-NMS library
(``csrc/nms.cu``) that :mod:`.nms_cuda` loads.

Each source is compiled with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``, at the first launch in a process (never
at import: the CPU tests import this module where there is no ``nvcc``).
The ``nvcc`` runs start together. The libraries go to
``vfloodnet_tpu_torch/_build/``, named by the hash of every source and
header under ``csrc/`` and of the flags, so an edited file is rebuilt and
an unchanged tree is reused. A build writes to a private temporary name
and renames it into place, so there is no lock file to go stale.

The read and the count dispatch on the bank's dtype (float32 or bf16); any
other dtype raises. Both take the query of one stream, q [P, dk], read by
every object of the bank, or of B streams, q [B, P, dk], with the banks of
the B streams folded along the object axis (obj = B x objects a stream;
object o reads plane o // (obj / B)): one launch serves every stream.
Each wrapper checks its tensors, allocates its outputs (and the read's
per-segment partials) with ``torch.empty``, launches on
PyTorch's current stream, raises if the launch reports an error, and adds
one to its kernel's entry in :data:`launches`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import math
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
# library name -> its source under CSRC (``cc`` is the largest-CC kernel
# of :mod:`.cc_cuda` and ``nms`` the NMS kernel of :mod:`.nms_cuda`, built
# here with the others)
SOURCES = {"bank_read": "bank_read.cu", "bank_read_bf16": "bank_read_bf16.cu",
           "cc": "cc.cu", "nms": "nms.cu"}
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DK, DV = 128, 512
# Bank slots per tile of the float32 and bf16 read kernels (a segment is a
# whole number of them) and query rows per tile; checked against each
# library at load.
READ_TILE, READ_TILE_BF16, QUERY_TILE = 32, 64, 64
MAX_SPLITS = 8
# Bank slots per work item of the bf16 count kernel, and the most query
# tiles one item may take (its hit counters are 16 bits wide).
COUNT_TILE_BF16, COUNT_MAX_QTILES = 512, 1023

# Launch counts of the kernels in this process (reset with
# reset_launches()); a run reads them to show which kernels it went through.
launches = {"bank_read": 0, "bank_read_combine": 0, "bank_count": 0,
            "bank_read_bf16": 0, "bank_count_bf16": 0}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None   # wall time of the last build
build_log: Dict[str, str] = {}   # library name -> ptxas's report


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the bank read kernels need the "
                           "CUDA toolkit to build")
    return path


def _csrc_files() -> list:
    """Every source and header the build reads, in a fixed order."""
    return sorted(f for pat in ("*.cu", "*.cuh", "*.h")
                  for f in glob.glob(os.path.join(CSRC, pat)))


def library_path(name: str = "bank_read") -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _csrc_files():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build() -> Dict[str, str]:
    """Compile every library whose current sources have none yet, all
    ``nvcc`` runs at once; returns {library name: path}. Sets
    :data:`build_seconds` when it compiled, and :data:`build_log`
    (registers, shared memory and spills of each kernel, from
    ``-Xptxas -v``, kept beside each library)."""
    global build_seconds
    paths = {name: library_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not os.path.exists(p)}
    for name, p in paths.items():
        if name not in todo and name not in build_log \
                and os.path.exists(p[:-3] + ".log"):
            with open(p[:-3] + ".log") as f:
                build_log[name] = f.read()
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, p in todo.items():
        tmp = f"{p}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC, SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs = {name: proc.communicate(timeout=600)[0]
               for name, (_, proc) in procs.items()}
    failed = {name: out for name, out in outputs.items()
              if procs[name][1].returncode != 0}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({procs[name][1].returncode}):\n{out}"
            for name, out in failed.items()))
    for name, (tmp, _) in procs.items():
        log_path = todo[name][:-3] + ".log"
        build_log[name] = outputs[name]
        with open(f"{log_path}.{os.getpid()}.tmp", "w") as f:
            f.write(outputs[name])
        os.replace(f"{log_path}.{os.getpid()}.tmp", log_path)
        os.replace(tmp, todo[name])
    build_seconds = time.perf_counter() - t0
    return paths


def _load(name: str = "bank_read") -> ctypes.CDLL:
    if not _libs:
        paths = build()
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib = ctypes.CDLL(paths["bank_read"])
        lib.vft_bank_read.argtypes = [p, p, p, p, p, p, p, p,
                                      i, i, i, i, i, i, f, p]
        lib.vft_bank_read.restype = i
        lib.vft_bank_combine.argtypes = [p, p, p, p, p, p, p, i, i, i, f, p]
        lib.vft_bank_combine.restype = i
        lib.vft_bank_count.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f,
                                       p]
        lib.vft_bank_count.restype = i
        lib.vft_bank_dims.argtypes = [ctypes.POINTER(i)] * 4
        lib.vft_bank_dims.restype = i
        lib.vft_error_string.argtypes = [i]
        lib.vft_error_string.restype = ctypes.c_char_p
        lib16 = ctypes.CDLL(paths["bank_read_bf16"])
        lib16.vft_bank_read_bf16.argtypes = lib.vft_bank_read.argtypes
        lib16.vft_bank_read_bf16.restype = i
        lib16.vft_bank_count_bf16.argtypes = lib.vft_bank_count.argtypes
        lib16.vft_bank_count_bf16.restype = i
        lib16.vft_bf16_dims.argtypes = [ctypes.POINTER(i)] * 4
        lib16.vft_bf16_dims.restype = i
        for dims_fn, tile in ((lib.vft_bank_dims, READ_TILE),
                              (lib16.vft_bf16_dims, READ_TILE_BF16)):
            dims = [i() for _ in range(4)]
            dims_fn(*map(ctypes.byref, dims))
            got = tuple(d.value for d in dims)
            if got != (DK, DV, tile, QUERY_TILE):
                raise RuntimeError(f"kernel dims {got} != "
                                   f"{(DK, DV, tile, QUERY_TILE)}")
        _libs.update(bank_read=lib, bank_read_bf16=lib16)
    return _libs[name]


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned "
                         f"{dtype} tensor of shape {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _libs["bank_read"].vft_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _bank_dtype(keys: torch.Tensor) -> torch.dtype:
    if keys.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the bank kernels take float32 or bfloat16 "
                         f"banks, got {keys.dtype}")
    return keys.dtype


def _query_planes(q: torch.Tensor, obj_n: int) -> int:
    """Query planes B of q [P, dk] (1) or [B, P, dk]; B must divide the
    bank's objects."""
    planes = 1 if q.ndim == 2 else q.shape[0]
    if q.ndim not in (2, 3) or planes < 1 or obj_n % planes:
        raise ValueError(f"q must be [P, {DK}] or [B, P, {DK}] with B "
                         f"dividing the bank's {obj_n} objects, got "
                         f"{tuple(q.shape)}")
    return planes


def _occ_ptr(occ_bound, device) -> Optional[int]:
    if occ_bound is None:
        return None
    _check(occ_bound, "occ_bound", torch.int32, (1,), device)
    return occ_bound.data_ptr()


def read_tile(dtype: torch.dtype) -> int:
    """Bank slots per tile of the read kernel for a bank of ``dtype``: a
    segment of the read is a whole number of them."""
    return READ_TILE_BF16 if dtype == torch.bfloat16 else READ_TILE


def count_splits(slot_tiles: int, q_tiles: int, sms: int) -> int:
    """Query-tile shares of each slot tile in the bf16 count kernel, which
    makes this choice on the device from the visited slots (the same rule
    as ``count_splits`` in ``csrc/bank_read_bf16.cu``). Its grid is one
    block per SM, walking over slot_tiles x shares items: one share when
    the slot tiles alone fill the ``sms`` blocks; else the share count s in
    [ceil(sms / slot_tiles), 2 ceil(sms / slot_tiles)] (at most q_tiles)
    whose items leave the least of the last round idle (the smallest such
    s); never fewer than ceil(q_tiles / COUNT_MAX_QTILES). At one
    8,192-slot chunk of 2 objects (32 slot tiles) and P = 1620 (26 query
    tiles) on 132 SMs that is 8 shares: 256 items, 97 % of two rounds."""
    least = -(-q_tiles // COUNT_MAX_QTILES)
    if slot_tiles >= sms:
        return least
    lo = max(min(-(-sms // slot_tiles), q_tiles), least)
    hi = max(min(2 * lo, q_tiles), lo)

    def fill(s):
        items = slot_tiles * s
        return items / (-(-items // sms) * sms)

    return max(range(lo, hi + 1), key=lambda s: (fill(s), -s))


def default_splits(obj_n: int, p: int, sms: int) -> int:
    """Bank segments S of the read: the S in 1..MAX_SPLITS whose grid of
    obj_n x ceil(p / QUERY_TILE) x S one-block-per-SM blocks leaves the
    least of the last wave idle (the smallest such S). At the main path's
    2 objects x 26 query tiles on 132 SMs that is S = 5 (260 blocks, 98.5 %
    of two waves), whatever the bank's occupancy; at 4 streams of 2 objects
    (8 objects folded) S = 5 too (1,040 blocks, 98.5 % of eight waves)."""
    tiles = obj_n * -(-p // QUERY_TILE)

    def fill(s):
        blocks = tiles * s
        return blocks / (-(-blocks // sms) * sms)

    return max(range(1, MAX_SPLITS + 1), key=lambda s: (fill(s), -s))


def bank_read_partials(q: torch.Tensor, keys: torch.Tensor,
                       values: torch.Tensor, valid: torch.Tensor,
                       occ_bound: Optional[torch.Tensor], chunk: int,
                       splits: int):
    """Read kernel over ``splits`` segments of the visited bank: q [P, dk]
    or [B, P, dk] (see the module's note on streams), keys [obj, N, dk],
    values [obj, N, dv] of one dtype (float32: the
    3xTF32 ``read_kernel``; bfloat16: ``read_bf16_kernel``), valid
    [obj, N] bool, occ_bound [1] int32 on the device or None -> (m_s
    [obj, S, P], l_s [obj, S, P], acc_s [obj, S, P, dv]), float32; acc_s is
    not normalised."""
    obj_n, n, _ = keys.shape
    p = q.shape[-2]
    dev = keys.device
    if dev.type != "cuda" or p == 0 or n == 0:
        raise ValueError("bank_read needs CUDA tensors with P, N > 0")
    if not 1 <= splits <= 65535:
        raise ValueError(f"splits must be in 1..65535, got {splits}")
    dt = _bank_dtype(keys)
    planes = _query_planes(q, obj_n)
    _check(q, "q", dt, tuple(q.shape[:-2]) + (p, DK), dev)
    _check(keys, "keys", dt, (obj_n, n, DK), dev)
    _check(values, "values", dt, (obj_n, n, DV), dev)
    _check(valid, "valid", torch.bool, (obj_n, n), dev)
    name = "bank_read" if dt == torch.float32 else "bank_read_bf16"
    launch = getattr(_load(name), "vft_" + name)
    m_s = torch.empty((obj_n, splits, p), dtype=torch.float32, device=dev)
    l_s = torch.empty((obj_n, splits, p), dtype=torch.float32, device=dev)
    acc_s = torch.empty((obj_n, splits, p, DV), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), keys.data_ptr(), values.data_ptr(),
            valid.data_ptr(), _occ_ptr(occ_bound, dev), m_s.data_ptr(),
            l_s.data_ptr(), acc_s.data_ptr(), p, n, obj_n, planes, chunk,
            splits, 1.0 / math.sqrt(DK),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    launches[name] += 1
    return m_s, l_s, acc_s


def bank_read_combine(m_s: torch.Tensor, l_s: torch.Tensor,
                      acc_s: torch.Tensor, thres: float):
    """Combine kernel: the read's segments m_s, l_s [obj, S, P], acc_s
    [obj, S, P, dv] -> (mem [obj, P, dv], m, l, log_thres [obj, P]), with
    l clamped at 1e-30 and log_thres = log(thres) + log(l) + m."""
    obj_n, splits, p = m_s.shape
    dev = m_s.device
    if dev.type != "cuda" or p == 0:
        raise ValueError("bank_read_combine needs CUDA tensors with P > 0")
    _check(m_s, "m_s", torch.float32, (obj_n, splits, p), dev)
    _check(l_s, "l_s", torch.float32, (obj_n, splits, p), dev)
    _check(acc_s, "acc_s", torch.float32, (obj_n, splits, p, DV), dev)
    lib = _load()
    mem = torch.empty((obj_n, p, DV), dtype=torch.float32, device=dev)
    m, l, log_thres = (torch.empty((obj_n, p), dtype=torch.float32,
                                   device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        err = lib.vft_bank_combine(
            m_s.data_ptr(), l_s.data_ptr(), acc_s.data_ptr(), mem.data_ptr(),
            m.data_ptr(), l.data_ptr(), log_thres.data_ptr(), p, obj_n,
            splits, math.log(thres), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "bank_read_combine")
    launches["bank_read_combine"] += 1
    return mem, m, l, log_thres


def bank_read(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
              valid: torch.Tensor, occ_bound: Optional[torch.Tensor],
              chunk: int, thres: float = 1e-3):
    """Read over :func:`default_splits` segments for this card, then
    combine: (mem [obj, P, dv], m [obj, P], l [obj, P], log_thres
    [obj, P]), all float32 whatever the bank's dtype."""
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    parts = bank_read_partials(q, keys, values, valid, occ_bound, chunk,
                               default_splits(keys.shape[0], q.shape[-2],
                                              sms))
    return bank_read_combine(*parts, thres)


def bank_count(q: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
               occ_bound: Optional[torch.Tensor], log_thres: torch.Tensor,
               chunk: int) -> torch.Tensor:
    """Count kernel: q [P, dk] or [B, P, dk] and keys [obj, N, dk] of one
    dtype (float32:
    ``count_kernel``; bfloat16: ``count_bf16_kernel``, one block per SM
    over the items of :func:`count_splits`), valid [obj, N]
    bool, occ_bound [1] int32 or None, log_thres [obj, P] float32 -> cnt
    [obj, N] float32."""
    obj_n, n, _ = keys.shape
    p = q.shape[-2]
    dev = keys.device
    if dev.type != "cuda" or p == 0 or n == 0:
        raise ValueError("bank_count needs CUDA tensors with P, N > 0")
    dt = _bank_dtype(keys)
    planes = _query_planes(q, obj_n)
    _check(q, "q", dt, tuple(q.shape[:-2]) + (p, DK), dev)
    _check(keys, "keys", dt, (obj_n, n, DK), dev)
    _check(valid, "valid", torch.bool, (obj_n, n), dev)
    log_thres = log_thres.contiguous()
    _check(log_thres, "log_thres", torch.float32, (obj_n, p), dev)
    name = "bank_count" if dt == torch.float32 else "bank_count_bf16"
    launch = getattr(_load("bank_read" if dt == torch.float32
                           else "bank_read_bf16"), "vft_" + name)
    # the bf16 kernel adds its counts into zeros; the float32 one writes
    # every slot
    cnt = (torch.empty if dt == torch.float32 else torch.zeros)(
        (obj_n, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), keys.data_ptr(), valid.data_ptr(),
            _occ_ptr(occ_bound, dev), log_thres.data_ptr(), cnt.data_ptr(),
            p, n, obj_n, planes, chunk, 1.0 / math.sqrt(DK),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    launches[name] += 1
    return cnt
