"""Build, load and launch the bank read and count kernels
(``csrc/bank_read.cu``).

The source is compiled with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``, at the first launch in a process (never
at import: the CPU tests import this module where there is no ``nvcc``).
The library goes to ``vfloodnet_tpu_torch/_build/``, named by the hash of
the source, so an edited source is rebuilt and an unchanged one is reused.
A build writes to a private temporary name and renames it into place, so
there is no lock file to go stale.

Each wrapper checks its tensors, allocates the outputs with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch reports an
error, and adds one to its entry in :data:`launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "bank_read.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
DK, DV = 128, 512

# Launch counts of the two kernels in this process (reset with
# reset_launches()); a run reads them to show which kernels it went through.
launches = {"bank_read": 0, "bank_count": 0}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


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


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"bank_read_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library of the current source exists;
    returns its path. Sets :data:`build_seconds` when it compiled."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    return path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vft_bank_read.argtypes = [p, p, p, p, p, p, p, p,
                                      i, i, i, i, f, p]
        lib.vft_bank_read.restype = i
        lib.vft_bank_count.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]
        lib.vft_bank_count.restype = i
        lib.vft_bank_dims.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.vft_bank_dims.restype = i
        lib.vft_error_string.argtypes = [i]
        lib.vft_error_string.restype = ctypes.c_char_p
        dk, dv = i(), i()
        lib.vft_bank_dims(ctypes.byref(dk), ctypes.byref(dv))
        if (dk.value, dv.value) != (DK, DV):
            raise RuntimeError(f"kernel dims {dk.value}/{dv.value} != "
                               f"{DK}/{DV}")
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned "
                         f"{dtype} tensor of shape {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib.vft_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _occ_ptr(occ_bound, device) -> Optional[int]:
    if occ_bound is None:
        return None
    _check(occ_bound, "occ_bound", torch.int32, (1,), device)
    return occ_bound.data_ptr()


def bank_read(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
              valid: torch.Tensor, occ_bound: Optional[torch.Tensor],
              chunk: int):
    """Read kernel: q [P, dk], keys [obj, N, dk], values [obj, N, dv],
    valid [obj, N] bool, occ_bound [1] int32 on the device or None ->
    (mem [obj, P, dv], m [obj, P], l [obj, P]), all float32."""
    obj_n, n, _ = keys.shape
    p = q.shape[0]
    dev = keys.device
    if dev.type != "cuda" or p == 0 or n == 0:
        raise ValueError("bank_read needs CUDA tensors with P, N > 0")
    _check(q, "q", torch.float32, (p, DK), dev)
    _check(keys, "keys", torch.float32, (obj_n, n, DK), dev)
    _check(values, "values", torch.float32, (obj_n, n, DV), dev)
    _check(valid, "valid", torch.bool, (obj_n, n), dev)
    lib = _load()
    mem = torch.empty((obj_n, p, DV), dtype=torch.float32, device=dev)
    m = torch.empty((obj_n, p), dtype=torch.float32, device=dev)
    l = torch.empty((obj_n, p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.vft_bank_read(
            q.data_ptr(), keys.data_ptr(), values.data_ptr(),
            valid.data_ptr(), _occ_ptr(occ_bound, dev), mem.data_ptr(),
            m.data_ptr(), l.data_ptr(), p, n, obj_n, chunk,
            1.0 / math.sqrt(DK), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "bank_read")
    launches["bank_read"] += 1
    return mem, m, l


def bank_count(q: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
               occ_bound: Optional[torch.Tensor], log_thres: torch.Tensor,
               chunk: int) -> torch.Tensor:
    """Count kernel: q [P, dk], keys [obj, N, dk], valid [obj, N] bool,
    occ_bound [1] int32 or None, log_thres [obj, P] float32 -> cnt
    [obj, N] float32."""
    obj_n, n, _ = keys.shape
    p = q.shape[0]
    dev = keys.device
    if dev.type != "cuda" or p == 0 or n == 0:
        raise ValueError("bank_count needs CUDA tensors with P, N > 0")
    _check(q, "q", torch.float32, (p, DK), dev)
    _check(keys, "keys", torch.float32, (obj_n, n, DK), dev)
    _check(valid, "valid", torch.bool, (obj_n, n), dev)
    log_thres = log_thres.contiguous()
    _check(log_thres, "log_thres", torch.float32, (obj_n, p), dev)
    lib = _load()
    cnt = torch.empty((obj_n, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.vft_bank_count(
            q.data_ptr(), keys.data_ptr(), valid.data_ptr(),
            _occ_ptr(occ_bound, dev), log_thres.data_ptr(), cnt.data_ptr(),
            p, n, obj_n, chunk, 1.0 / math.sqrt(DK),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "bank_count")
    launches["bank_count"] += 1
    return cnt
