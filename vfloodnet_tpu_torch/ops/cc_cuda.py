"""Load and launch the largest-connected-component kernel
(``csrc/cc.cu``), built with the bank kernels by
:func:`.bank_read_cuda.build` at the first launch in a process (never at
import: the CPU tests import this module where there is no ``nvcc``).

:func:`largest_cc` checks its mask, allocates the keep mask and the
kernel's scratch with ``torch.empty``, launches on PyTorch's current
stream, raises if the launch reports an error, and adds one to
``launches["largest_cc"]``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import bank_read_cuda

# Launch count of the kernel in this process (reset with reset_launches()).
launches = {"largest_cc": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    launches["largest_cc"] = 0


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(bank_read_cuda.build()["cc"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vft_largest_cc.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.vft_largest_cc.restype = i
        lib.vft_cc_error_string.argtypes = [i]
        lib.vft_cc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def largest_cc(mask: torch.Tensor) -> torch.Tensor:
    """Largest 8-connected foreground component of each binary map of a
    uint8 CUDA tensor [..., H, W] -> uint8 {0, 1} of the same shape; ties
    go to the component with the smaller smallest raster index."""
    if mask.device.type != "cuda" or mask.dtype != torch.uint8 \
            or mask.ndim < 2:
        raise ValueError(f"largest_cc needs a uint8 CUDA tensor [..., H, W],"
                         f" got {mask.dtype} {tuple(mask.shape)} on "
                         f"{mask.device}")
    h, w = mask.shape[-2:]
    maps = mask.numel() // max(h * w, 1)
    if h * w >= 2**31 - 1:
        raise ValueError(f"map of {h} x {w} cells is too large")
    mask = mask.contiguous()
    keep = torch.empty_like(mask)
    if mask.numel() == 0:
        return keep
    lib = _load()
    dev = mask.device
    parent = torch.empty(mask.shape, dtype=torch.int32, device=dev)
    size = torch.empty(mask.shape, dtype=torch.int32, device=dev)
    best = torch.empty((maps,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.vft_largest_cc(
            mask.data_ptr(), parent.data_ptr(), size.data_ptr(),
            best.data_ptr(), keep.data_ptr(), maps, h, w,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"largest_cc kernel launch failed: "
                           f"{lib.vft_cc_error_string(err).decode()} ({err})")
    launches["largest_cc"] += 1
    return keep
