"""Load and launch the greedy-NMS kernel (``csrc/nms.cu``), built with the
bank and CC kernels by :func:`.bank_read_cuda.build` at the first launch
in a process (never at import: the CPU tests import this module where
there is no ``nvcc``).

:func:`nms` checks its tensors, allocates the outputs and the kernel's
scratch (the sorted order and the suppression bit-matrix) with
``torch.empty``, launches on PyTorch's current stream, raises if the
launch reports an error, and adds one to ``launches["nms"]``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import bank_read_cuda

# Launch count of the kernel in this process (reset with reset_launches()).
launches = {"nms": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    launches["nms"] = 0


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(bank_read_cuda.build()["nms"])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vft_nms.argtypes = [p, p, i, f, f, i, p, p, p, p, p, p]
        lib.vft_nms.restype = i
        lib.vft_nms_words.argtypes = [i]
        lib.vft_nms_words.restype = i
        lib.vft_nms_error_string.argtypes = [i]
        lib.vft_nms_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int, score_threshold: float = 0.0
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS of float32 CUDA boxes [N, 4] (xyxy) by scores [N]:
    (keep_idx [max_out] int64, 0 where absent; keep_scores, -inf where
    absent; valid), equal to :func:`.nms.nms_plain`."""
    n = boxes.shape[0]
    if boxes.device.type != "cuda" or boxes.dtype != torch.float32 \
            or boxes.shape != (n, 4) or scores.shape != (n,) \
            or scores.dtype != torch.float32 or scores.device != boxes.device:
        raise ValueError(f"nms needs float32 CUDA boxes [N, 4] and scores "
                         f"[N], got {boxes.dtype} {tuple(boxes.shape)} and "
                         f"{scores.dtype} {tuple(scores.shape)} on "
                         f"{boxes.device} / {scores.device}")
    if n < 1 or max_out < 1:
        raise ValueError(f"nms needs N >= 1 and max_out >= 1, got {n}, "
                         f"{max_out}")
    lib = _load()
    words = lib.vft_nms_words(n)
    if words * 8 > 48 * 1024:
        raise ValueError(f"nms takes at most {48 * 1024 * 8} boxes, got {n}")
    dev = boxes.device
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:          # the kernel reads a box as a float4
        boxes = boxes.clone()
    scores = scores.contiguous()
    order = torch.empty((n,), dtype=torch.int32, device=dev)
    mask = torch.empty((n, words), dtype=torch.int64, device=dev)
    keep_idx = torch.empty((max_out,), dtype=torch.int64, device=dev)
    keep_scores = torch.empty((max_out,), dtype=torch.float32, device=dev)
    valid = torch.empty((max_out,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = lib.vft_nms(
            boxes.data_ptr(), scores.data_ptr(), n, float(iou_threshold),
            float(score_threshold), max_out, order.data_ptr(),
            mask.data_ptr(), keep_idx.data_ptr(), keep_scores.data_ptr(),
            valid.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: "
                           f"{lib.vft_nms_error_string(err).decode()} "
                           f"({err})")
    launches["nms"] += 1
    return keep_idx, keep_scores, valid
