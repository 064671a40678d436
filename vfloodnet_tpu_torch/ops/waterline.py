"""Mask -> waterline scans on the device (counterpart of
``vfloodnet_tpu.ops.waterline``).

For a column and a start row, the first row strictly below the start where
the mask holds the water label (reference
estimation/reference_tracking.py:197-204 scans it pixel by pixel in
Python). :func:`waterline_below_batch` scans T (column, row) pairs in one
gather and one min, with the pairs in [T] tensors, so a step that scans
every reference object makes no host read. Column indices follow JAX's
gather: a negative index counts from the right, then indices are clamped
into the mask.
"""

from __future__ import annotations

import torch


def waterline_scan(mask: torch.Tensor, water_label: int = 1) -> torch.Tensor:
    """For each column of ``mask`` [H, W], the first row where it equals
    ``water_label``: int32 [W], H where a column has none."""
    h = mask.shape[0]
    rows = torch.arange(h, dtype=torch.int32, device=mask.device)[:, None]
    first = torch.where(mask == water_label, rows, h)
    return first.amin(dim=0).to(torch.int32)


def waterline_below_batch(mask: torch.Tensor, cols: torch.Tensor,
                          start_rows: torch.Tensor,
                          water_label: int = 1) -> torch.Tensor:
    """For T pairs (``cols[t]``, ``start_rows[t]``), int32 [T] tensors on
    the mask's device, the first water row of that column strictly below
    that row: int32 [T], H where there is none."""
    h, w = mask.shape
    cols = torch.where(cols < 0, cols + w, cols).clamp(0, w - 1)
    column = mask.index_select(1, cols.to(torch.int64))          # [H, T]
    rows = torch.arange(h, dtype=torch.int32, device=mask.device)[:, None]
    hit = (column == water_label) & (rows > start_rows[None, :])
    return torch.where(hit, rows, h).amin(dim=0).to(torch.int32)


def waterline_below(mask: torch.Tensor, col, start_row,
                    water_label: int = 1) -> torch.Tensor:
    """:func:`waterline_below_batch` of one pair (ints or one-element
    tensors): a 0-d int32 tensor."""
    dev = mask.device
    col = torch.as_tensor(col, dtype=torch.int32, device=dev).reshape(1)
    row = torch.as_tensor(start_row, dtype=torch.int32,
                          device=dev).reshape(1)
    return waterline_below_batch(mask, col, row, water_label)[0]
