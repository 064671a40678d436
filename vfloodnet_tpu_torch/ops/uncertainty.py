"""URR uncertainty (counterpart of ``vfloodnet_tpu.ops.uncertainty``)."""

from __future__ import annotations

import torch


def calc_uncertainty(score: torch.Tensor, obj_axis: int = -1) -> torch.Tensor:
    """``exp(1 - top1 / (top2 + 1e-8))`` over the object axis, which is
    kept with size 1: ~0 where one object dominates, ~1 where two tie."""
    top2 = torch.topk(score.movedim(obj_axis, -1), 2, dim=-1).values
    unc = torch.exp(1.0 - top2[..., 0] / (top2[..., 1] + 1e-8))
    return unc.unsqueeze(obj_axis)
