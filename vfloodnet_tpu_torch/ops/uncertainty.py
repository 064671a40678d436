"""URR uncertainty (counterpart of ``vfloodnet_tpu.ops.uncertainty``)."""

from __future__ import annotations

import torch


def calc_uncertainty(score: torch.Tensor, obj_axis: int = -1) -> torch.Tensor:
    """``exp(1 - top1 / (top2 + 1e-8))`` over the object axis, which is
    kept with size 1: ~0 where one object dominates, ~1 where two tie.

    Where a gradient is wanted, the top two come from a stable sort, so
    among equal scores the lower object is first, as in
    ``jax.lax.top_k``: the gradient of a tie (saturated probabilities tie
    often) then goes to the objects the JAX package's goes to."""
    x = score.movedim(obj_axis, -1)
    if torch.is_grad_enabled() and x.requires_grad:
        top2 = torch.sort(x, dim=-1, descending=True,
                          stable=True).values[..., :2]
    else:
        top2 = torch.topk(x, 2, dim=-1).values
    unc = torch.exp(1.0 - top2[..., 0] / (top2[..., 1] + 1e-8))
    return unc.unsqueeze(obj_axis)
