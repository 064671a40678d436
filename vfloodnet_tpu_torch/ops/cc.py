"""Largest 8-connected component (counterpart of ``vfloodnet_tpu.ops.cc``).

Iterative label propagation: every foreground pixel starts with its raster
index; each round takes the minimum over the 8-neighbourhood and then jumps
each label to its own label's label (pointer jumping), until nothing
changes. The fixpoint labels every component by its smallest raster index,
as the JAX op does, so the kept component (ties broken towards the smaller
label) is the same.

That loop is the plain version: it checks for its fixpoint on the host.
:func:`largest_connected_component` takes it for a CPU tensor only; a CUDA
tensor goes to the union-find kernel of ``csrc/cc.cu`` (:mod:`.cc_cuda`),
which keeps the same labels and tie rule in five launches and no host
sync.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cc_cuda

_ROUNDS_PER_CHECK = 4


def _neighbour_min(labels: torch.Tensor, inf: int) -> torch.Tensor:
    h, w = labels.shape
    p = F.pad(labels, (1, 1, 1, 1), value=inf)
    out = labels
    for dy in range(3):
        for dx in range(3):
            out = torch.minimum(out, p[dy:dy + h, dx:dx + w])
    return out


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """int64 labels of the 8-connected components of a binary [H, W] mask:
    -1 on background, the smallest raster index of its component on
    foreground."""
    h, w = mask.shape
    fg = mask.bool()
    inf = h * w
    labels = torch.arange(h * w, device=mask.device).reshape(h, w)
    labels = torch.where(fg, labels, inf)
    while True:
        prev = labels
        for _ in range(_ROUNDS_PER_CHECK):
            labels = torch.where(fg, _neighbour_min(labels, inf), inf)
            flat = labels.reshape(-1)
            jumped = torch.cat([flat, flat.new_full((1,), inf)])[flat]
            labels = torch.minimum(flat, jumped).reshape(h, w)
        if torch.equal(labels, prev):
            return torch.where(fg, labels, -1)


def largest_cc_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: the largest 8-connected foreground
    component of each binary map of ``mask`` [..., H, W]; uint8 {0, 1}."""
    if mask.ndim > 2:
        flat = mask.reshape((-1,) + mask.shape[-2:])
        return torch.stack([largest_cc_plain(m) for m in flat]).reshape(
            mask.shape)
    labels = connected_components(mask)
    fg = labels >= 0
    if not bool(fg.any()):
        return torch.zeros_like(mask, dtype=torch.uint8)
    sizes = torch.bincount(labels[fg], minlength=labels.numel())
    return (labels == torch.argmax(sizes)).to(torch.uint8)


def largest_connected_component(mask: torch.Tensor) -> torch.Tensor:
    """Keep only the largest 8-connected foreground component of each
    binary map of ``mask`` [..., H, W]; uint8 {0, 1}. The kernel on a CUDA
    tensor, the plain version on a CPU one."""
    if mask.is_cuda:
        return cc_cuda.largest_cc(mask.to(torch.uint8))
    return largest_cc_plain(mask)
