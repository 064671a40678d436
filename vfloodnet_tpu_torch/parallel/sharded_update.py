"""The bank update over a feature bank sharded on its capacity axis
(counterpart of ``vfloodnet_tpu.parallel.sharded_update``).

With each rank of the mesh's ``model`` axis holding a slice of every
object's slots, one update does the reference ``FeatureBank.update``
(merge, append, LFU evict) across the shards:

1. each rank finds every new feature's best cosine match among its valid
   slots; the global best is an all-reduce MAX, and its owner the lowest
   rank within 1e-7 of it (an all-reduce MIN);
2. a feature matched above ``thres_close`` merges into its slot on the
   owner only (the group mean of the features matched to the slot, EMA'd
   in at ``update_rate``);
3. the other features are appended: every rank proposes its ``min(M,
   N/R)`` cheapest slots (free first, then lowest usage / age; slots
   merged into this frame never), the ranks all-gather them, and every
   rank picks the same ``M`` cheapest of the gathered candidates, ties to
   the earlier one (rank-major): so shards fill in rank order, each from
   its lowest free slot. Each rank writes the features whose slots it
   holds.

The ranks of a model group must hold the same new features. Every object
of the bank runs at once, along the leading axis, with the single-device
update's functions (``ops/bank_update.py``); the bank is updated in place.
Ties among candidates are broken as ``jax.lax.top_k`` breaks them
(:func:`..ops.nms.top_k`: int64 keys, the lower index first, -0.0 below
+0.0), so the victims are the JAX package's slot for slot.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.bank_update import (_best_match, _group_means, _safe_normalize,
                               device_scalar, scatter_rows)
from ..ops.nms import top_k
from .mesh import MODEL_AXIS, Mesh
from .sharded_read import shard_occ_bound


def _all_gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """[size, *t.shape]: t of every rank of ``group``, in rank order."""
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def sharded_bank_merge_append(mesh: Mesh, keys: torch.Tensor,
                              values: torch.Tensor, valid: torch.Tensor,
                              birth: torch.Tensor, usage: torch.Tensor,
                              new_keys: torch.Tensor,
                              new_values: torch.Tensor, frame_idx,
                              update_rate: float = 0.1,
                              thres_close: float = 0.95) -> torch.Tensor:
    """One frame's update of this rank's shard of every object's bank, in
    place: keys [obj, N/R, dk], values [obj, N/R, dv], valid [obj, N/R]
    bool, birth and usage [obj, N/R] float32; new_keys [obj, M, dk] and
    new_values [obj, M, dv] the frame's features, the same on every rank;
    frame_idx a number or a 0-d tensor. The match visits this shard's
    chunks up to its highest valid slot (read on the host once).

    Returns evicted_n [obj] int32, the previously valid slots that appends
    overwrote on all shards (the same on every rank)."""
    group = mesh.model_group
    r_n, shard = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    dev = keys.device
    obj_n, n_local = keys.shape[:2]
    m = new_keys.shape[1]
    offset = shard * n_local
    fi = device_scalar(frame_idx, torch.float32, dev)
    new_keys, new_values = new_keys.to(keys.dtype), new_values.to(keys.dtype)
    normed_new_k, _ = _safe_normalize(new_keys)
    normed_new_v, _ = _safe_normalize(new_values)
    local_corr, local_idx = _best_match(keys, valid, normed_new_k,
                                        int(shard_occ_bound(valid)))
    g_corr = local_corr.clone()
    dist.all_reduce(g_corr, dist.ReduceOp.MAX, group=group)
    winner = torch.where(local_corr >= g_corr - 1e-7,
                         torch.full_like(local_idx, shard),
                         torch.full_like(local_idx, r_n))
    dist.all_reduce(winner, dist.ReduceOp.MIN, group=group)
    merge_mask = g_corr > thres_close

    # Merge on the owning shard: the matched features' mean, EMA'd in.
    (k_mean, v_mean), rep = _group_means((normed_new_k, normed_new_v),
                                         local_idx,
                                         merge_mask & (winner == shard))
    merged = []
    for bank, mean in ((keys, k_mean), (values, v_mean)):
        rows = bank.gather(1, local_idx[..., None].expand(
            -1, -1, bank.shape[-1]))
        old_dir, old_mag = _safe_normalize(rows.float())
        merged.append(old_mag * ((1.0 - update_rate) * old_dir
                                 + update_rate * mean))
    protected = torch.zeros((obj_n, n_local), dtype=torch.bool, device=dev)
    scatter_rows(local_idx, rep, ((keys, merged[0]), (values, merged[1]),
                                  (protected, True)))

    # Append: the M cheapest of every shard's proposals, rank-major ties.
    append_mask = ~merge_mask
    lfu = usage / torch.clamp(fi - birth, min=1.0)
    prio = torch.where(valid, lfu, torch.full_like(lfu, -2.0))
    prio = torch.where(protected, torch.full_like(prio, 1e30), prio)
    cand_neg, cand_slot = top_k(-prio, min(m, n_local))
    all_prio = -_all_gather(cand_neg, group, r_n).transpose(0, 1).reshape(
        obj_n, -1)
    all_slot = _all_gather(cand_slot + offset, group, r_n).transpose(
        0, 1).reshape(obj_n, -1)
    victims = all_slot.gather(1, top_k(-all_prio, m)[1])     # global slots
    rank = torch.clamp(torch.cumsum(append_mask.to(torch.int64), 1) - 1,
                       0, m - 1)
    dest = victims.gather(1, rank) - offset
    keep = append_mask & (dest >= 0) & (dest < n_local)
    dest = torch.where(keep, dest, torch.zeros_like(dest))
    evicted = (keep & valid.gather(1, dest)).sum(dim=1).to(torch.int32)
    dist.all_reduce(evicted, dist.ReduceOp.SUM, group=group)
    scatter_rows(dest, keep, ((keys, new_keys), (values, new_values),
                              (birth, fi), (usage, 0.0), (valid, True)))
    usage.clamp_(0.0, 1e5)   # reference FeatureBank.py:115
    return evicted
