"""Feature-bank update: cosine match -> merge / append / LFU evict
(counterpart of ``vfloodnet_tpu.ops.bank_update``, dense-prefix form).

One object's bank is a fixed-capacity slot array whose valid slots are
packed at the front, ``[0, occ)``. For each new feature of the frame:

1. its best cosine match among the valid slots is found (visiting only the
   occupied chunks);
2. if that cosine exceeds ``thres_close`` it is merged: the slot's
   direction moves toward the mean of the features matched to it at rate
   ``update_rate``, keeping the slot's magnitude;
3. otherwise it is appended at the end of the prefix, and once the bank is
   full it overwrites the slot with the lowest usage / age (LFU), never one
   merged into this frame.

The bank tensors are updated in place (the JAX package returns new arrays;
here that would copy the 0.5 GB bank every frame). Victims are taken in
ascending LFU order with ties to the lower slot, the order of the JAX
package's exact ``top_k`` branch.

A bf16 bank is matched and merged as the JAX package does it: the
correlation is a bf16 product scaled in bf16 by float32 inverse slot norms,
and the merge gathers the matched rows as float32, runs the mean and the
EMA in float32 and casts on the scatter.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

OCC_CHUNK = 8192


class BankUpdateStats(NamedTuple):
    merged_n: int     # features merged into existing slots
    appended_n: int   # features written to new slots
    evicted_n: int    # previously valid slots overwritten


def _safe_normalize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / mag.clamp_min(1e-12), mag


def _best_match(keys, valid, normed_new, occ_bound: int):
    """Best cosine match of each new feature among the valid slots ->
    (best_corr [M], best_idx [M]); -2 and slot 0 when there is none. Banks
    larger than one chunk are visited only up to the occupancy bound,
    rounded up to whole chunks."""
    n = keys.shape[0]
    chunk = OCC_CHUNK if n > OCC_CHUNK else n
    n_iter = min(max(-(-occ_bound // chunk), 1), -(-n // chunk))
    m = normed_new.shape[0]
    best_corr = torch.full((m,), -2.0, dtype=torch.float32,
                           device=keys.device)
    best_idx = torch.zeros((m,), dtype=torch.int64, device=keys.device)
    for i in range(n_iter):
        k_c = keys[i * chunk:(i + 1) * chunk]
        ok = valid[i * chunk:(i + 1) * chunk]
        mag = torch.linalg.vector_norm(k_c.float(), dim=1)
        inv = torch.where(ok, 1.0 / mag.clamp_min(1e-12),
                          torch.zeros_like(mag))
        corr = (normed_new.to(keys.dtype) @ k_c.T) * inv[None, :].to(
            keys.dtype)
        corr = torch.where(ok[None, :], corr, torch.full_like(corr, -2.0))
        local_val, local_idx = corr.max(dim=1)
        local_val = local_val.float()
        better = local_val > best_corr
        best_idx = torch.where(better, local_idx + i * chunk, best_idx)
        best_corr = torch.maximum(best_corr, local_val)
    return best_corr, best_idx


def bank_merge_append(keys: torch.Tensor, values: torch.Tensor,
                      valid: torch.Tensor, birth: torch.Tensor,
                      usage: torch.Tensor, new_keys: torch.Tensor,
                      new_values: torch.Tensor, frame_idx: float,
                      occ: int, occ_bound: int, update_rate: float = 0.1,
                      thres_close: float = 0.95
                      ) -> Tuple[int, BankUpdateStats]:
    """One frame's update of one object's bank, in place.

    Args:
      keys [N, dk], values [N, dv], valid [N] bool, birth [N] f32 (frame a
      slot was written), usage [N] f32 (accumulated log usage): the bank,
      modified in place. new_keys [M, dk], new_values [M, dv]: the frame's
      features. occ: this object's occupancy (valid slots are [0, occ)).
      occ_bound: the largest occupancy over all objects; it bounds the match
      and gates the eviction exactly as in the JAX package.

    Returns: (new occupancy, stats).
    """
    n = keys.shape[0]
    m = new_keys.shape[0]
    normed_new_k, _ = _safe_normalize(new_keys)
    normed_new_v, _ = _safe_normalize(new_values)
    best_corr, best_idx = _best_match(keys, valid, normed_new_k, occ_bound)
    merge_mask = best_corr > thres_close

    # Merge: mean of the features matched to each slot, EMA'd into it.
    protected = torch.zeros((n,), dtype=torch.bool, device=keys.device)
    merged_n = int(merge_mask.sum())
    if merged_n:
        slots, group = torch.unique(best_idx[merge_mask], return_inverse=True)
        count = torch.bincount(group, minlength=slots.numel())[:, None]
        r = update_rate
        for bank, normed in ((keys, normed_new_k), (values, normed_new_v)):
            mean = torch.zeros((slots.numel(), normed.shape[1]),
                               dtype=torch.float32, device=normed.device)
            mean.index_add_(0, group, normed[merge_mask].float())
            mean = mean / count.clamp_min(1)
            old_dir, old_mag = _safe_normalize(bank[slots].float())
            bank[slots] = (old_mag * ((1.0 - r) * old_dir + r * mean)).to(
                bank.dtype)
        protected[slots] = True

    # Append at the prefix tail; LFU victims once the bank is full.
    append_mask = ~merge_mask
    appended_n = m - merged_n
    rank = torch.cumsum(append_mask.to(torch.int64), 0) - 1
    free_n = n - occ
    k = min(m, n)
    if occ_bound + m > n:
        lfu = usage / torch.clamp(frame_idx - birth, min=1.0)
        prio = torch.where(valid & ~protected, lfu,
                           torch.full_like(lfu, 1e30))
        victim_order = torch.sort(prio, stable=True).indices[:k]
        victim = victim_order[torch.clamp(rank - free_n, 0, k - 1)]
        victim = torch.where(prio[victim] < 1e30, victim,
                             torch.full_like(victim, n))
    else:
        victim = torch.full_like(rank, n)
    dest = torch.where(rank < free_n, occ + rank, victim)
    dest = torch.where(append_mask, dest, torch.full_like(dest, n))
    rows = torch.nonzero(dest < n).squeeze(1)
    d = dest[rows]
    keys[d] = new_keys[rows].to(keys.dtype)
    values[d] = new_values[rows].to(values.dtype)
    birth[d] = float(frame_idx)
    usage[d] = 0.0
    valid[d] = True
    usage.clamp_(0.0, 1e5)   # reference FeatureBank.py:115

    evicted_n = min(max(appended_n - free_n, 0), occ)
    occ_new = min(occ + appended_n, n)
    return occ_new, BankUpdateStats(merged_n, appended_n, evicted_n)
