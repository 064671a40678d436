"""Feature-bank update: cosine match -> merge / append / LFU evict
(counterpart of ``vfloodnet_tpu.ops.bank_update``, its static-shape,
dense-prefix form).

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

Every shape is static and nothing waits for the host, so the update can be
captured in a CUDA graph: the occupancy ``occ``, the counts and the frame
index stay on the device, and the only host inputs are a bound on the
occupancy (how many chunks the match visits and whether LFU victims are
selected; a loose bound gives the same result, as in the JAX package).
The bank tensors are updated in place (the JAX package returns new arrays;
here that would copy the 0.5 GB bank every frame). The update runs every
object of a bank, and the objects of several streams, along one leading
axis of the same ops (the JAX package vmaps it over objects and streams):
one set of launches a step, however many banks.

- Merge means are taken over the incoming features only (no bank-sized
  temporaries), as ``_sorted_group_means`` does, as one product of the
  [M, M] same-slot matrix with the features: deterministic, unlike an
  atomic ``index_add_``, so an eager step and a replayed graph write the
  same bits.
- LFU victims are ``torch.topk`` of the int64 key ``(float32 bits of prio)
  << 32 | slot`` (monotone in prio, which is >= 0): ascending LFU with
  ties to the lower slot, the order of the JAX package's exact ``top_k``,
  so the victims equal its victims slot by slot.
- Scatters have one row per feature. A dropped row repeats the first kept
  row's write (the same slot and bits), or rewrites slot 0 with its own
  value when no row is kept, so no boolean index or ``nonzero`` (both
  wait for the host) is needed.

A bf16 bank is matched and merged as the JAX package does it: the
correlation is a bf16 product scaled in bf16 by float32 inverse slot norms,
and the merge gathers the matched rows as float32, runs the mean and the
EMA in float32 and casts on the scatter.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch

OCC_CHUNK = 8192


class BankUpdateStats(NamedTuple):
    merged_n: torch.Tensor     # features merged into existing slots
    appended_n: torch.Tensor   # features written to new slots
    evicted_n: torch.Tensor    # previously valid slots overwritten


def match_chunks(n: int, occ_bound: int) -> int:
    """Chunks of the bank the match visits for an occupancy bound (a host
    int): ``clip(ceil(occ_bound / c), 1, ceil(n / c))`` with ``c =
    min(OCC_CHUNK, n)``, as the JAX package's occupancy-bounded loop."""
    chunk = OCC_CHUNK if n > OCC_CHUNK else n
    return min(max(-(-int(occ_bound) // chunk), 1), -(-n // chunk))


def device_scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` (a number or a 0-d tensor) as a 0-d tensor of ``dtype`` on
    ``device``; a number is written by a fill, not copied from the host."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=device)


def _safe_normalize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / mag.clamp_min(1e-12), mag


def _best_match(keys, valid, normed_new, occ_bound: int):
    """Best cosine match of each new feature among the valid slots of its
    row: keys [..., N, dk], valid [..., N], normed_new [..., M, dk] ->
    (best_corr [..., M], best_idx [..., M]); -2 and slot 0 when there is
    none. Only the :func:`match_chunks` of the host bound ``occ_bound``
    are visited."""
    n = keys.shape[-2]
    chunk = OCC_CHUNK if n > OCC_CHUNK else n
    lead_m = normed_new.shape[:-1]
    best_corr = torch.full(lead_m, -2.0, dtype=torch.float32,
                           device=keys.device)
    best_idx = torch.zeros(lead_m, dtype=torch.int64, device=keys.device)
    for i in range(match_chunks(n, occ_bound)):
        k_c = keys[..., i * chunk:(i + 1) * chunk, :]
        ok = valid[..., i * chunk:(i + 1) * chunk]
        mag = torch.linalg.vector_norm(k_c.float(), dim=-1)
        inv = torch.where(ok, 1.0 / mag.clamp_min(1e-12),
                          torch.zeros_like(mag))
        corr = (normed_new.to(keys.dtype) @ k_c.transpose(-1, -2)) * \
            inv.unsqueeze(-2).to(keys.dtype)
        corr = torch.where(ok.unsqueeze(-2), corr, torch.full_like(corr, -2.0))
        local_val, local_idx = corr.max(dim=-1)
        local_val = local_val.float()
        better = local_val > best_corr
        best_idx = torch.where(better, local_idx + i * chunk, best_idx)
        best_corr = torch.maximum(best_corr, local_val)
    return best_corr, best_idx


def _group_means(datas: Sequence[torch.Tensor], idx: torch.Tensor,
                 mask: torch.Tensor):
    """Means of the rows of each [..., M, d] ``datas`` over the masked rows
    that share their ``idx`` [..., M], and one representative row per
    group (its first) -> (means, rep [..., M] bool). A group's mean sits on
    every row of the group; the sum is the product of the [M, M] same-group
    matrix with the rows, in float32."""
    m = idx.shape[-1]
    same = (idx.unsqueeze(-1) == idx.unsqueeze(-2)) & mask.unsqueeze(-1) & \
        mask.unsqueeze(-2)
    rows = torch.arange(m, device=idx.device)
    earlier = (same & (rows[None, :] < rows[:, None])).any(dim=-1)
    rep = mask & ~earlier
    weight = same.float()
    count = weight.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return [(weight @ d.float()) / count for d in datas], rep


def scatter_rows(dest: torch.Tensor, keep: torch.Tensor, pairs) -> None:
    """For each ``(bank [..., N, ...], rows)`` of ``pairs``: ``bank[...,
    dest[..., i]] = rows[..., i]`` for the rows with ``keep[..., i]``;
    dest and keep are [..., M] with the bank's leading axes (none for one
    object's bank), ``rows`` is [..., M, ...] or a value for every row (a
    number or a 0-d tensor). The kept ``dest`` of a leading index are
    distinct. Every row writes: a dropped one repeats the first kept row
    of its leading index (the same slot and the same bits), or rewrites
    that index's slot 0 with its own value when none is kept, so the
    result is that of the kept rows alone, with static shapes, no host
    sync and one write per bank for every leading index."""
    lead, m = dest.shape[:-1], dest.shape[-1]
    nl = len(lead)
    any_keep = keep.any(dim=-1, keepdim=True)
    # index tensors with a kept axis: indexing with a 0-d tensor would
    # read it on the host
    first = torch.argmax(keep.to(torch.uint8), dim=-1, keepdim=True)
    first_dest = dest.gather(-1, first)
    d = torch.where(keep, dest, torch.where(any_keep, first_dest,
                                            torch.zeros_like(first_dest)))
    # the leading axes folded into the slot axis of each bank's view
    n = pairs[0][0].shape[nl]
    flat = (d + n * torch.arange(math.prod(lead), device=d.device).reshape(
        lead + (1,))).reshape(-1)
    for bank, rows in pairs:
        rest = bank.shape[nl + 1:]
        if not torch.is_tensor(rows) or rows.ndim == 0:
            rows = device_scalar(rows, bank.dtype, bank.device).expand(
                lead + (m,) + rest)
        rows = rows.to(bank.dtype)
        ones = (1,) * len(rest)
        fill = torch.where(
            any_keep.reshape(lead + (1,) + ones),
            rows.gather(nl, first.reshape(lead + (1,) + ones).expand(
                lead + (1,) + rest)),
            bank.narrow(nl, 0, 1))
        vals = torch.where(keep.reshape(lead + (m,) + ones), rows, fill)
        bank.view((-1,) + rest).index_put_((flat,),
                                           vals.reshape((-1,) + rest))


def lfu_victims(prio: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` slots of lowest ``prio`` [..., N] (>= 0) of each row in
    ascending order, ties to the lower slot: the victims of the JAX
    package's exact ``top_k``, slot by slot."""
    n = prio.shape[-1]
    bits = (prio + 0.0).view(torch.int32).to(torch.int64)   # -0 -> +0
    key = (bits << 32) | torch.arange(n, device=prio.device)
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).indices


def bank_merge_append(keys: torch.Tensor, values: torch.Tensor,
                      valid: torch.Tensor, birth: torch.Tensor,
                      usage: torch.Tensor, new_keys: torch.Tensor,
                      new_values: torch.Tensor, frame_idx, occ,
                      occ_bound: int, update_rate: float = 0.1,
                      thres_close: float = 0.95
                      ) -> Tuple[torch.Tensor, BankUpdateStats]:
    """One frame's update of one object's bank, or of R banks at once
    (the objects of one or of several streams, along one leading axis),
    in place.

    Args:
      keys [N, dk], values [N, dv], valid [N] bool, birth [N] f32 (frame a
      slot was written), usage [N] f32 (accumulated log usage): the bank,
      modified in place; or each with a leading axis of R banks. new_keys
      [(R,) M, dk], new_values [(R,) M, dv]: the frame's features.
      frame_idx: the frame index, a number or a 0-d tensor on the bank's
      device. occ: the occupancy (valid slots are [0, occ)), an int or a
      0-d int32 tensor for one bank, an [R] int32 tensor for R.
      occ_bound: a host int at least the largest occupancy over all
      banks; it bounds the match (:func:`match_chunks`) and opens the
      LFU selection when ``occ_bound + M > N``, as the JAX package's gate.

    Returns: (new occupancy, stats), int32 tensors on the device: 0-d for
    one bank, [R] for R.
    """
    dev = keys.device
    if keys.ndim == 2:      # one bank: a leading axis of one
        occ = device_scalar(occ, torch.int32, dev).reshape(1)
        occ_new, stats = bank_merge_append(
            *(t[None] for t in (keys, values, valid, birth, usage, new_keys,
                                new_values)), frame_idx, occ, occ_bound,
            update_rate, thres_close)
        return occ_new[0], BankUpdateStats(*(x[0] for x in stats))
    r, n = keys.shape[:2]
    m = new_keys.shape[1]
    occ = occ.to(device=dev, dtype=torch.int32).reshape(r)
    frame_idx = device_scalar(frame_idx, torch.float32, dev)
    normed_new_k, _ = _safe_normalize(new_keys)
    normed_new_v, _ = _safe_normalize(new_values)
    best_corr, best_idx = _best_match(keys, valid, normed_new_k, occ_bound)
    merge_mask = best_corr > thres_close

    # Merge: mean of the features matched to each slot, EMA'd into it.
    (k_mean, v_mean), rep = _group_means((normed_new_k, normed_new_v),
                                         best_idx, merge_mask)
    rate = update_rate
    merged = []
    for bank, mean in ((keys, k_mean), (values, v_mean)):
        rows = bank.gather(1, best_idx[..., None].expand(-1, -1,
                                                         bank.shape[-1]))
        old_dir, old_mag = _safe_normalize(rows.float())
        merged.append(old_mag * ((1.0 - rate) * old_dir + rate * mean))
    protected = torch.zeros((r, n), dtype=torch.bool, device=dev)
    scatter_rows(best_idx, rep, ((keys, merged[0]), (values, merged[1]),
                                 (protected, True)))

    # Append at the prefix tail; LFU victims once the bank is full.
    append_mask = ~merge_mask
    appended_n = append_mask.sum(dim=1).to(torch.int32)
    rank = torch.cumsum(append_mask.to(torch.int64), 1) - 1
    free_n = (n - occ)[:, None]
    k = min(m, n)
    if occ_bound + m > n:
        lfu = usage / torch.clamp(frame_idx - birth, min=1.0)
        prio = torch.where(valid & ~protected, lfu,
                           torch.full_like(lfu, 1e30))
        victim = lfu_victims(prio, k).gather(
            1, torch.clamp(rank - free_n, 0, k - 1))
        victim = torch.where(prio.gather(1, victim) < 1e30, victim,
                             torch.full_like(victim, n))
    else:
        victim = torch.full_like(rank, n)
    dest = torch.where(rank < free_n, occ[:, None] + rank, victim)
    keep = append_mask & (dest < n)
    scatter_rows(dest, keep, ((keys, new_keys), (values, new_values),
                              (birth, frame_idx), (usage, 0.0),
                              (valid, True)))
    usage.clamp_(0.0, 1e5)   # reference FeatureBank.py:115

    evicted_n = torch.minimum(torch.clamp(appended_n - free_n[:, 0], min=0),
                              occ)
    occ_new = torch.clamp(occ + appended_n, max=n)
    return occ_new, BankUpdateStats(merge_mask.sum(dim=1).to(torch.int32),
                                    appended_n, evicted_n.to(torch.int32))
