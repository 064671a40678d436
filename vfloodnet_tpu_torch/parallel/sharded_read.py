"""The memory read over a feature bank sharded on its capacity axis
(counterpart of ``vfloodnet_tpu.parallel.sharded_read``).

Each rank of the mesh's ``model`` axis holds a slice of every object's
slots. A rank reads its slice as the single-device read does, bounded by
its own highest valid slot, and keeps the running max ``m``, the
normaliser ``l`` and the weighted values; the ranks then combine them:
``g_m = max_r m_r``, ``corr_r = exp(m_r - g_m)``, ``g_l = sum_r l_r
corr_r``, ``mem = sum_r acc_r corr_r / g_l`` (an all-reduce MAX, then one
SUM). The usage counts are per slot, so each rank counts its own slots
against the global ``log_thres = log(thres) + log(g_l) + g_m``.

On the card a rank's read is the read kernel with its combine
(:func:`..ops.bank_read_cuda.bank_read`) and its counts the count kernel
(:func:`..ops.bank_read_cuda.bank_count`), each one launch for every
object of the shard; on the CPU the same code runs their plain versions
(``ops/attention.py::_read_occ_sweep``, ``_count_occ_sweep``).

Two differences from the JAX read, neither of which changes a result:

- JAX visits no chunk of a shard that holds no valid slot of an object
  (m = -1e30, l = 0); the port's read visits at least one chunk, so here
  ``l`` and the values of such a shard are zeroed before the combine. When
  no shard holds a valid slot of an object its ``mem`` is 0, as in JAX.
- JAX bounds each object on its own; the kernels take one bound for every
  object, the largest. The chunks that one object visits beyond its own
  bound hold no valid slot of it and add nothing.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

from ..memory import FeatureBankState
from ..ops import bank_read_cuda
from ..ops.attention import (OCC_CHUNK, _count_occ_sweep, _read_occ_sweep,
                             query_plane)
from .mesh import MODEL_AXIS, Mesh


def shard_occ_bound(valid: torch.Tensor) -> torch.Tensor:
    """Highest valid slot + 1 over every object of a shard, valid [obj,
    n], as the [1] int32 tensor on the shard's device that the kernels
    take (0 for an empty shard; the JAX ``_shard_occ_bound``, one for all
    objects)."""
    n = valid.shape[-1]
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=valid.device)
    return torch.where(valid, idx, 0).amax().reshape(1)


def _local_read(keys, values, valid, q, thres, bound):
    """This shard's (mem [obj, P, dv] float32, m [obj, P], l [obj, P]):
    the read kernel and its combine on the card, ``_read_occ_sweep`` of
    each object on the CPU."""
    if keys.is_cuda:
        mem, m, l, _ = bank_read_cuda.bank_read(q, keys, values, valid,
                                                bound, OCC_CHUNK, thres)
        return mem, m, l
    obj_n, b = keys.shape[0], int(bound)
    outs = [_read_occ_sweep(keys[o], values[o], valid[o],
                            query_plane(q, o, obj_n), OCC_CHUNK, b)
            for o in range(obj_n)]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def _local_count(keys, valid, q, log_thres, bound):
    if keys.is_cuda:
        return bank_read_cuda.bank_count(q, keys, valid, bound, log_thres,
                                         OCC_CHUNK)
    obj_n, b = keys.shape[0], int(bound)
    return torch.stack([
        _count_occ_sweep(keys[o], valid[o], query_plane(q, o, obj_n),
                         log_thres[o], OCC_CHUNK, b) for o in range(obj_n)])


def combine_shards(mem, m, l, has_valid, all_max, all_sum, thres):
    """The combine across shards, given this shard's read (mem [obj, P,
    dv], m, l [obj, P]), whether it holds a valid slot of each object
    (has_valid [obj] bool) and the two reductions over shards (in place on
    their argument): -> (mem [obj, P, dv], log_thres [obj, P]), float32.
    Leading axes are carried along (a stacked shard axis, reduced by the
    two functions, runs every shard's combine in one process)."""
    l = torch.where(has_valid[..., None], l, torch.zeros_like(l))
    g_m = m.clone()
    all_max(g_m)
    w = l * torch.exp(m - g_m)
    sums = torch.cat([w[..., None], mem * w[..., None]], dim=-1)
    all_sum(sums)
    g_l = sums[..., 0].clamp_min(1e-30)
    return (sums[..., 1:] / g_l[..., None],
            math.log(thres) + torch.log(g_l) + g_m)


def sharded_bank_attention_read(mesh: Mesh, keys: torch.Tensor,
                                values: torch.Tensor, valid: torch.Tensor,
                                q: torch.Tensor, thres: float = 1e-3
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The read of this rank's shard of every object, keys [obj, N/R, dk],
    values [obj, N/R, dv], valid [obj, N/R] (R: the mesh's model axis),
    with the query q [P, dk] replicated, combined over the mesh's model
    group. A bf16 bank reads a bf16 query, as the single-device read.

    Returns (mem [obj, P, dv] in the values' dtype, the same on every
    rank; cnt [obj, N/R] float32, this shard's usage counts)."""
    if keys.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16)
    q = q.contiguous()
    group = mesh.model_group
    bound = shard_occ_bound(valid)
    mem, m, l = _local_read(keys, values, valid, q, thres, bound)
    mem, log_thres = combine_shards(
        mem, m, l, valid.any(dim=-1),
        lambda t: dist.all_reduce(t, dist.ReduceOp.MAX, group=group),
        lambda t: dist.all_reduce(t, dist.ReduceOp.SUM, group=group), thres)
    cnt = _local_count(keys, valid, q, log_thres.contiguous(), bound)
    return mem.to(values.dtype), cnt


def shard_bank_state(mesh: Mesh, state: FeatureBankState
                     ) -> FeatureBankState:
    """This rank's shard of a whole bank: its slice of the capacity axis
    of keys, values, valid, birth and usage (slots [r N/R, (r + 1) N/R)
    for model index r), and ``peak_n``, ``replace_n`` and ``occ`` as the
    replicated totals of every shard. The capacity must divide by R."""
    r_n, r = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    cap = state.capacity
    if cap % r_n:
        raise ValueError(f"a bank of {cap} slots does not split into "
                         f"{r_n} shards")
    n = cap // r_n

    def part(t):
        return t[:, r * n:(r + 1) * n].contiguous()
    return FeatureBankState(
        keys=part(state.keys), values=part(state.values),
        valid=part(state.valid), birth=part(state.birth),
        usage=part(state.usage), peak_n=state.peak_n.clone(),
        replace_n=state.replace_n.clone(), occ=state.occ.clone())
