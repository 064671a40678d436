"""Memory-read attention over the feature bank (counterpart of
``vfloodnet_tpu.ops.attention``).

For every query pixel p of the current frame and every object,

    mem[p] = sum_n softmax_n(q_p . k_n / sqrt(dk)) v_n

over the object's valid bank slots, plus the per-slot usage count that
drives the bank's LFU eviction,

    cnt[n] = #{p : softmax_n(q_p . k / sqrt(dk)) > thres}.

On CUDA tensors the read (over S bank segments, then a combine) and the
count are the hand-written kernels of ``csrc/bank_read.cu`` (float32) and
``csrc/bank_read_bf16.cu`` (bf16), through :mod:`.bank_read_cuda`. On CPU
tensors the plain versions below run; they repeat the JAX package's three
variants (dense, chunked and occupancy-bounded), and the tests hold each
against its JAX counterpart.
The trainer reads with :func:`read_dense_batched`, the dense read with
gradients, on every device: the kernels are forward-only.
The plain versions of the kernels are ``_read_occ_sweep`` (read),
``_read_occ_segments`` (the read's per-segment partials),
``combine_partials`` (combine) and ``_count_occ_sweep`` (count). A CUDA
tensor never takes a plain version.

Streams: the read takes the query of one stream, q [P, dk], read by every
object's bank, or of B streams, q [B, P, dk], with the B streams' banks
folded along the object axis (obj = B x objects a stream); object o reads
plane :func:`query_plane`, o // (obj / B), and one occupancy bound serves
every stream, as the JAX package's batch engine shares one bound across
its vmapped streams. On the card that is one launch of each kernel; the
plain versions sweep object by object on the plane of each.

A bank is float32 or bfloat16. On a bf16 bank every variant follows the
contract of the JAX package's Pallas kernels (``attention_pallas.py``,
``mm_dtype = bf16``), which the bf16 CUDA kernels also keep: q is cast to
the bank's dtype, the scores q . k are float32 sums of the exact bf16
products, the running max and normaliser are float32, the probabilities
are rounded to bf16 for P V, which accumulates in float32, mem is rounded
to the values' dtype, and the count compares float32 scores with a float32
``log_thres``. The JAX engine's own read, ``_xla_read_occ``, keeps the
[P, chunk] scores in bf16 instead; the tests hold these versions against
both, at the JAX package's bf16 bars.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import bank_read_cuda

NEG_INF = -1e30

# The dense read is used while the [P, N] score matrix stays under this many
# elements (as in the JAX package).
DENSE_SCORE_ELEMENTS = 256 * 1024 * 1024

# Chunk of the occupancy-bounded read: the bound is rounded up to a multiple
# of it (the kernels apply the same rounding).
OCC_CHUNK = 8192


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if rows == x.shape[0]:
        return x
    pad = x.new_zeros((rows - x.shape[0],) + x.shape[1:])
    return torch.cat([x, pad])


def _read_dense(keys, values, valid, q, thres):
    """One-shot read with the [P, N] score matrix. keys [N, dk], values
    [N, dv], valid [N] bool, q [P, dk] -> (mem [P, dv], cnt [N])."""
    scale = 1.0 / math.sqrt(keys.shape[1])
    s = _scores(q, keys) * scale
    s = torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))
    m = s.max(dim=1, keepdim=True).values
    e = torch.exp(s - m)
    l = e.sum(dim=1, keepdim=True).clamp_min(1e-30)
    mem = _weighted_sum(e * (1.0 / l), values)
    cnt = ((e > thres * l) & valid[None, :]).sum(dim=0).to(torch.float32)
    return mem, cnt


def read_dense_batched(keys, values, valid, q, thres):
    """The dense read of :func:`_read_dense` for B query frames against
    every object's bank at once, differentiable, in float32 on any device
    (the training read: the JAX package's ``_xla_read_dense``, which its
    trainer takes at training sizes; float64 operands stay float64).
    keys [obj, N, dk], values [obj, N, dv], valid [obj, N] bool, q [B, P,
    dk] -> (mem [B, obj, P, dv], cnt [obj, N], summed over the B frames,
    without gradient)."""
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(keys.shape[-1])
    s = torch.einsum("bpd,ond->bopn", q.to(dt), keys.to(dt)) * scale
    s = torch.where(valid[None, :, None, :], s, torch.full_like(s, NEG_INF))
    m = s.max(dim=-1, keepdim=True).values
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    mem = (e * (1.0 / l)) @ values.to(dt)[None]
    with torch.no_grad():
        cnt = ((e > thres * l) & valid[None, :, None, :]).sum(dim=(0, 2))
    return mem, cnt.to(torch.float32)


def _read_chunked(keys, values, valid, q, thres, chunk):
    """Online-softmax read over all bank chunks, then a second sweep for
    the counts (the JAX package's ``_xla_read``): the occupancy-bounded
    read with the whole bank as its bound."""
    return _read_occ(keys, values, valid, q, thres, chunk, keys.shape[0])


def _scores(q, k):
    """q [P, dk] . k [N, dk] in float32 (exact products of bf16 operands)."""
    return q.float() @ k.float().T


def _weighted_sum(e, v):
    """e [P, N] float32 . v [N, dv], with e rounded to v's dtype first."""
    return e.to(v.dtype).float() @ v.float()


def _online_step(m, l, acc, q, k_c, v_c, ok, scale):
    s = _scores(q, k_c) * scale
    s = torch.where(ok[None, :], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.max(dim=1).values)
    alpha = torch.exp(m - m_new)
    e = torch.exp(s - m_new[:, None])
    l_new = l * alpha + e.sum(dim=1)
    return m_new, l_new, acc * alpha[:, None] + _weighted_sum(e, v_c)


def _count_chunk(q, k_c, ok, log_thres, scale):
    s = _scores(q, k_c) * scale
    hit = (s > log_thres[:, None]) & ok[None, :]
    return hit.sum(dim=0).to(torch.float32)


def visited_slots(n: int, chunk: int, occ_bound: int) -> int:
    """Slots the occupancy-bounded read visits: the first
    ``clip(ceil(occ_bound / c), 1, ceil(n / c))`` chunks of ``c = min(chunk,
    n)`` slots. Slots at index >= n inside them are zero padding."""
    c = min(chunk, n)
    n_iter = min(max(-(-int(occ_bound) // c), 1), -(-n // c))
    return n_iter * c


def _read_occ_sweep(keys, values, valid, q, chunk, occ_bound):
    """First sweep of the occupancy-bounded read (the JAX package's
    ``_xla_read_occ``): only the visited chunks, with the valid mask applied
    inside each. -> (mem [P, dv], m [P], l [P]), l clamped at 1e-30."""
    n, dk = keys.shape
    n_visit = visited_slots(n, chunk, occ_bound)
    c = min(chunk, n)
    rows = max(n, n_visit)
    keys_p, values_p = _pad_rows(keys, rows), _pad_rows(values, rows)
    valid_p = _pad_rows(valid, rows)
    scale = 1.0 / math.sqrt(dk)
    f32 = dict(dtype=torch.float32, device=q.device)
    p_n = q.shape[0]
    m = torch.full((p_n,), NEG_INF, **f32)
    l = torch.zeros((p_n,), **f32)
    acc = torch.zeros((p_n, values.shape[1]), **f32)
    for start in range(0, n_visit, c):
        m, l, acc = _online_step(m, l, acc, q, keys_p[start:start + c],
                                 values_p[start:start + c],
                                 valid_p[start:start + c], scale)
    l = l.clamp_min(1e-30)
    return acc / l[:, None], m, l


def _count_occ_sweep(keys, valid, q, log_thres, chunk, occ_bound):
    """Second sweep of the occupancy-bounded read: usage counts of the
    visited slots (0 beyond). log_thres [P] = log(thres) + log(l) + m."""
    n, dk = keys.shape
    n_visit = min(visited_slots(n, chunk, occ_bound), n)
    scale = 1.0 / math.sqrt(dk)
    cnt = torch.zeros((n,), dtype=torch.float32, device=q.device)
    c = min(chunk, n)
    for start in range(0, n_visit, c):
        stop = min(start + c, n_visit)
        cnt[start:stop] = _count_chunk(q, keys[start:stop], valid[start:stop],
                                       log_thres, scale)
    return cnt


def _read_occ(keys, values, valid, q, thres, chunk, occ_bound):
    mem, m, l = _read_occ_sweep(keys, values, valid, q, chunk, occ_bound)
    log_thres = math.log(thres) + torch.log(l) + m
    return mem, _count_occ_sweep(keys, valid, q, log_thres, chunk, occ_bound)


def segment_length(n_visit: int, splits: int, tile: int) -> int:
    """Slots in each of the read kernel's ``splits`` segments of the
    ``n_visit`` visited slots: ``ceil(n_visit / splits)`` rounded up to
    ``tile``. Segment s covers [s len, min((s + 1) len, n_visit))."""
    per_split = -(-n_visit // splits)
    return -(-per_split // tile) * tile


def _read_occ_segments(keys, values, valid, q, chunk, occ_bound, splits,
                       tile=None):
    """Plain version of the read kernel's partials: the visited slots of
    the occupancy-bounded read cut into ``splits`` segments of whole
    ``tile``s (by default the read kernel's tile for the bank's dtype,
    :func:`.bank_read_cuda.read_tile`), each swept on its own.
    -> (m_s [S, P], l_s [S, P], acc_s [S, P, dv]), acc_s not
    normalised; a segment with no visited slot has m = -inf, l = 0,
    acc = 0. :func:`combine_partials` merges them."""
    n, dk = keys.shape
    n_visit = visited_slots(n, chunk, occ_bound)
    if tile is None:
        tile = bank_read_cuda.read_tile(keys.dtype)
    seg = segment_length(n_visit, splits, tile)
    rows = max(n, n_visit)
    keys_p, values_p = _pad_rows(keys, rows), _pad_rows(values, rows)
    valid_p = _pad_rows(valid, rows)
    scale = 1.0 / math.sqrt(dk)
    f32 = dict(dtype=torch.float32, device=q.device)
    p_n = q.shape[0]
    m_s = torch.full((splits, p_n), -math.inf, **f32)
    l_s = torch.zeros((splits, p_n), **f32)
    acc_s = torch.zeros((splits, p_n, values.shape[1]), **f32)
    c = min(chunk, n)
    for s in range(splits):
        stop = min((s + 1) * seg, n_visit)
        for start in range(s * seg, stop, c):
            end = min(start + c, stop)
            m_s[s], l_s[s], acc_s[s] = _online_step(
                m_s[s], l_s[s], acc_s[s], q, keys_p[start:end],
                values_p[start:end], valid_p[start:end], scale)
    return m_s, l_s, acc_s


def combine_partials(m_s, l_s, acc_s, thres):
    """Plain version of the combine kernel: merges segments m_s, l_s
    [..., S, P] and acc_s [..., S, P, dv] into (mem [..., P, dv], m, l,
    log_thres [..., P]) with M = max_s m_s, w_s = exp(m_s - M) (0 where
    m_s = -inf), l = sum_s w_s l_s clamped at 1e-30, mem = sum_s w_s acc_s
    / l and log_thres = log(thres) + log(l) + M."""
    m = m_s.max(dim=-2).values
    w = torch.where(m_s == -math.inf, torch.zeros_like(m_s),
                    torch.exp(m_s - m.unsqueeze(-2)))
    l = (w * l_s).sum(dim=-2).clamp_min(1e-30)
    mem = (w.unsqueeze(-1) * acc_s).sum(dim=-3) / l.unsqueeze(-1)
    return mem, m, l, math.log(thres) + torch.log(l) + m


def query_plane(q: torch.Tensor, o: int, obj_n: int) -> torch.Tensor:
    """The query that object ``o`` of an ``obj_n``-object bank reads: q
    itself when it is [P, dk], plane o // (obj_n / B) of q [B, P, dk]."""
    if q.ndim == 2:
        return q
    if obj_n % q.shape[0]:
        raise ValueError(f"{q.shape[0]} query planes do not divide "
                         f"{obj_n} objects")
    return q[o // (obj_n // q.shape[0])]


def read_plain(keys, values, valid, q, thres=1e-3, chunk=4096,
               occ_bound: Optional[int] = None):
    """Single-object plain read with the JAX package's variant selection:
    occupancy-bounded when a bound is given and the bank is larger than one
    occupancy chunk, else dense when the scores fit, else chunked."""
    if occ_bound is not None and keys.shape[0] > OCC_CHUNK:
        return _read_occ(keys, values, valid, q, thres, OCC_CHUNK,
                         int(occ_bound))
    if keys.shape[0] * q.shape[0] <= DENSE_SCORE_ELEMENTS:
        return _read_dense(keys, values, valid, q, thres)
    return _read_chunked(keys, values, valid, q, thres, chunk)


def bank_attention_read(keys: torch.Tensor, values: torch.Tensor,
                        valid: torch.Tensor, q: torch.Tensor,
                        thres: float = 1e-3, chunk: int = 4096,
                        occ_bound=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax memory read of every object's bank.

    Args:
      keys [obj, N, dk], values [obj, N, dv], valid [obj, N] bool,
      q [P, dk] query pixels, or [B, P, dk] for B streams whose banks are
      folded along the object axis (see the module's note); ``thres``:
      usage probability threshold
      (reference Matcher.thres_valid = 1e-3); ``chunk``: bank chunk of the
      plain chunked read; ``occ_bound``: optional bound on the highest
      valid slot + 1 over all objects (an int, or a 0-d int32 tensor on the
      bank's device, which the kernels read without a host sync), one for
      every stream and object. With a bound, only ``ceil(occ_bound /
      OCC_CHUNK)`` chunks are visited.

    The bank is float32 or bfloat16 (keys and values of one dtype); on a
    bf16 bank q is cast to bf16, as the Pallas kernels cast it.

    Returns: mem [obj, P, dv] in the values' dtype, cnt [obj, N] float32.
    """
    if keys.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16)
    if keys.is_cuda:
        return _kernel_read(keys, values, valid, q.contiguous(), thres,
                            occ_bound)
    bound = None if occ_bound is None else int(occ_bound)
    obj_n = keys.shape[0]
    outs = [read_plain(keys[o], values[o], valid[o], query_plane(q, o, obj_n),
                       thres, chunk, bound) for o in range(obj_n)]
    return (torch.stack([o[0] for o in outs]).to(values.dtype),
            torch.stack([o[1] for o in outs]))


def _kernel_read(keys, values, valid, q, thres, occ_bound):
    if occ_bound is not None and not torch.is_tensor(occ_bound):
        occ_bound = torch.tensor(int(occ_bound), dtype=torch.int32,
                                 device=keys.device)
    if occ_bound is not None:
        occ_bound = occ_bound.to(torch.int32).reshape(1)
    mem, _, _, log_thres = bank_read_cuda.bank_read(
        q, keys, values, valid, occ_bound, OCC_CHUNK, thres)
    cnt = bank_read_cuda.bank_count(q, keys, valid, occ_bound, log_thres,
                                    OCC_CHUNK)
    return mem.to(values.dtype), cnt
