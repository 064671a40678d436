"""Adaptive Feature Bank as fixed-capacity tensors (counterpart of
``vfloodnet_tpu.memory.feature_bank``).

Per object, ``capacity`` pre-allocated slots of keys and values (float32,
or bfloat16 with ``dtype``; the bookkeeping stays float32 and int32) with a
validity mask, the frame each slot was written, its accumulated log usage,
and the occupancy ``occ``: all valid slots lie in ``[0, occ)``, so reads and
matches cost O(occupancy) like the reference's growing bank.

Capacity follows the reference budget (memory_budget // obj_n, times 0.8
for two objects), rounded up to a multiple of 128 and, above one occupancy
chunk, down to a multiple of it: 98,304 slots per object at the default
budget of 250,000 with two objects.

One state may hold the banks of B streams, folded along the object axis
(rows ``[stream 0's objects, stream 1's, ...]``, ``B x obj_n`` of them): the
batch engine's layout, which the read kernels take in one launch. The
transition methods treat every row alike, along one leading axis, and the
occupancy bound is one for all rows, as the JAX batch engine shares one
bound across its streams.

The transition methods update the state's tensors in place (so a CUDA
graph that captured them keeps reading the live bank) and return it. None
of them waits for the host: ``occ`` stays on the device, and the host keeps
an upper bound of it (:class:`OccupancyBound`) that decides how many chunks
the match visits and whether LFU victims are selected.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.device import resolve_device
from ..ops.bank_update import (OCC_CHUNK, bank_merge_append, device_scalar,
                               lfu_victims, match_chunks, scatter_rows)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class OccupancyBound:
    """A host upper bound of every object's occupancy, kept without a sync.

    An update of M features per object raises occupancy by at most M, so
    :meth:`grow` adds M. After each update the device's ``occ`` is copied
    into pinned memory behind an event; once a later call finds that event
    complete (a non-blocking query), the bound drops to the copied value
    plus what was grown since the copy. A loose bound only makes the match
    visit chunks of invalid slots and select victims that are not used: the
    results are the same. On a CPU bank the bound is read exactly.
    """

    def __init__(self, bound: int, capacity: int):
        self.capacity = capacity
        self.bound = min(int(bound), capacity)
        self._host: Optional[torch.Tensor] = None   # pinned copy of occ
        self._event = None
        self._pending = False    # a copy is in flight behind _event
        self._since = 0          # grown since that copy was enqueued

    def grow(self, m: int) -> None:
        self.bound = min(self.bound + int(m), self.capacity)
        self._since += int(m)

    def refresh(self, occ: torch.Tensor) -> None:
        """Tighten the bound from the last copy of ``occ`` if it has
        landed, and start the next copy."""
        if not occ.is_cuda:
            self.bound = int(occ.max())
            return
        if self._pending:
            if not self._event.query():
                return
            self.bound = min(self.bound, int(self._host.max()) + self._since)
        if self._host is None:
            self._host = torch.empty(occ.shape, dtype=occ.dtype,
                                     pin_memory=True)
            self._event = torch.cuda.Event()
        self._host.copy_(occ, non_blocking=True)
        self._event.record()
        self._pending = True
        self._since = 0

    def reset(self, occ: torch.Tensor) -> None:
        """Set the bound to ``occ`` exactly (a host sync), after ``occ``
        was edited from outside the transition methods."""
        self.bound = int(occ.max())
        self._pending = False
        self._since = 0


@dataclasses.dataclass
class FeatureBankState:
    # rows: obj_n, or B x obj_n for B streams folded along the object axis
    keys: torch.Tensor       # [rows, cap, dk] in the bank's dtype
    values: torch.Tensor     # [rows, cap, dv] in the bank's dtype
    valid: torch.Tensor      # [rows, cap] bool
    birth: torch.Tensor      # [rows, cap] f32, frame the slot was written
    usage: torch.Tensor      # [rows, cap] f32, accumulated log usage
    peak_n: torch.Tensor     # [rows] i32, most occupied slots seen
    replace_n: torch.Tensor  # [rows] i32, evictions so far
    occ: torch.Tensor        # [rows] i32, occupancy of the dense prefix
    # host upper bound of occ (a FeatureBank makes one with each state)
    occ_host: Optional[OccupancyBound] = None

    @property
    def obj_n(self) -> int:
        return self.keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=1)


class FeatureBank:
    """Factory and transition functions of :class:`FeatureBankState`."""

    def __init__(self, obj_n: int, memory_budget: int = 250_000,
                 update_rate: float = 0.1, thres_close: float = 0.95,
                 keydim: int = 128, valdim: int = 512,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.obj_n = obj_n
        class_budget = memory_budget // obj_n
        if obj_n == 2:
            class_budget = int(0.8 * class_budget)
        self.class_budget = _round_up(max(class_budget, 128), 128)
        if self.class_budget > OCC_CHUNK:
            self.class_budget = max(OCC_CHUNK, (self.class_budget // OCC_CHUNK)
                                    * OCC_CHUNK)
        self.update_rate = update_rate
        self.thres_close = thres_close
        self.keydim = keydim
        self.valdim = valdim
        self.dtype = dtype
        self.device = resolve_device(device)

    def empty(self, streams: int = 1) -> FeatureBankState:
        """An empty state for ``streams`` streams (``streams x obj_n``
        rows)."""
        o, cap, dev = self.obj_n * streams, self.class_budget, self.device
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        return FeatureBankState(
            keys=torch.zeros((o, cap, self.keydim), dtype=self.dtype,
                             device=dev),
            values=torch.zeros((o, cap, self.valdim), dtype=self.dtype,
                               device=dev),
            valid=torch.zeros((o, cap), dtype=torch.bool, device=dev),
            birth=torch.zeros((o, cap), **f32),
            usage=torch.zeros((o, cap), **f32),
            peak_n=torch.zeros((o,), **i32),
            replace_n=torch.zeros((o,), **i32),
            occ=torch.zeros((o,), **i32),
            occ_host=OccupancyBound(0, cap))

    def init_bank(self, keys: torch.Tensor, values: torch.Tensor,
                  frame_idx: float = 0.0) -> FeatureBankState:
        """Seed the bank with the first frame's features, keys [obj_n, P,
        dk] and values [obj_n, P, dv] (reference FeatureBank.py:27-36), or
        those of the first frames of B streams, [B x obj_n, P, d]."""
        rows, p = keys.shape[:2]
        if p > self.class_budget:
            raise ValueError(f"first-frame features ({p}) exceed per-class "
                             f"budget ({self.class_budget})")
        if rows % self.obj_n:
            raise ValueError(f"{rows} rows of features are not whole "
                             f"streams of {self.obj_n} objects")
        state = self.empty(rows // self.obj_n)
        state.keys[:, :p] = keys.to(self.dtype)
        state.values[:, :p] = values.to(self.dtype)
        state.valid[:, :p] = True
        state.birth[:, :p] = frame_idx
        state.peak_n.fill_(p)
        state.occ.fill_(p)
        state.occ_host = OccupancyBound(p, self.class_budget)
        return state

    def append(self, state: FeatureBankState, keys: torch.Tensor,
               values: torch.Tensor, frame_idx=0.0) -> FeatureBankState:
        """Insert extra features unconditionally with usage 20 (reference
        FeatureBank.append, :38-51): they extend the prefix, overwriting the
        lowest-LFU valid slots only when it is full."""
        n = state.capacity
        m = keys.shape[1]
        k = min(m, n)
        dev = state.keys.device
        fi = device_scalar(frame_idx, torch.float32, dev)
        rank = torch.arange(m, device=dev)[None, :]
        occ = state.occ[:, None]
        age = torch.clamp(fi - state.birth, min=1.0)
        prio = torch.where(state.valid, state.usage / age,
                           torch.full_like(age, 1e30))
        victim = lfu_victims(prio, k).gather(
            1, torch.clamp(rank - (n - occ), 0, k - 1))
        victim = torch.where(prio.gather(1, victim) < 1e30, victim,
                             torch.full_like(victim, n))
        dest = torch.where(rank < n - occ, occ + rank, victim)
        scatter_rows(dest, dest < n, (
            (state.keys, keys), (state.values, values), (state.birth, fi),
            (state.usage, 20.0), (state.valid, True)))  # :46
        state.occ.clamp_(max=n - m).add_(m)
        torch.maximum(state.peak_n, state.occ, out=state.peak_n)
        self.note_update(state, m)
        return state

    def record_usage(self, state: FeatureBankState,
                     usage_cnt: torch.Tensor) -> FeatureBankState:
        """Add the read's usage counts, ``log(1 + cnt)`` (reference
        AFB_URR.py:174), in place."""
        usage = torch.clamp(state.usage + torch.log1p(usage_cnt), 0.0, 1e5)
        state.usage.copy_(torch.where(state.valid, usage,
                                      torch.zeros_like(usage)))
        return state

    def plan(self, state: FeatureBankState, m: int) -> Tuple[int, bool]:
        """What the state's occupancy bound decides for an update of ``m``
        features per object: (chunks the match visits, whether LFU victims
        are selected). Two updates with the same plan run the same work."""
        bound = state.occ_host.bound
        return (match_chunks(state.capacity, bound),
                bound + m > state.capacity)

    def note_update(self, state: FeatureBankState, m: int) -> None:
        """Host bookkeeping after an update of ``m`` features per object
        was enqueued: grow the occupancy bound and refresh it."""
        state.occ_host.grow(m)
        state.occ_host.refresh(state.occ)

    def update_device(self, state: FeatureBankState, new_keys: torch.Tensor,
                      new_values: torch.Tensor, frame_idx,
                      occ_bound: int) -> FeatureBankState:
        """The device part of :meth:`update`, for the host occupancy bound
        ``occ_bound``: stream work only, so it can be captured in a CUDA
        graph (whose replays then hold for every bound of the same
        :meth:`plan`). The caller calls :meth:`note_update` after it has
        run or been replayed."""
        occ_new, stats = bank_merge_append(
            state.keys, state.values, state.valid, state.birth, state.usage,
            new_keys.to(self.dtype), new_values.to(self.dtype), frame_idx,
            state.occ, occ_bound, update_rate=self.update_rate,
            thres_close=self.thres_close)
        state.occ.copy_(occ_new)
        state.replace_n.add_(stats.evicted_n)
        torch.maximum(state.peak_n, state.occ, out=state.peak_n)
        return state

    def update(self, state: FeatureBankState, new_keys: torch.Tensor,
               new_values: torch.Tensor, frame_idx) -> FeatureBankState:
        """Merge, append or evict one frame of features, new_keys [rows,
        P, dk] and new_values [rows, P, dv] (FeatureBank.py:53-115), every
        row of the state at once."""
        self.update_device(state, new_keys, new_values, frame_idx,
                           state.occ_host.bound)
        self.note_update(state, new_keys.shape[1])
        return state

    def report(self, state: FeatureBankState) -> str:
        """Bank health (reference FeatureBank.print_peak_mem)."""
        ur = (state.peak_n.cpu().numpy() / self.class_budget)
        rr = (state.replace_n.cpu().numpy() / self.class_budget)
        return (f"Obj num: {self.obj_n}. Budget / obj: {self.class_budget}. "
                f"UR: {ur}. Replace: {rr}.")
