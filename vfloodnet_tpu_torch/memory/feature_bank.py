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

The transition methods update the state's tensors in place and return it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.device import resolve_device
from ..ops.bank_update import OCC_CHUNK, bank_merge_append


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class FeatureBankState:
    keys: torch.Tensor       # [obj_n, cap, dk] in the bank's dtype
    values: torch.Tensor     # [obj_n, cap, dv] in the bank's dtype
    valid: torch.Tensor      # [obj_n, cap] bool
    birth: torch.Tensor      # [obj_n, cap] f32, frame the slot was written
    usage: torch.Tensor      # [obj_n, cap] f32, accumulated log usage
    peak_n: torch.Tensor     # [obj_n] i32, most occupied slots seen
    replace_n: torch.Tensor  # [obj_n] i32, evictions so far
    occ: torch.Tensor        # [obj_n] i32, occupancy of the dense prefix

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

    def empty(self) -> FeatureBankState:
        o, cap, dev = self.obj_n, self.class_budget, self.device
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
            occ=torch.zeros((o,), **i32))

    def init_bank(self, keys: torch.Tensor, values: torch.Tensor,
                  frame_idx: float = 0.0) -> FeatureBankState:
        """Seed the bank with the first frame's features, keys [obj_n, P,
        dk] and values [obj_n, P, dv] (reference FeatureBank.py:27-36)."""
        p = keys.shape[1]
        if p > self.class_budget:
            raise ValueError(f"first-frame features ({p}) exceed per-class "
                             f"budget ({self.class_budget})")
        state = self.empty()
        state.keys[:, :p] = keys.to(self.dtype)
        state.values[:, :p] = values.to(self.dtype)
        state.valid[:, :p] = True
        state.birth[:, :p] = frame_idx
        state.peak_n.fill_(p)
        state.occ.fill_(p)
        return state

    def append(self, state: FeatureBankState, keys: torch.Tensor,
               values: torch.Tensor, frame_idx: float = 0.0
               ) -> FeatureBankState:
        """Insert extra features unconditionally with usage 20 (reference
        FeatureBank.append, :38-51): they extend the prefix, overwriting the
        lowest-LFU valid slots only when it is full."""
        n = state.capacity
        m = keys.shape[1]
        k = min(m, n)
        rank = torch.arange(m, device=state.keys.device)
        for o, occ in enumerate(state.occ.tolist()):
            age = torch.clamp(frame_idx - state.birth[o], min=1.0)
            prio = torch.where(state.valid[o], state.usage[o] / age,
                               torch.full_like(age, 1e30))
            victim_order = torch.sort(prio, stable=True).indices[:k]
            victim = victim_order[torch.clamp(rank - (n - occ), 0, k - 1)]
            victim = torch.where(prio[victim] < 1e30, victim,
                                 torch.full_like(victim, n))
            d = torch.where(rank < n - occ, occ + rank, victim)
            rows = torch.nonzero(d < n).squeeze(1)
            d = d[rows]
            state.keys[o, d] = keys[o, rows].to(self.dtype)
            state.values[o, d] = values[o, rows].to(self.dtype)
            state.birth[o, d] = float(frame_idx)
            state.usage[o, d] = 20.0   # FeatureBank.py:46
            state.valid[o, d] = True
        state.occ.clamp_(max=n - m).add_(m)
        torch.maximum(state.peak_n, state.occ, out=state.peak_n)
        return state

    def record_usage(self, state: FeatureBankState,
                     usage_cnt: torch.Tensor) -> FeatureBankState:
        """Add the read's usage counts, ``log(1 + cnt)`` (reference
        AFB_URR.py:174)."""
        usage = torch.clamp(state.usage + torch.log1p(usage_cnt), 0.0, 1e5)
        state.usage = torch.where(state.valid, usage,
                                  torch.zeros_like(usage))
        return state

    def update(self, state: FeatureBankState, new_keys: torch.Tensor,
               new_values: torch.Tensor, frame_idx: float
               ) -> FeatureBankState:
        """Merge, append or evict one frame of features, new_keys [obj_n,
        P, dk] and new_values [obj_n, P, dv] (FeatureBank.py:53-115)."""
        occ = state.occ.tolist()
        occ_bound = max(occ)
        occ_new, evicted = [], []
        for o in range(state.obj_n):
            occ_o, stats = bank_merge_append(
                state.keys[o], state.values[o], state.valid[o],
                state.birth[o], state.usage[o],
                new_keys[o].to(self.dtype), new_values[o].to(self.dtype),
                float(frame_idx), occ[o], occ_bound,
                update_rate=self.update_rate, thres_close=self.thres_close)
            occ_new.append(occ_o)
            evicted.append(stats.evicted_n)
        state.occ.copy_(torch.tensor(occ_new, dtype=torch.int32))
        state.replace_n.add_(torch.tensor(evicted, dtype=torch.int32,
                                          device=state.occ.device))
        torch.maximum(state.peak_n, state.occ, out=state.peak_n)
        return state

    def report(self, state: FeatureBankState) -> str:
        """Bank health (reference FeatureBank.print_peak_mem)."""
        ur = (state.peak_n.cpu().numpy() / self.class_budget)
        rr = (state.replace_n.cpu().numpy() / self.class_budget)
        return (f"Obj num: {self.obj_n}. Budget / obj: {self.class_budget}. "
                f"UR: {ur}. Replace: {rr}.")
