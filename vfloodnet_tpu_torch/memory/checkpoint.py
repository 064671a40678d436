"""Bank checkpoints of a video run, for resuming a long video (the
counterpart of the JAX runner's ``checkpoint_every``, which saves the bank
through orbax; the port keeps its own format).

A checkpoint is one ``torch.save`` file, ``<dir>/bank.pt``: the state's
tensors (copied to the host, which waits for the card), its host
occupancy bound, and the index of the last frame the bank has seen. It is
written under a temporary name and renamed into place, so a run killed
while writing leaves the previous checkpoint whole. The JAX package's orbax
checkpoints are not read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from .feature_bank import FeatureBank, FeatureBankState, OccupancyBound

FILE = "bank.pt"
TENSORS = tuple(f.name for f in dataclasses.fields(FeatureBankState)
                if f.name != "occ_host")


def save_bank_checkpoint(ckpt_dir: str, state: FeatureBankState,
                         frame_idx: int) -> str:
    """Write ``state`` after frame ``frame_idx``; returns the file's
    path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    blob = {"state": {k: getattr(state, k).cpu() for k in TENSORS},
            "occ_bound": int(state.occ_host.bound),
            "frame_idx": int(frame_idx)}
    path = os.path.join(ckpt_dir, FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def load_bank_checkpoint(ckpt_dir: str, fb: FeatureBank
                         ) -> Optional[Tuple[FeatureBankState, int]]:
    """(state on ``fb``'s device, index of the last frame it has seen)
    from ``ckpt_dir``, or None when there is no checkpoint; raises if the
    checkpoint does not fit ``fb`` (capacity, widths, dtype, objects)."""
    path = os.path.join(ckpt_dir, FILE)
    if not os.path.exists(path):
        return None
    blob = torch.load(path, map_location="cpu", weights_only=True)
    tensors = blob["state"]
    keys = tensors["keys"]
    want = (fb.class_budget, fb.keydim)
    if tuple(keys.shape[1:]) != want or keys.dtype != fb.dtype \
            or keys.shape[0] % fb.obj_n \
            or tensors["values"].shape[-1] != fb.valdim:
        raise ValueError(f"bank checkpoint {path} holds {keys.dtype} keys "
                         f"{tuple(keys.shape)}, not rows of {fb.obj_n} "
                         f"objects x {want} {fb.dtype}")
    state = FeatureBankState(
        **{k: tensors[k].to(fb.device) for k in TENSORS},
        occ_host=OccupancyBound(blob["occ_bound"], fb.class_budget))
    return state, int(blob["frame_idx"])
