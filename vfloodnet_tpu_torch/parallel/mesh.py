"""The process mesh (counterpart of ``vfloodnet_tpu.parallel.mesh``).

The JAX package lays its devices out as a 2-D mesh with a ``data`` axis
(batch and clip parallelism in training) and a ``model`` axis (the feature
bank's capacity sharded for the memory read). Here a device is a rank of a
``torch.distributed`` world, one rank per GPU (NCCL), or per CPU process
(gloo): :func:`make_mesh` lays the world's ranks out row-major over
(data, model), as ``np.asarray(devices).reshape(shape)`` does, and keeps
this rank's coordinates and its two groups, the ranks that share its model
index (its data group) and those that share its data index (its model
group).

The world is set up by the caller: :func:`init_local_world` makes a world
of one in this process (a ``HashStore``: no socket, no spawned process),
:func:`init_rank` joins rank ``r`` of a world through a ``FileStore``. No
environment variable is read.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
_AXES = (DATA_AXIS, MODEL_AXIS)   # the mesh's axes, in order


# how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=300)


def _init(store, rank: int, world: int, device) -> None:
    """NCCL on a CUDA ``device`` (which becomes the current one), gloo on
    the CPU."""
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world,
                            timeout=TIMEOUT, **kw)


def init_local_world(device="cuda") -> None:
    """A world of one rank in this process over an in-memory store."""
    _init(dist.HashStore(), 0, 1, device)


def init_rank(store_path: str, rank: int, world: int, device) -> None:
    """Join rank ``rank`` of a world of ``world`` ranks that meet at the
    file ``store_path`` (a ``FileStore``; every rank names the same path,
    which must not hold an earlier world's store)."""
    _init(dist.FileStore(store_path, world), rank, world, device)


def close_world() -> None:
    """Leave the world, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, model) layout of the world."""
    shape: Tuple[int, int]
    rank: int
    coords: Tuple[int, int]   # (data index, model index) of this rank
    ranks: np.ndarray         # world ranks laid out [data, model]
    groups: Tuple[object, object]   # (data group, model group)
    device: torch.device

    def axis(self, name: str) -> int:
        return _AXES.index(name)

    def size(self, name: str) -> int:
        return self.shape[self.axis(name)]

    def index(self, name: str) -> int:
        return self.coords[self.axis(name)]

    def group(self, name: str):
        return self.groups[self.axis(name)]

    @property
    def data_group(self):
        return self.group(DATA_AXIS)

    @property
    def model_group(self):
        return self.group(MODEL_AXIS)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device=None) -> Mesh:
    """This rank's :class:`Mesh` of the current world. Default shape: every
    rank on the data axis, (world, 1). Every rank of the world must call
    it, with the same shape (it makes the groups of both axes). ``device``
    defaults to the current CUDA device under NCCL, else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed world: "
                           "init_local_world() or init_rank()")
    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} != device count {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    rank = dist.get_rank()
    ranks = np.arange(world).reshape(shape)
    # every rank creates every group, in the same order
    data_group = model_group = None
    for m in range(shape[1]):
        g = dist.new_group(ranks[:, m].tolist())
        if rank in ranks[:, m]:
            data_group = g
    for d in range(shape[0]):
        g = dist.new_group(ranks[d, :].tolist())
        if rank in ranks[d, :]:
            model_group = g
    d, m = (int(x[0]) for x in np.nonzero(ranks == rank))
    return Mesh(shape, rank, (d, m), ranks,
                (data_group, model_group), torch.device(device))
