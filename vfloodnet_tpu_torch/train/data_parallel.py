"""Data parallelism of the video and image trainers (the JAX trainers'
``mesh=`` and ``--data-parallel``).

A data-parallel step runs on every rank of the mesh's ``data`` axis with
the same global batch: each rank takes its contiguous share of it
(:func:`data_shard`, JAX's ``P("data")``), computes its loss and
gradients, and the gradients are averaged over the data group before the
optimiser (:func:`average_grads`), so its clip sees the global gradient
and the weights stay equal on every rank. Live BatchNorm statistics are
those of the global batch: the image trainer's BNs all-reduce their sums
in the forward pass (``TrainBN.group``); the video trainer's are per clip,
and their running updates are averaged over the ranks' clips.

The ranks of a ``model`` axis share a data index: they take the same
share of the batch, and the video trainer lays its conv kernels out over
them (``train_video.shard_train_state``, :mod:`.model_parallel`); the
image trainer computes replicated over them, as JAX's does. What they
compute replicated may differ in its last bits from rank to rank
(cuDNN's backward is not deterministic), so its gradients and running
statistics are averaged over the model group as well, and the
replicated state stays equal on every rank.

:func:`spawn_ranks` starts one rank per GPU (or two CPU processes) and
joins them, for the trainers' ``--data-parallel``.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, List, Optional

import torch
import torch.distributed as dist

from ..parallel import (DATA_AXIS, MODEL_AXIS, Mesh, close_world, init_rank,
                        make_mesh)


def data_shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous share of the global batch ``x`` along axis
    0; the batch must divide by the data axis."""
    n, d = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{n} data-parallel ranks")
    per = x.shape[0] // n
    return x[d * per:(d + 1) * per]


def mean_over_group(tensors: List[torch.Tensor], group
                    ) -> List[torch.Tensor]:
    """Each tensor's mean over the process ``group`` (a mesh's data or
    model group; new tensors, detached), in one all-reduce of their
    concatenation; the tensors share a dtype."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    return [x.view_as(t) for x, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def average_grads(params: Iterable[torch.Tensor], group) -> None:
    """Each parameter's ``.grad`` set to its mean over ``group``."""
    params = [p for p in params if p.grad is not None]
    for p, g in zip(params, mean_over_group([p.grad for p in params],
                                            group)):
        p.grad.copy_(g)


def broadcast_model(model: torch.nn.Module, mesh: Mesh) -> None:
    """Every parameter and buffer of ``model`` set to the first data
    rank's, so that the ranks start equal."""
    src = int(mesh.ranks[0, mesh.index(MODEL_AXIS)])
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t, src, group=mesh.data_group)


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes logs and checkpoints: always without a
    mesh, else rank 0 alone."""
    return mesh is None or mesh.rank == 0


def _rank_main(rank: int, world: int, store: str, device_type: str,
               fn: Callable, args: tuple) -> None:
    if device_type == "cuda":
        device = torch.device(device_type, rank)
    else:   # the host's cores shared among the CPU ranks
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_rank(store, rank, world, device)
    try:
        fn(make_mesh(device=device), device, *args)
    finally:
        close_world()


def spawn_ranks(fn: Callable, args: tuple, device: str,
                run_dir: str) -> None:
    """Run ``fn(mesh, device, *args)`` on a world of one rank per visible
    GPU (``device`` 'cuda', NCCL) or of two CPU processes (gloo: the
    path's check without a card), started with ``torch.multiprocessing``
    and joined; the ranks meet at a ``FileStore`` in ``run_dir``. ``fn``
    must be a module-level function."""
    device_type = torch.device(device).type
    if device_type == "cuda":
        world = torch.cuda.device_count()
        if world < 1:
            raise RuntimeError("--data-parallel found no GPU")
    else:
        world = 2
    os.makedirs(run_dir, exist_ok=True)
    store = os.path.join(run_dir, "dist_store")
    if os.path.exists(store):
        os.remove(store)
    torch.multiprocessing.spawn(
        _rank_main, args=(world, store, device_type, fn, args),
        nprocs=world, join=True)

