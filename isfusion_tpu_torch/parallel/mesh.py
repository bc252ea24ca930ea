"""Process-group helpers of the data-parallel step (counterpart of
``isfusion_tpu/parallel/mesh.py``).

The JAX package puts its data-parallel ranks on one mesh axis ``data`` and
compiles the collectives into the step. The port runs one process per
rank, as the reference's ``torch.distributed`` launcher does, and uses the
collectives of ``torch.distributed`` (NCCL on the cards, gloo on the CPU):

- ``init_distributed`` joins the group that ``torchrun`` describes;
- ``shard_batch`` is ``NamedSharding(P("data"))``: rank ``r`` takes rows
  ``[r * spg, (r + 1) * spg)`` of a global batch;
- ``all_reduce_mean_`` is the gradient pmean: one flat buffer, one
  collective;
- ``gather_objects`` collects the eval results on every rank.

The data-parallel ranks are those of the default process group, and
``group()`` / ``world()`` are the one place that says so: the sync
BatchNorms, the train step, the eval and ``train_model`` all read them.
Without a group ``group()`` is None, ``world()`` is ``(0, 1)`` and
nothing here communicates.
"""
from __future__ import annotations

import os
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def init_distributed(backend: str = "nccl", device=None) -> torch.device:
    """Join the process group that ``torchrun`` describes in ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
    returns this rank's device: ``cuda:LOCAL_RANK`` (made current), or the
    CPU when ``device`` is ``'cpu'``. Raises when a variable is missing,
    when NCCL is asked for off the card, or when the group cannot be
    made: a rank never falls back to training alone."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--launcher pytorch needs torchrun's "
                           f"environment; missing {missing}")
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        dev = resolve_device(f"cuda:{int(os.environ['LOCAL_RANK'])}")
        torch.cuda.set_device(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise RuntimeError("the nccl backend runs on the card; use gloo "
                           "(--cfg-options dist_params.backend=gloo) on the "
                           "CPU")
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=size)
    return dev


def group():
    """The data-parallel group: the default process group once one is
    made (``init_distributed``), else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def world() -> Tuple[int, int]:
    """(rank, size) in ``group()``, (0, 1) without one."""
    if group() is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _rows(v, lo: int, hi: int):
    if torch.is_tensor(v) or isinstance(v, np.ndarray):
        return v[lo:hi]
    if isinstance(v, (list, tuple)):
        return type(v)(v[lo:hi])
    raise TypeError(f"cannot shard a {type(v).__name__}")


def shard_batch(batch: dict, rank: int, size: int) -> dict:
    """Rows ``[rank * spg, (rank + 1) * spg)`` of every entry of a global
    batch of ``spg * size`` rows."""
    n = len(next(iter(batch.values())))
    if n % size:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{size} ranks")
    spg = n // size
    return {k: _rows(v, rank * spg, (rank + 1) * spg)
            for k, v in batch.items()}


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> int:
    """Replace each tensor by its mean over the ranks of ``group()``: the
    tensors go through one flat buffer and one ``all_reduce``. All share a
    dtype and a device. Returns the bytes of the buffer."""
    if not tensors:
        return 0
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one dtype per all-reduce, got "
                         f"{sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return flat.numel() * flat.element_size()


def gather_objects(obj: Any) -> List[Any]:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
