"""Checkpoint save and restore with ``torch.save`` / ``torch.load``
(counterpart of ``isfusion_tpu/runner/checkpoint.py``, which uses orbax).

A checkpoint is ``work_dir/epoch_{N}.pth`` holding the model's
``state_dict`` (BatchNorm running statistics included), the optimizer's
state, the train generator state of every rank (CPU byte tensors in rank
order; one on one card) and ``meta`` (``epoch``, ``step``: the schedule's
step count). Restored, a run continues bit for bit: the data order and
augmentation depend only on (seed, epoch, index). A data-parallel run
saves from rank 0 after gathering the ranks' generator states; a resumed
run of as many ranks restores each rank's own, and another rank count
raises.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Sequence, Tuple

import torch

_NAME = re.compile(r"^epoch_(\d+)\.pth$")


def checkpoint_path(path: str) -> str:
    """``path`` itself if it is a file, else the highest ``epoch_N.pth``
    in the directory ``path``."""
    if os.path.isfile(path):
        return path
    found = [(int(m.group(1)), f) for f in os.listdir(path)
             if (m := _NAME.match(f))] if os.path.isdir(path) else []
    if not found:
        raise FileNotFoundError(f"no checkpoint in {path}")
    return os.path.join(path, max(found)[1])


def save_checkpoint(work_dir: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    generator_states: Optional[Sequence[torch.Tensor]] = None,
                    meta: Optional[dict] = None) -> str:
    """Write ``work_dir/epoch_{meta['epoch']}.pth``; returns its path.
    ``generator_states``: every rank's ``generator.get_state()``, in rank
    order."""
    meta = dict(meta or {})
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, f"epoch_{int(meta.get('epoch', 0))}.pth")
    torch.save(dict(
        state_dict=model.state_dict(),
        optimizer=None if optimizer is None else optimizer.state_dict(),
        generator_states=None if generator_states is None else [
            s.cpu() for s in generator_states],
        meta=meta), path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    generator: Optional[torch.Generator] = None,
                    rank: int = 0, world_size: int = 1) -> dict:
    """Restore the model (and the optimizer, and ``generator`` to rank
    ``rank``'s saved state, when given) from ``path`` (a file, or a
    directory: its latest epoch); returns ``meta``. Raises when the
    checkpoint holds another number of ranks than ``world_size``."""
    ckpt = torch.load(checkpoint_path(path),
                      map_location=next(model.parameters()).device,
                      weights_only=True)
    if generator is not None:
        states = ckpt["generator_states"]
        if len(states) != world_size:
            raise ValueError(f"{path} holds the generators of {len(states)} "
                             f"ranks; this run has {world_size}")
    model.load_state_dict(ckpt["state_dict"])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    if generator is not None:
        generator.set_state(states[rank].cpu())
    return ckpt["meta"]


def load_params(path: str) -> Tuple[dict, dict]:
    """(state_dict on the CPU, meta) for inference: no optimizer needed."""
    ckpt = torch.load(checkpoint_path(path), map_location="cpu",
                      weights_only=True)
    return ckpt["state_dict"], ckpt["meta"]
