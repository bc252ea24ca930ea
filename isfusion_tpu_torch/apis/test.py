"""Evaluation API (counterpart of ``isfusion_tpu/apis/test.py``)."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..parallel.mesh import gather_objects, shard_batch, world


def _pad_rows(v, pad: int):
    """``v`` with its first row repeated ``pad`` more times."""
    if torch.is_tensor(v):
        return torch.cat([v] + [v[:1]] * pad)
    if isinstance(v, list):
        return v + v[:1] * pad
    return np.concatenate([np.asarray(v)] + [np.asarray(v)[:1]] * pad)


def single_device_test(model: torch.nn.Module, loader, device=None
                       ) -> List[dict]:
    """``model(batch, mode='predict')`` in eval mode over ``loader`` on
    ``device`` (default: the card), where the model must be. Returns one
    numpy dict per sample (bboxes, scores, labels, mask) in the loader's
    order; the model's train / eval mode is restored.

    Over several ranks (``parallel/mesh.py:world``) the loader yields
    global batches (every rank the same ones); each rank predicts its
    rows of every batch (``shard_batch``), a batch that does not split
    over the ranks padded by repeating its first sample (the JAX mesh
    eval), and every rank returns all the samples' results in the
    loader's order, the padding dropped."""
    dev = resolve_device(device)
    rank, size = world()
    was_training = model.training
    model.eval()
    results: List[dict] = []
    sizes: List[int] = []
    try:
        for batch in loader:
            arrays = {k: v for k, v in batch.items() if k != "img_metas"}
            n = len(arrays["points"])
            if size > 1:
                pad = -n % size
                arrays = shard_batch({k: _pad_rows(v, pad) for k, v in
                                      arrays.items()}, rank, size)
            out = {k: v.cpu().numpy() for k, v in
                   model(arrays, mode="predict", device=dev).items()}
            for i in range(len(arrays["points"])):
                results.append({k: v[i] for k, v in out.items()})
            sizes.append(n)
    finally:
        model.train(was_training)
    if size == 1:
        return results
    shards = gather_objects(results)
    ordered: List[dict] = []
    at = 0
    for n in sizes:
        spg = -(-n // size)
        rows = [r for s in shards for r in s[at:at + spg]]
        ordered += rows[:n]
        at += spg
    return ordered
