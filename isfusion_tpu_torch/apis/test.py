"""Evaluation API (counterpart of ``isfusion_tpu/apis/test.py``)."""
from __future__ import annotations

from typing import List

import torch

from .. import resolve_device


def single_device_test(model: torch.nn.Module, loader, device=None
                       ) -> List[dict]:
    """``model(batch, mode='predict')`` in eval mode over ``loader`` on
    ``device`` (default: the card), where the model must be. Returns one
    numpy dict per sample (bboxes, scores, labels, mask) in the loader's
    order; the model's train / eval mode is restored."""
    dev = resolve_device(device)
    was_training = model.training
    model.eval()
    results: List[dict] = []
    try:
        for batch in loader:
            arrays = {k: v for k, v in batch.items() if k != "img_metas"}
            out = {k: v.cpu().numpy() for k, v in
                   model(arrays, mode="predict", device=dev).items()}
            for i in range(arrays["points"].shape[0]):
                results.append({k: v[i] for k, v in out.items()})
    finally:
        model.train(was_training)
    return results
