"""Inference API (counterpart of ``isfusion_tpu/apis/inference.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..config import Config


def init_model(config, checkpoint: Optional[str] = None, device=None,
               seed: Optional[int] = None) -> torch.nn.Module:
    """The detector of ``config`` (a path or a Config) on ``device``
    (default: the card), in eval mode: weights from ``checkpoint`` (a
    file, or a directory's latest epoch) if given, else drawn from
    ``seed`` (default ``cfg.seed``, else 0)."""
    from ..models.builder import build_detector
    from ..models.layers import init_weights
    from ..runner.checkpoint import load_params

    cfg = Config.fromfile(config) if isinstance(config, str) else config
    if seed is None:
        seed = int(cfg.get("seed", 0) or 0)
    model = init_weights(build_detector(dict(cfg.model)), seed)
    if checkpoint:
        model.load_state_dict(load_params(checkpoint)[0])
    return model.to(resolve_device(device)).eval()


def inference_detector(model: torch.nn.Module, batch: dict,
                       device=None) -> dict:
    """One batch (the padded contract; 'img_metas' is ignored) -> numpy
    dict(bboxes, scores, labels, mask)."""
    out = model({k: v for k, v in batch.items() if k != "img_metas"},
                mode="predict", device=device)
    return {k: v.cpu().numpy() for k, v in out.items()}
