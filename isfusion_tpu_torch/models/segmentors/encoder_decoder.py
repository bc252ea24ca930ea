"""3D semantic segmentation (counterpart of ``isfusion_tpu/models/
segmentors/encoder_decoder.py``; reference mmdet3d ``segmentors/
encoder_decoder.py`` ``EncoderDecoder3D``): a point backbone and a decode
head. ``forward(batch, mode='predict' | 'feats' | 'loss')``: the head's
logits (B, N, num_classes) ('feats'), ``loss_sem_seg`` ('loss'), or
``semantic_pred`` (B, N) (the logits' argmax), ``logits`` and ``mask``
(the points mask) ('predict'). Batch: points (B, N, 3 + C) float32,
points_mask (B, N); 'loss' pts_semantic_mask (B, N) integer labels.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import upload
from ...registry import SEGMENTORS
from ..builder import build_backbone, build_head
from ..layers import random_source


@SEGMENTORS.register_module()
class EncoderDecoder3D(nn.Module):
    def __init__(self, backbone: dict, decode_head: dict,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, **unused):
        super().__init__()
        self.backbone = build_backbone(backbone)
        head = dict(decode_head)
        head.setdefault("sa_channels", self.backbone.sa_channels_out)
        self.decode_head = build_head(head)

    def forward(self, batch: dict, mode: str = "predict", device=None,
                generator: Optional[torch.Generator] = None):
        """Runs on ``device`` (default: the CUDA card; raises if it is
        missing), where the parameters must already be. ``generator`` is
        the source of the head's dropout in train mode (required there)."""
        if mode not in ("predict", "feats", "loss"):
            raise ValueError(f"unknown mode {mode!r} (predict, feats or "
                             "loss)")
        t = upload(self, batch, device)
        with random_source(generator), torch.set_grad_enabled(
                mode == "loss" and torch.is_grad_enabled()):
            feat_dict = self.backbone(t["points"].float(),
                                      t["points_mask"].bool())
            logits = self.decode_head(feat_dict)
            if mode == "feats":
                return logits
            if mode == "loss":
                return self.decode_head.loss(logits, t["pts_semantic_mask"],
                                             t["points_mask"].bool())
        return dict(semantic_pred=logits.argmax(-1), logits=logits,
                    mask=t["points_mask"].bool())
