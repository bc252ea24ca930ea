"""FCOSMono3D (counterpart of
``isfusion_tpu/models/detectors/single_stage_mono3d.py``; reference
``mmdet3d/models/detectors/fcos_mono3d.py``): one camera image through
the backbone (ResNet), the neck (FPN) and ``FCOSMono3DHead``.

``forward(batch, mode='predict' | 'feats' | 'loss')``: the head's
per-level maps ('feats'), its loss dict ('loss') or the decoded
camera-frame boxes, a fixed top ``test_cfg.max_per_img`` (default 200)
with a mask ('predict'). Batch contract in
``dense_heads/fcos_mono3d_head.py``; numpy arrays or tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import upload
from ...registry import DETECTORS
from ..builder import build_backbone, build_head, build_neck


@DETECTORS.register_module()
class FCOSMono3D(nn.Module):
    def __init__(self, backbone, neck=None, bbox_head=None, train_cfg=None,
                 test_cfg=None, **unused):
        super().__init__()
        self.backbone = build_backbone(backbone)
        self.neck = build_neck(neck) if neck else None
        self.test_cfg = dict(test_cfg or {})
        self.bbox_head = build_head(bbox_head, train_cfg=train_cfg,
                                    test_cfg=test_cfg)

    def extract_feat(self, img: torch.Tensor):
        """img (B, H, W, 3) -> per level (B, h, w, C)."""
        x = self.backbone(img)
        if self.neck is not None:
            x = self.neck(x)
        return [x] if torch.is_tensor(x) else list(x)

    def forward(self, batch: dict, mode: str = "predict", device=None,
                generator: Optional[torch.Generator] = None):
        """Runs on ``device`` (default: the CUDA card; raises if it is
        missing), where the parameters must already be. The detector draws
        no random numbers; ``generator`` is accepted for the train step's
        interface."""
        if mode not in ("predict", "feats", "loss"):
            raise ValueError(f"unknown mode {mode!r} (predict, feats or "
                             "loss)")
        if mode == "loss":
            return self._forward(batch, mode, device)
        with torch.no_grad():
            return self._forward(batch, mode, device)

    def _forward(self, batch, mode, device):
        t = upload(self, batch, device)
        preds = self.bbox_head(self.extract_feat(t["img"].float()))
        if mode == "feats":
            return preds
        if mode == "loss":
            return self.bbox_head.loss(preds, t)
        return self.bbox_head.get_bboxes(
            preds, t["cam2img"], int(self.test_cfg.get("max_per_img", 200)))
