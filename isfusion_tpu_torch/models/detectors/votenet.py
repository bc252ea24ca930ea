"""VoteNet (counterpart of ``isfusion_tpu/models/detectors/votenet.py``;
reference mmdet3d ``detectors/votenet.py``): a PointNet++ backbone ->
``VoteHead``. ``forward(batch, mode='predict' | 'feats' | 'loss')`` gives
the head's outputs ('feats'), its loss terms ('loss') or its top
proposals ('predict',
``test_cfg['max_output_num']``, default 128). Batch: points (B, N, 3 + C)
float32, points_mask (B, N); 'loss' gt_bboxes_3d (B, G, 7) bottom-centred,
gt_labels_3d (B, G), gt_mask (B, G).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import upload
from ...registry import DETECTORS
from ..builder import build_backbone, build_head


@DETECTORS.register_module()
class VoteNet(nn.Module):
    def __init__(self, backbone: dict, bbox_head: dict,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, **unused):
        super().__init__()
        self.backbone = build_backbone(backbone)
        head = dict(bbox_head)
        head.setdefault("train_cfg", train_cfg)
        head.setdefault("test_cfg", test_cfg)
        self.bbox_head = build_head(self.head_cfg(head))
        self.test_cfg = dict(test_cfg or {})

    def head_cfg(self, head: dict) -> dict:
        """The head's config as built (a subclass adds what the backbone
        fixes)."""
        return head

    def forward(self, batch: dict, mode: str = "predict", device=None,
                generator: Optional[torch.Generator] = None):
        """Runs on ``device`` (default: the CUDA card; raises if it is
        missing), where the parameters must already be. The detector draws
        no random numbers; ``generator`` is accepted for the train step's
        interface."""
        if mode not in ("predict", "feats", "loss"):
            raise ValueError(f"unknown mode {mode!r} (predict, feats or "
                             "loss)")
        t = upload(self, batch, device)
        if mode == "loss":
            return self._forward(t, mode)
        with torch.no_grad():
            return self._forward(t, mode)

    def _forward(self, t: dict, mode: str):
        feat_dict = self.backbone(t["points"].float(),
                                  t["points_mask"].bool())
        preds = self.bbox_head(feat_dict)
        if mode == "feats":
            return preds
        if mode == "loss":
            return self.bbox_head.loss(preds, t["gt_bboxes_3d"].float(),
                                       t["gt_labels_3d"], t["gt_mask"])
        return self.bbox_head.get_bboxes(preds)
