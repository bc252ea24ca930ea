"""Helpers shared by the port's checks on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``): what makes a PointPillars prediction on
the card comparable with the same prediction on the CPU."""
from __future__ import annotations

import torch


def tame_box_deltas(model, scale: float = 0.01):
    """Scale the Anchor3DHead's box-regression weights by ``scale``.
    Seeded random weights regress size residuals whose exp() decodes to
    boxes far wider than the scene; the NMS over such boxes rests on
    float32 rounding, which the card and the CPU do differently. Scaled,
    the boxes stay near their anchors (scene-sized)."""
    with torch.no_grad():
        model.pts_bbox_head.conv_reg.weight.mul_(scale)
    return model


def pp_kept_boxes(model, batch: dict, dev: str):
    """Every box the model keeps after NMS (``max_num`` lifted so that no
    near-tie decides which ones make the cut), in a canonical order:
    (boxes, scores, sample * C + label) sorted by that key, then by x."""
    head = model.pts_bbox_head
    cfg = dict(head.test_cfg)
    head.test_cfg["max_num"] = int(cfg.get("nms_pre", 1000)) * \
        head.num_classes
    try:
        out = {k: v.cpu() for k, v in model(batch, device=dev).items()}
    finally:
        head.test_cfg = cfg
    m = out["mask"]
    key = (torch.arange(m.shape[0])[:, None] * head.num_classes +
           out["labels"])[m]
    boxes, scores = out["bboxes"][m], out["scores"][m]
    o = torch.argsort(boxes[:, 0], stable=True)
    o = o[torch.argsort(key[o], stable=True)]
    return boxes[o], scores[o], key[o]
