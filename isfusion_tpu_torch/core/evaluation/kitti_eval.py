"""KITTI 3D detection metrics (counterpart of
``isfusion_tpu/core/evaluation/kitti_eval.py``; reference
``mmdet3d/core/evaluation/kitti_utils/eval.py``): per-class AP at the
easy / moderate / hard levels (2D box height, occlusion, truncation),
detections matched by rotated BEV or 3D IoU at 0.7 (car) or 0.5
(pedestrian, cyclist), 40-point interpolated AP.

The IoU runs through ``ops/box_ops.py`` on ``device`` (default: the CUDA
card; raises if it is missing): ``boxes_iou_bev`` (K10-BEV on the card)
and ``boxes_iou_3d`` (K10), their plain versions on the CPU. A sample's (class, mode) IoU matrix is computed once and read
by the three levels (the JAX package computes it per level; the values
are the same). The matching and the AP are numpy on the host.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ... import resolve_device

DIFFICULTY = {
    0: dict(min_height=40, max_occlusion=0, max_truncation=0.15),
    1: dict(min_height=25, max_occlusion=1, max_truncation=0.30),
    2: dict(min_height=25, max_occlusion=2, max_truncation=0.50),
}
OVERLAP_TH = {"car": 0.7, "pedestrian": 0.5, "cyclist": 0.5}
LEVELS = {0: "easy", 1: "moderate", 2: "hard"}


def _rotated_iou(boxes1: np.ndarray, boxes2: np.ndarray, mode: str = "3d",
                 device=None) -> np.ndarray:
    """(N, 7) x (M, 7) LiDAR boxes -> (N, M) float32 IoU, BEV (x, y, dx,
    dy, yaw) or 3D, computed on ``device`` (default: the CUDA card)."""
    from ...ops.box_ops import boxes_iou_3d, boxes_iou_bev
    device = resolve_device(device)
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)))
    a = torch.as_tensor(np.asarray(boxes1, np.float32), device=device)
    b = torch.as_tensor(np.asarray(boxes2, np.float32), device=device)
    if mode == "bev":
        cols = [0, 1, 3, 4, 6]
        iou = boxes_iou_bev(a[:, cols].contiguous(), b[:, cols].contiguous())
    else:
        iou = boxes_iou_3d(a[:, :7].contiguous(), b[:, :7].contiguous())
    return iou.cpu().numpy()


def _gt_difficulty_mask(gt: dict, level: int) -> np.ndarray:
    cfg = DIFFICULTY[level]
    n = len(gt["boxes"])
    height = gt.get("bbox2d_height", np.full(n, 50.0))
    occ = gt.get("occluded", np.zeros(n))
    trunc = gt.get("truncated", np.zeros(n))
    return (height >= cfg["min_height"]) & \
        (occ <= cfg["max_occlusion"]) & (trunc <= cfg["max_truncation"])


def class_ious(dets: List[dict], gts: List[dict], cls: int, mode: str,
               device=None) -> List[tuple]:
    """Per sample (indices of the class's detections, their (K, G) IoU
    with every GT box), on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    out = []
    for det, gt in zip(dets, gts):
        dii = np.nonzero(det["labels"] == cls)[0]
        out.append((dii, _rotated_iou(det["boxes"][dii], gt["boxes"], mode,
                                      device)))
    return out


def _class_ap(dets: List[dict], gts: List[dict], cls: int, iou_th: float,
              level: int, ious: List[tuple]) -> float:
    """AP of class ``cls`` at ``level``: detections in descending score
    (ties in sample, then detection order), each matched to the free GT
    of its class with the highest IoU (the first on ties) when that IoU
    reaches ``iou_th``; a match to a GT outside the level is ignored.
    ``ious``: ``class_ious``'s for the class and the mode."""
    rows, npos, cares = [], 0, []
    for s, (det, gt) in enumerate(zip(dets, gts)):
        gmask = gt["labels"] == cls
        care = gmask & _gt_difficulty_mask(gt, level)
        npos += int(care.sum())
        cares.append((gmask, care))
        for k, i in enumerate(ious[s][0]):
            rows.append((float(det["scores"][i]), s, k))
    if npos == 0 or not rows:
        return float("nan")
    rows.sort(key=lambda r: -r[0])
    taken = set()
    tp, fp = [], []
    for _, s, k in rows:
        iou = ious[s][1]
        gmask, care = cares[s]
        cand = np.where(gmask, iou[k], -1.0)
        cand[[j for j in range(len(cand)) if (s, j) in taken]] = -1.0
        j = int(np.argmax(cand)) if cand.size else -1
        if j >= 0 and cand[j] >= iou_th:
            taken.add((s, j))
            if care[j]:
                tp.append(1)
                fp.append(0)
        else:
            tp.append(0)
            fp.append(1)
    tp, fp = np.cumsum(tp), np.cumsum(fp)
    rec = tp / npos
    prec = tp / np.maximum(tp + fp, 1)
    ap = 0.0
    for r in np.linspace(0.025, 1.0, 40):
        ap += (prec[rec >= r].max() if (rec >= r).any() else 0.0) / 40
    return float(ap)


def kitti_eval(dets: List[dict], gts: List[dict],
               class_names: Sequence[str],
               modes: Sequence[str] = ("bev", "3d"),
               device=None) -> Dict[str, float]:
    """dets: per sample dict(boxes or bboxes (K, 7) LiDAR, scores, labels[,
    mask]); gts: dict(boxes, labels[, occluded, truncated,
    bbox2d_height]). Keys ``{class}_{mode}_{level}`` for each class with
    GT and detections, and ``mAP_3d_moderate``; the IoU on ``device``
    (default: the CUDA card; raises if it is missing)."""
    device = resolve_device(device)
    dets = [dict(d, boxes=d.get("boxes", d.get("bboxes"))) for d in dets]
    dets = [{k: np.asarray(d[k])[np.asarray(d["mask"], bool)]
             if "mask" in d else np.asarray(d[k])
             for k in ("boxes", "scores", "labels")} for d in dets]
    out: Dict[str, float] = {}
    for ci, name in enumerate(class_names):
        th = OVERLAP_TH.get(name.lower(), 0.5)
        for mode in modes:
            ious = class_ious(dets, gts, ci, mode, device)
            for lvl, lname in LEVELS.items():
                ap = _class_ap(dets, gts, ci, th, lvl, ious)
                if not np.isnan(ap):
                    out[f"{name}_{mode}_{lname}"] = ap
    aps3d = [v for k, v in out.items() if "_3d_moderate" in k]
    out["mAP_3d_moderate"] = float(np.mean(aps3d)) if aps3d else 0.0
    return out
