"""Indoor detection metrics (counterpart of ``isfusion_tpu/core/
evaluation/indoor_eval.py``; reference mmdet3d ``core/evaluation/
indoor_eval.py``): per-class AP of depth-frame boxes at 3D IoU 0.25 and
0.5, 11-point interpolation. Each class's detections, in descending score
order over all samples, take the GT box of their class with the largest
IoU that no detection took before (the first among equal IoUs), a true
positive at or past the threshold.

The IoU runs through ``ops/box_ops.py:boxes_iou_3d`` on the same 7
columns the JAX package passes (x, y, z, dx, dy, dz, yaw; K10 on the
card, its plain version on the CPU), once a (class, sample) and read by
both thresholds (the JAX package computes it per threshold; the values
are the same). The matching and the AP are numpy on the host.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ... import resolve_device


def iou3d(a: np.ndarray, b: np.ndarray, device=None) -> np.ndarray:
    """(N, >= 7) x (M, >= 7) boxes -> (N, M) 3D IoU of their first 7
    columns, computed on ``device`` (default: the CUDA card)."""
    from ...ops.box_ops import boxes_iou_3d
    device = resolve_device(device)
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ta = torch.as_tensor(np.ascontiguousarray(a[:, :7], np.float32),
                         device=device)
    tb = torch.as_tensor(np.ascontiguousarray(b[:, :7], np.float32),
                         device=device)
    return boxes_iou_3d(ta, tb).cpu().numpy()


def indoor_eval(dets: List[dict], gts: List[dict],
                class_names: Sequence[str],
                iou_thrs: Sequence[float] = (0.25, 0.5), device=None
                ) -> Dict[str, float]:
    """dets: per sample ``boxes`` (K, 7), ``scores`` (K,), ``labels``
    (K,); gts: ``boxes`` (G, 7), ``labels`` (G,) -> ``{name}_AP_{thr}``
    for each class with GT and ``mAP_{thr}``; the IoU on ``device``
    (default: the CUDA card; raises if it is missing)."""
    device = resolve_device(device)
    per_class = {}
    for ci in range(len(class_names)):
        rows, ious, npos = [], [], 0
        for s, (det, gt) in enumerate(zip(dets, gts)):
            gmask = np.asarray(gt["labels"]) == ci
            npos += int(gmask.sum())
            dii = np.nonzero(np.asarray(det["labels"]) == ci)[0]
            iou = iou3d(np.asarray(det["boxes"])[dii],
                        np.asarray(gt["boxes"]), device)
            ious.append((iou, gmask))
            rows += [(float(det["scores"][i]), s, k)
                     for k, i in enumerate(dii)]
        if npos:
            rows.sort(key=lambda r: -r[0])
            per_class[ci] = (rows, ious, npos)
    out: Dict[str, float] = {}
    for th in iou_thrs:
        aps = []
        for ci, (rows, ious, npos) in per_class.items():
            taken = set()
            tp, fp = [], []
            for _, s, k in rows:
                iou, gmask = ious[s]
                cand = np.where(gmask, iou[k], -1.0)
                for j in range(len(cand)):
                    if (s, j) in taken:
                        cand[j] = -1.0
                j = int(np.argmax(cand)) if cand.size else -1
                hit = j >= 0 and cand[j] >= th
                if hit:
                    taken.add((s, j))
                tp.append(int(hit))
                fp.append(int(not hit))
            tp, fp = np.cumsum(tp), np.cumsum(fp)
            rec = tp / npos
            prec = tp / np.maximum(tp + fp, 1)
            ap = 0.0
            for r in np.arange(0, 1.01, 0.1):
                p = prec[rec >= r].max() if (rec >= r).any() else 0.0
                ap += p / 11
            out[f"{class_names[ci]}_AP_{th:.2f}"] = float(ap)
            aps.append(ap)
        out[f"mAP_{th:.2f}"] = float(np.mean(aps)) if aps else 0.0
    return out
