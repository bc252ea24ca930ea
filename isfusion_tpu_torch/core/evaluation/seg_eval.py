"""Semantic segmentation metrics (counterpart of
``isfusion_tpu/core/evaluation/seg_eval.py``; reference mmdet3d
``core/evaluation/seg_eval.py``): a confusion matrix over the labelled
points, per-class IoU, mIoU, overall and mean class accuracy. Labels equal
to ``ignore_index`` are left out; a class absent from both labels and
predictions has IoU NaN, and the means skip NaN. numpy, on the host.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def fast_hist(preds: np.ndarray, labels: np.ndarray,
              num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) counts, row the label, column the
    prediction, over the labels in [0, num_classes)."""
    k = (labels >= 0) & (labels < num_classes)
    return np.bincount(
        num_classes * labels[k].astype(int) + preds[k].astype(int),
        minlength=num_classes ** 2)[:num_classes ** 2].reshape(
            num_classes, num_classes)


def per_class_iou(hist: np.ndarray) -> np.ndarray:
    denom = hist.sum(1) + hist.sum(0) - np.diag(hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / denom


def get_acc(hist: np.ndarray) -> float:
    return float(np.diag(hist).sum() / max(hist.sum(), 1))


def get_acc_cls(hist: np.ndarray) -> float:
    with np.errstate(divide="ignore", invalid="ignore"):
        per_cls = np.diag(hist) / hist.sum(1)
    return float(np.nanmean(per_cls))


def seg_eval(gt_labels: List[np.ndarray], seg_preds: List[np.ndarray],
             label2cat: Dict[int, str], ignore_index: Optional[int] = None
             ) -> dict:
    """Per-sample label and prediction arrays -> ``{cat}_iou`` for each
    class, ``miou``, ``acc``, ``acc_cls``."""
    if len(gt_labels) != len(seg_preds):
        raise ValueError("seg_eval: one prediction a label array")
    num_classes = len(label2cat)
    hist = np.zeros((num_classes, num_classes), np.int64)
    for gt, pred in zip(gt_labels, seg_preds):
        gt = np.asarray(gt).reshape(-1)
        pred = np.asarray(pred).reshape(-1)
        if ignore_index is not None:
            keep = gt != ignore_index
            gt, pred = gt[keep], pred[keep]
        hist += fast_hist(pred, gt, num_classes)
    iou = per_class_iou(hist)
    metrics = {f"{label2cat[i]}_iou": float(iou[i]) if np.isfinite(iou[i])
               else float("nan") for i in range(num_classes)}
    metrics["miou"] = float(np.nanmean(iou))
    metrics["acc"] = get_acc(hist)
    metrics["acc_cls"] = get_acc_cls(hist)
    return metrics
