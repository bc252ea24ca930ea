"""Formatting (counterpart of ``isfusion_tpu/datasets/pipelines/
formating.py``): every array is padded to a fixed capacity with a validity
mask, the batch contract of the port's detectors; ``Collect3DV2`` (alias
``Collect3D``) keeps the device keys and the camera matrices and puts host
metadata under 'img_metas'."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ...registry import PIPELINES


def pad_to(arr: np.ndarray, n: int, fill=0.0):
    """Pad or cut the leading dim to ``n``; returns (padded, mask).

    Overflow takes a uniform stride subsample (rows ``i * m // n``), not a
    prefix: clouds are often written in structured order (ground first,
    objects last), and a prefix cut deletes whole objects (mAP 0.0 on the
    synthetic val split in the JAX package's history). Aligned arrays stay
    aligned: the selection depends only on (m, n)."""
    m = arr.shape[0]
    mask = np.zeros((n,), bool)
    out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
    k = min(m, n)
    if m > n:
        out[:k] = arr[(np.arange(k, dtype=np.int64) * m) // k]
    else:
        out[:k] = arr[:k]
    mask[:k] = True
    return out, mask


@PIPELINES.register_module()
class DefaultFormatBundle3D:
    """Points -> (max_points, C) + points_mask; camera views -> (Nv, H, W,
    3) float32; GT boxes (padded to 9 columns) -> (max_gt, 9) + gt_mask,
    labels -> (max_gt,) int32."""

    def __init__(self, class_names=None, max_points: int = 250000,
                 max_gt: int = 128, with_label: bool = True):
        self.class_names = class_names
        self.max_points = int(max_points)
        self.max_gt = int(max_gt)
        self.with_label = with_label

    def __call__(self, results: dict) -> dict:
        if "points" in results:
            pts = results["points"].numpy().astype(np.float32)
            results["points"], results["points_mask"] = pad_to(
                pts, self.max_points)
        if "img" in results:
            results["img"] = np.stack([np.asarray(i, np.float32)
                                       for i in results["img"]])
        if self.with_label and "gt_bboxes_3d" in results:
            arr = results["gt_bboxes_3d"].numpy().astype(np.float32)
            if arr.shape[-1] < 9:
                arr = np.concatenate(
                    [arr, np.zeros((arr.shape[0], 9 - arr.shape[-1]),
                                   np.float32)], -1)
            results["gt_bboxes_3d"], results["gt_mask"] = pad_to(
                arr, self.max_gt)
            results["gt_labels_3d"], _ = pad_to(
                np.asarray(results["gt_labels_3d"], np.int32), self.max_gt)
        return results


@PIPELINES.register_module()
class Collect3DV2:
    """The ``keys`` as arrays, with the masks and camera matrices the
    detector reads whenever the pipeline made them (``points_mask``,
    ``gt_mask``, ``img_aug_matrix``, ``lidar_aug_matrix``,
    ``img_view_mask``, ``lidar2img``); host metadata under 'img_metas'."""

    EXTRA_KEYS = ("points_mask", "gt_mask", "img_aug_matrix",
                  "lidar_aug_matrix", "img_view_mask", "lidar2img")

    def __init__(self, keys: Sequence[str],
                 meta_keys: Optional[Sequence[str]] = None):
        self.keys = list(keys)
        self.meta_keys = list(meta_keys or (
            "sample_idx", "token", "pts_filename", "filename", "ori_shape",
            "box_type_3d", "timestamp"))

    def __call__(self, results: dict) -> dict:
        out = {k: np.asarray(results[k]) for k in self.keys if k in results}
        for k in self.EXTRA_KEYS:
            if k in results and k not in out:
                out[k] = np.asarray(results[k])
        out["img_metas"] = {k: results[k] for k in self.meta_keys
                            if k in results}
        return out


@PIPELINES.register_module()
class Collect3D(Collect3DV2):
    """Alias of Collect3DV2 for configs using the older name."""
