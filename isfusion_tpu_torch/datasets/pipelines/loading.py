"""Loading transforms (counterpart of
``isfusion_tpu/datasets/pipelines/loading.py``): ``LoadPointsFromFile`` and
``LoadAnnotations3D``. Multi-view image and multi-sweep loading are not
ported yet."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ...core.points import get_points_type
from ...registry import PIPELINES


@PIPELINES.register_module()
class LoadPointsFromFile:
    """results['pts_filename'] (a float32 ``.bin`` of ``load_dim`` columns)
    -> results['points'] (LiDARPoints of the ``use_dim`` columns)."""

    def __init__(self, coord_type: str = "LIDAR", load_dim: int = 5,
                 use_dim: Sequence[int] = (0, 1, 2, 3)):
        if isinstance(use_dim, int):
            use_dim = list(range(use_dim))
        self.points_cls = get_points_type(coord_type)
        self.load_dim = load_dim
        self.use_dim = list(use_dim)

    def __call__(self, results: dict) -> dict:
        pts = np.fromfile(results["pts_filename"], dtype=np.float32)
        pts = pts.reshape(-1, self.load_dim)[:, self.use_dim]
        results["points"] = self.points_cls(pts, points_dim=pts.shape[-1])
        return results


@PIPELINES.register_module()
class LoadAnnotations3D:
    """GT boxes and labels from results['ann_info']."""

    def __init__(self, with_bbox_3d: bool = True, with_label_3d: bool = True):
        self.with_bbox_3d = with_bbox_3d
        self.with_label_3d = with_label_3d

    def __call__(self, results: dict) -> dict:
        ann = results["ann_info"]
        if self.with_bbox_3d:
            results["gt_bboxes_3d"] = ann["gt_bboxes_3d"]
            results.setdefault("bbox3d_fields", []).append("gt_bboxes_3d")
        if self.with_label_3d:
            results["gt_labels_3d"] = np.asarray(ann["gt_labels_3d"],
                                                 np.int64)
        return results
