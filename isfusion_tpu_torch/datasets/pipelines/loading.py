"""Loading transforms (counterpart of
``isfusion_tpu/datasets/pipelines/loading.py``): ``LoadPointsFromFile``,
``LoadPointsFromMultiSweeps``, ``LoadMultiViewImageFromFilesV2`` and
``LoadAnnotations3D``.

The camera views are PNG files decoded by ``image_io.read_png`` into
(H, W, 3) uint8 arrays (the JAX package keeps PIL images): the port needs
no imaging library, and every later image operation is PIL's, bit for bit
(``image_io``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ...core.points import get_points_type
from ...registry import PIPELINES
from .image_io import read_png
from .transforms_3d import sample_rng


def _read_points_bin(path: str, load_dim: int) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).reshape(-1, load_dim)
    return np.fromfile(path, dtype=np.float32).reshape(-1, load_dim)


@PIPELINES.register_module()
class LoadPointsFromFile:
    """results['pts_filename'] (a float32 ``.bin`` of ``load_dim`` columns)
    -> results['points'] (LiDAR or depth points, by ``coord_type``, of the
    ``use_dim`` columns). ``shift_height`` appends each point's height
    above ``percentile(z, 0.99)`` as a column (attribute ``height``)."""

    def __init__(self, coord_type: str = "LIDAR", load_dim: int = 5,
                 use_dim: Sequence[int] = (0, 1, 2, 3),
                 shift_height: bool = False):
        if isinstance(use_dim, int):
            use_dim = list(range(use_dim))
        self.points_cls = get_points_type(coord_type)
        self.load_dim = load_dim
        self.use_dim = list(use_dim)
        self.shift_height = bool(shift_height)

    def __call__(self, results: dict) -> dict:
        pts = _read_points_bin(results["pts_filename"],
                               self.load_dim)[:, self.use_dim]
        attribute_dims = None
        if self.shift_height:
            floor = np.percentile(pts[:, 2], 0.99)
            pts = np.concatenate([pts, (pts[:, 2] - floor)[:, None]], 1)
            attribute_dims = dict(height=pts.shape[1] - 1)
        results["points"] = self.points_cls(pts, points_dim=pts.shape[-1],
                                            attribute_dims=attribute_dims)
        return results


@PIPELINES.register_module()
class LoadPointsFromMultiSweeps:
    """Past sweeps appended to the key frame's points, each moved into
    the key frame by its sensor2lidar pose, with the time lag in column 4
    (0 for the key frame). More sweeps than ``sweeps_num``: the first ones
    in test mode, else ``sweeps_num`` drawn without replacement from the
    sample's rng."""

    def __init__(self, sweeps_num: int = 10, load_dim: int = 5,
                 use_dim: Sequence[int] = (0, 1, 2, 4),
                 pad_empty_sweeps: bool = False, remove_close: bool = True,
                 test_mode: bool = False):
        if isinstance(use_dim, int):
            use_dim = list(range(use_dim))
        self.sweeps_num = sweeps_num
        self.load_dim = load_dim
        self.use_dim = list(use_dim)
        self.pad_empty_sweeps = pad_empty_sweeps
        self.remove_close = remove_close
        self.test_mode = test_mode

    @staticmethod
    def _remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
        keep = (np.abs(points[:, 0]) >= radius) | \
            (np.abs(points[:, 1]) >= radius)
        return points[keep]

    def __call__(self, results: dict) -> dict:
        points = results["points"]
        pts = points.tensor
        if pts.shape[1] > 4:
            pts[:, 4] = 0.0
        sweep_points = [pts]
        ts = results.get("timestamp", 0) / 1e6
        sweeps = results.get("sweeps", [])
        if len(sweeps) == 0 and self.pad_empty_sweeps:
            for _ in range(self.sweeps_num):
                sweep_points.append(
                    self._remove_close(pts) if self.remove_close else pts)
        else:
            if len(sweeps) <= self.sweeps_num:
                choices = np.arange(len(sweeps))
            elif self.test_mode:
                choices = np.arange(self.sweeps_num)
            else:
                choices = sample_rng(results).choice(
                    len(sweeps), self.sweeps_num, replace=False)
            for idx in choices:
                sweep = sweeps[idx]
                raw = _read_points_bin(sweep["data_path"], self.load_dim)
                if self.remove_close:
                    raw = self._remove_close(raw)
                r = np.asarray(sweep["sensor2lidar_rotation"], np.float32)
                t = np.asarray(sweep["sensor2lidar_translation"], np.float32)
                raw[:, :3] = raw[:, :3] @ r.T + t
                raw[:, 4] = ts - sweep["timestamp"] / 1e6
                sweep_points.append(raw)
        pts = np.concatenate(sweep_points, axis=0)[:, self.use_dim]
        results["points"] = points.new_point(pts)
        return results


@PIPELINES.register_module()
class LoadMultiViewImageFromFilesV2:
    """results['img_filename'] (one PNG per camera) -> results['img'], a
    list of (H, W, 3) uint8 arrays; ``ori_shape`` is (W, H), as PIL's
    ``size``."""

    def __init__(self, to_float32: bool = False, color_type: str = "color"):
        self.to_float32 = to_float32

    def __call__(self, results: dict) -> dict:
        filenames = results["img_filename"]
        imgs = [read_png(name) for name in filenames]
        results["filename"] = filenames
        results["img"] = imgs
        results["ori_shape"] = (imgs[0].shape[1], imgs[0].shape[0])
        results["img_fields"] = ["img"]
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
