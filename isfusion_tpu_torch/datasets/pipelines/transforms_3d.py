"""Augmentation and filtering transforms of the LiDAR nuScenes path
(counterpart of ``isfusion_tpu/datasets/pipelines/transforms_3d.py``):
``GlobalRotScaleTrans``, ``RandomFlip3D``, ``PointsRangeFilter``,
``ObjectRangeFilter``, ``ObjectNameFilter``, ``PointShuffle`` and
``PointSample``.

Every random draw comes from ``results['rng']``, a
``numpy.random.RandomState`` that the dataset seeds from (seed, epoch,
sample index); a transform that draws raises without it. The JAX package
draws the same numbers from the global ``np.random`` stream (a
RandomState too), in the same order: theta, scale, translation; then the
horizontal flip, then the vertical. So one sample seeded alike on both
sides gets bit-equal outputs.
"""
from __future__ import annotations

import numpy as np

from ...registry import PIPELINES


def sample_rng(results: dict) -> np.random.RandomState:
    rng = results.get("rng")
    if rng is None:
        raise RuntimeError("a random transform draws from results['rng'] (a "
                           "numpy RandomState the dataset seeds); none given")
    return rng


@PIPELINES.register_module()
class GlobalRotScaleTrans:
    """Global rotation, scaling and translation of points and GT boxes."""

    def __init__(self, rot_range=(-0.78539816, 0.78539816),
                 scale_ratio_range=(0.95, 1.05),
                 translation_std=(0, 0, 0), shift_height: bool = False):
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        self.translation_std = np.asarray(translation_std, np.float32)

    def __call__(self, data: dict) -> dict:
        rng = sample_rng(data)
        theta = rng.uniform(*self.rot_range)
        scale = rng.uniform(*self.scale_ratio_range)
        trans = rng.normal(scale=self.translation_std, size=3).astype(
            np.float32)
        has_boxes = "gt_bboxes_3d" in data and len(data["gt_bboxes_3d"])
        if "points" in data:
            if has_boxes:
                # the box class turns the points with its own sign
                data["gt_bboxes_3d"].rotate(theta, data["points"])
            else:
                data["points"].rotate(theta)
            data["points"].translate(trans)
            data["points"].scale(scale)
        elif has_boxes:
            data["gt_bboxes_3d"].rotate(theta)
        if has_boxes:
            data["gt_bboxes_3d"].translate(trans)
            data["gt_bboxes_3d"].scale(scale)
        data["pcd_scale_factor"] = scale
        data["pcd_rotation"] = theta
        return data


@PIPELINES.register_module()
class RandomFlip3D:
    """BEV flips: horizontal (y) with ``flip_ratio_bev_horizontal``, then
    vertical (x) with ``flip_ratio_bev_vertical``; both draws are always
    taken."""

    def __init__(self, flip_ratio_bev_horizontal: float = 0.5,
                 flip_ratio_bev_vertical: float = 0.0, **kwargs):
        self.ratio_h = flip_ratio_bev_horizontal
        self.ratio_v = flip_ratio_bev_vertical

    def __call__(self, data: dict) -> dict:
        rng = sample_rng(data)
        for ratio, direction, key in (
                (self.ratio_h, "horizontal", "pcd_horizontal_flip"),
                (self.ratio_v, "vertical", "pcd_vertical_flip")):
            if rng.rand() < ratio:
                data["points"].flip(direction)
                if "gt_bboxes_3d" in data:
                    data["gt_bboxes_3d"].flip(direction)
                data[key] = True
        return data


@PIPELINES.register_module()
class PointsRangeFilter:
    """Keep the points inside point_cloud_range (open bounds)."""

    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, data: dict) -> dict:
        data["points"] = data["points"][data["points"].in_range_3d(self.pcr)]
        return data


@PIPELINES.register_module()
class ObjectRangeFilter:
    """Keep the GT boxes whose BEV centre is inside the range; yaw then
    limited to [-pi, pi)."""

    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, data: dict) -> dict:
        boxes = data["gt_bboxes_3d"]
        mask = boxes.in_range_bev(self.pcr[[0, 1, 3, 4]])
        data["gt_bboxes_3d"] = boxes[mask]
        data["gt_labels_3d"] = data["gt_labels_3d"][mask]
        data["gt_bboxes_3d"].limit_yaw(offset=0.5, period=2 * np.pi)
        return data


@PIPELINES.register_module()
class ObjectNameFilter:
    """Keep the GT boxes whose label is one of ``classes``."""

    def __init__(self, classes):
        self.labels = list(range(len(classes)))

    def __call__(self, data: dict) -> dict:
        mask = np.isin(data["gt_labels_3d"], self.labels)
        data["gt_bboxes_3d"] = data["gt_bboxes_3d"][mask]
        data["gt_labels_3d"] = data["gt_labels_3d"][mask]
        return data


@PIPELINES.register_module()
class PointShuffle:
    def __call__(self, data: dict) -> dict:
        data["points"].shuffle(sample_rng(data))
        return data


@PIPELINES.register_module(name=["PointSample", "IndoorPointSample"])
class PointSample:
    """``num_points`` points drawn at random (with replacement when the
    cloud is smaller); an empty cloud becomes zeros."""

    def __init__(self, num_points: int):
        self.num_points = int(num_points)

    def __call__(self, data: dict) -> dict:
        pts = data["points"]
        n = len(pts)
        if n == 0:
            data["points"] = pts.new_point(
                np.zeros((self.num_points, pts.tensor.shape[1]), np.float32))
            return data
        idx = sample_rng(data).choice(n, self.num_points,
                                      replace=n < self.num_points)
        data["points"] = pts[idx]
        return data
