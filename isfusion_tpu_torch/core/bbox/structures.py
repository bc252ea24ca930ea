"""LiDAR 3D box container of the data pipeline (counterpart of
``isfusion_tpu/core/bbox/structures.py``, the LiDAR parts only).

A numpy copy, so the port imports nothing of the JAX package: the same
``(x, y, z, dx, dy, dz, yaw[, vx, vy])`` rows with a bottom-centre origin
and the same rotate / flip / translate / scale conventions (reference
``mmdet3d/core/bbox/structures/lidar_box3d.py``). Camera and depth boxes
wait for the datasets that use them; ``get_box_type`` raises for them.
"""
from __future__ import annotations

from enum import IntEnum
from typing import Sequence, Tuple, Union

import numpy as np

ArrayLike = Union[np.ndarray, Sequence]


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """Limit ``val`` to ``[-offset*period, (1-offset)*period)``."""
    val = np.asarray(val)
    return val - np.floor(val / period + offset) * period


class Box3DMode(IntEnum):
    LIDAR = 0
    CAM = 1
    DEPTH = 2


class LiDARInstance3DBoxes:
    """Boxes in LiDAR coordinates (x front, y left, z up; yaw around z;
    bottom-centre origin (0.5, 0.5, 0)). ``tensor`` is a float32 (N,
    box_dim) array; ``origin`` names the origin of the rows given."""

    MODE = Box3DMode.LIDAR
    DEFAULT_ORIGIN = (0.5, 0.5, 0)

    def __init__(self, tensor: ArrayLike, box_dim: int = 7,
                 with_yaw: bool = True,
                 origin: Tuple[float, float, float] = None):
        origin = origin if origin is not None else self.DEFAULT_ORIGIN
        tensor = np.asarray(tensor, dtype=np.float32)
        if tensor.size == 0:
            tensor = tensor.reshape(0, box_dim)
        assert tensor.ndim == 2 and tensor.shape[-1] == box_dim, \
            f"expected (N, {box_dim}), got {tensor.shape}"
        tensor = tensor.copy()
        self.box_dim = box_dim
        self.with_yaw = with_yaw
        if tuple(origin) != self.DEFAULT_ORIGIN:
            dst = np.array(self.DEFAULT_ORIGIN, dtype=np.float32)
            src = np.array(origin, dtype=np.float32)
            tensor[:, :3] += tensor[:, 3:6] * (dst - src)
        self.tensor = tensor

    def translate(self, trans_vector: ArrayLike) -> None:
        self.tensor[:, :3] += np.asarray(trans_vector, dtype=np.float32)

    def scale(self, scale_factor: float) -> None:
        self.tensor[:, :6] *= scale_factor
        if self.tensor.shape[1] >= 9:
            self.tensor[:, 7:9] *= scale_factor

    def limit_yaw(self, offset: float = 0.5, period: float = np.pi) -> None:
        self.tensor[:, 6] = limit_period(self.tensor[:, 6], offset, period)

    def in_range_bev(self, box_range: Sequence[float]) -> np.ndarray:
        t = self.tensor
        return ((t[:, 0] > box_range[0]) & (t[:, 1] > box_range[1])
                & (t[:, 0] < box_range[2]) & (t[:, 1] < box_range[3]))

    def rotate(self, angle, points=None):
        """Rotate the boxes (and ``points``, a LiDARPoints) around z by a
        scalar angle: ``xyz' = xyz @ rot_mat_T``, ``yaw += angle``; the
        points turn with ``points.rotate(-angle)``, which is the same
        motion in their convention. Returns rot_mat_T, or (points,
        rot_mat_T) when points are given."""
        angle = np.asarray(angle, dtype=np.float32)
        rot_sin, rot_cos = np.sin(angle), np.cos(angle)
        rot_mat_T = np.array([[rot_cos, -rot_sin, 0],
                              [rot_sin, rot_cos, 0],
                              [0, 0, 1]], dtype=np.float32)
        self.tensor[:, :3] = self.tensor[:, :3] @ rot_mat_T
        self.tensor[:, 6] += float(angle)
        if self.tensor.shape[1] == 9:
            self.tensor[:, 7:9] = self.tensor[:, 7:9] @ rot_mat_T[:2, :2]
        if points is not None:
            points.rotate(-float(angle))
            return points, rot_mat_T
        return rot_mat_T

    def flip(self, bev_direction: str = "horizontal") -> None:
        """Mirror y (horizontal) or x (vertical), velocities included."""
        assert bev_direction in ("horizontal", "vertical")
        if bev_direction == "horizontal":
            self.tensor[:, 1::7] = -self.tensor[:, 1::7]  # y and vy
            if self.with_yaw:
                self.tensor[:, 6] = -self.tensor[:, 6] + np.pi
        else:
            self.tensor[:, 0::7] = -self.tensor[:, 0::7]  # x and vx
            if self.with_yaw:
                self.tensor[:, 6] = -self.tensor[:, 6]

    def __getitem__(self, item) -> "LiDARInstance3DBoxes":
        data = self.tensor[item][None] if isinstance(
            item, (int, np.integer)) else self.tensor[item]
        return type(self)(data, box_dim=data.shape[-1],
                          with_yaw=self.with_yaw)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def new_box(self, data: ArrayLike) -> "LiDARInstance3DBoxes":
        data = np.asarray(data, dtype=np.float32)
        return type(self)(data, box_dim=data.shape[-1],
                          with_yaw=self.with_yaw)

    def numpy(self) -> np.ndarray:
        return self.tensor


def get_box_type(box_type: str):
    """'LiDAR' -> (LiDARInstance3DBoxes, Box3DMode.LIDAR)."""
    if box_type.lower() != "lidar":
        raise NotImplementedError(f"the port's data pipeline has LiDAR boxes "
                                  f"only, not {box_type}")
    return LiDARInstance3DBoxes, Box3DMode.LIDAR
