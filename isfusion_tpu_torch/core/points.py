"""LiDAR and depth point containers of the data pipeline (counterpart of
``isfusion_tpu/core/points.py``, its LiDAR and depth parts).

A numpy copy: (N, points_dim) float32 rows, xyz first, then attribute
dims (intensity, time lag). ``rotate(+phi)`` moves a point
counter-clockwise by ``phi`` around z, the sign the box class's paired
``boxes.rotate(theta, points)`` relies on (reference
``mmdet3d/core/points/base_points.py``). ``shuffle`` draws from the
generator it is given: the port has no global randomness.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np

ArrayLike = Union[np.ndarray, Sequence]


class LiDARPoints:
    def __init__(self, tensor: ArrayLike, points_dim: int = 3,
                 attribute_dims: Optional[Dict[str, int]] = None):
        tensor = np.asarray(tensor, dtype=np.float32)
        if tensor.size == 0:
            tensor = tensor.reshape(0, points_dim)
        assert tensor.ndim == 2 and tensor.shape[-1] == points_dim, \
            f"expected (N, {points_dim}), got {tensor.shape}"
        self.tensor = tensor.copy()
        self.points_dim = points_dim
        self.attribute_dims = attribute_dims

    def shuffle(self, rng) -> np.ndarray:
        """Permute the rows with ``rng.permutation`` (a RandomState or
        Generator); returns the permutation."""
        idx = rng.permutation(self.tensor.shape[0])
        self.tensor = self.tensor[idx]
        return idx

    def rotate(self, angle) -> np.ndarray:
        """Rotate by ``angle`` around z, or by a 3x3 matrix applied as
        ``xyz @ angle`` (xyz @ rot_mat_T); returns rot_mat_T."""
        angle = np.asarray(angle, dtype=np.float32)
        if angle.size == 1:
            rot_sin, rot_cos = np.sin(angle), np.cos(angle)
            rot_mat_T = np.array([[rot_cos, rot_sin, 0],
                                  [-rot_sin, rot_cos, 0],
                                  [0, 0, 1]], dtype=np.float32)
        else:
            rot_mat_T = angle
        self.tensor[:, :3] = self.tensor[:, :3] @ rot_mat_T
        return rot_mat_T

    def flip(self, bev_direction: str = "horizontal") -> None:
        if bev_direction == "horizontal":
            self.tensor[:, 1] = -self.tensor[:, 1]
        elif bev_direction == "vertical":
            self.tensor[:, 0] = -self.tensor[:, 0]

    def translate(self, trans_vector: ArrayLike) -> None:
        self.tensor[:, :3] += np.asarray(trans_vector, dtype=np.float32)

    def scale(self, scale_factor: float) -> None:
        self.tensor[:, :3] *= scale_factor

    def in_range_3d(self, point_range: Sequence[float]) -> np.ndarray:
        t = self.tensor
        return ((t[:, 0] > point_range[0]) & (t[:, 1] > point_range[1])
                & (t[:, 2] > point_range[2]) & (t[:, 0] < point_range[3])
                & (t[:, 1] < point_range[4]) & (t[:, 2] < point_range[5]))

    def __getitem__(self, item) -> "LiDARPoints":
        data = self.tensor[item][None] if isinstance(
            item, (int, np.integer)) else self.tensor[item]
        return type(self)(data, points_dim=self.points_dim,
                          attribute_dims=self.attribute_dims)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def new_point(self, data: ArrayLike) -> "LiDARPoints":
        data = np.asarray(data, dtype=np.float32)
        return type(self)(data, points_dim=data.shape[-1],
                          attribute_dims=self.attribute_dims)

    def numpy(self) -> np.ndarray:
        return self.tensor


class DepthPoints(LiDARPoints):
    """Points in depth coordinates (x right, y front, z up): a horizontal
    flip mirrors x, a vertical one y."""

    def flip(self, bev_direction: str = "horizontal") -> None:
        if bev_direction == "horizontal":
            self.tensor[:, 0] = -self.tensor[:, 0]
        elif bev_direction == "vertical":
            self.tensor[:, 1] = -self.tensor[:, 1]


def get_points_type(points_type: str):
    """'LIDAR' or 'DEPTH' -> the points class."""
    kinds = {"lidar": LiDARPoints, "depth": DepthPoints}
    if points_type.lower() not in kinds:
        raise NotImplementedError(f"the port's data pipeline has LiDAR and "
                                  f"depth points, not {points_type}")
    return kinds[points_type.lower()]
