"""LiDAR and camera 3D box containers of the data pipeline (counterpart
of ``isfusion_tpu/core/bbox/structures.py``, its LiDAR and camera parts).

A numpy copy, so the port imports nothing of the JAX package: the same
``(x, y, z, dx, dy, dz, yaw[, vx, vy])`` rows with a bottom-centre origin
and the same rotate / flip / translate / scale conventions (reference
``mmdet3d/core/bbox/structures/lidar_box3d.py``, ``cam_box3d.py``), and
``Box3DMode.convert`` between the two frames (``box_3d_mode.py``). Depth
boxes wait for the datasets that use them; ``get_box_type`` raises for
them.
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

    @staticmethod
    def convert(box, src: "Box3DMode", dst: "Box3DMode", rt_mat=None):
        """LiDAR <-> camera rows or box containers (reference
        ``box_3d_mode.py``): centres through ``rt_mat`` (3x3, or 4x4 with
        a translation; the axis swap by default), sizes permuted, the
        yaw and velocity columns carried as they are."""
        if src == dst:
            return box
        is_box = isinstance(box, _Boxes)
        arr = box.tensor.copy() if is_box else \
            np.asarray(box, dtype=np.float32).copy()
        single = arr.ndim == 1
        if single:
            arr = arr[None]
        sx, sy, sz = arr[..., 3:4], arr[..., 4:5], arr[..., 5:6]
        if (src, dst) == (Box3DMode.LIDAR, Box3DMode.CAM):
            default = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
            size = np.concatenate([sy, sz, sx], -1)
        elif (src, dst) == (Box3DMode.CAM, Box3DMode.LIDAR):
            default = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
            size = np.concatenate([sz, sx, sy], -1)
        else:
            raise NotImplementedError(f"{src!r} -> {dst!r}")
        rt = np.asarray(default if rt_mat is None else rt_mat, np.float32)
        if rt.shape[1] == 4:
            xyz = np.concatenate([arr[..., :3], np.ones_like(arr[..., :1])],
                                 -1) @ rt.T
        else:
            xyz = arr[..., :3] @ rt.T
        out = np.concatenate([xyz[..., :3], size, arr[..., 6:]], -1)
        if not is_box:
            return out[0] if single else out
        cls = LiDARInstance3DBoxes if dst == Box3DMode.LIDAR \
            else CameraInstance3DBoxes
        return cls(out, box_dim=out.shape[-1], with_yaw=box.with_yaw)


class _Boxes:
    """Rows ``(x, y, z, dx, dy, dz, yaw, ...)`` stored with the subclass's
    ``DEFAULT_ORIGIN``. ``tensor`` is a float32 (N, box_dim) array;
    ``origin`` names the origin of the rows given."""

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

    @property
    def dims(self) -> np.ndarray:
        return self.tensor[:, 3:6]

    @property
    def yaw(self) -> np.ndarray:
        return self.tensor[:, 6]

    def __getitem__(self, item):
        data = self.tensor[item][None] if isinstance(
            item, (int, np.integer)) else self.tensor[item]
        return type(self)(data, box_dim=data.shape[-1],
                          with_yaw=self.with_yaw)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def new_box(self, data: ArrayLike):
        data = np.asarray(data, dtype=np.float32)
        return type(self)(data, box_dim=data.shape[-1],
                          with_yaw=self.with_yaw)

    def convert_to(self, dst: Box3DMode, rt_mat=None):
        return Box3DMode.convert(self, self.MODE, dst, rt_mat)

    def numpy(self) -> np.ndarray:
        return self.tensor


class LiDARInstance3DBoxes(_Boxes):
    """Boxes in LiDAR coordinates (x front, y left, z up; yaw around z;
    bottom-centre origin (0.5, 0.5, 0))."""

    MODE = Box3DMode.LIDAR
    DEFAULT_ORIGIN = (0.5, 0.5, 0)

    @property
    def gravity_center(self) -> np.ndarray:
        out = self.tensor[:, :3].copy()
        out[:, 2] += self.tensor[:, 5] * 0.5
        return out

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


class CameraInstance3DBoxes(_Boxes):
    """Boxes in camera coordinates (x right, y down, z front; yaw around
    y; origin (0.5, 1.0, 0.5): the stored y is the bottom face's)."""

    MODE = Box3DMode.CAM
    DEFAULT_ORIGIN = (0.5, 1.0, 0.5)

    @property
    def height(self) -> np.ndarray:
        return self.tensor[:, 4]

    @property
    def bottom_height(self) -> np.ndarray:
        return self.tensor[:, 1]

    @property
    def top_height(self) -> np.ndarray:
        return self.bottom_height - self.height     # y points down

    @property
    def gravity_center(self) -> np.ndarray:
        out = self.tensor[:, :3].copy()
        out[:, 1] -= self.tensor[:, 4] * 0.5
        return out

    @property
    def bev(self) -> np.ndarray:
        """(N, 5) (x, z, dx, dz, yaw) on the camera's ground plane."""
        return self.tensor[:, [0, 2, 3, 5, 6]]

    def in_range_bev(self, box_range: Sequence[float]) -> np.ndarray:
        t = self.tensor
        return ((t[:, 0] > box_range[0]) & (t[:, 2] > box_range[1])
                & (t[:, 0] < box_range[2]) & (t[:, 2] < box_range[3]))

    def rotate(self, angle) -> np.ndarray:
        """Rotate around y by a scalar angle: ``xyz' = xyz @ rot_mat_T``,
        ``yaw += angle``. Returns rot_mat_T."""
        angle = np.asarray(angle, dtype=np.float32)
        rot_sin, rot_cos = np.sin(angle), np.cos(angle)
        rot_mat_T = np.array([[rot_cos, 0, -rot_sin], [0, 1, 0],
                              [rot_sin, 0, rot_cos]], dtype=np.float32)
        self.tensor[:, :3] = self.tensor[:, :3] @ rot_mat_T
        self.tensor[:, 6] += float(angle)
        return rot_mat_T

    def flip(self, bev_direction: str = "horizontal") -> None:
        """Mirror x (horizontal) or z (vertical), velocities included."""
        assert bev_direction in ("horizontal", "vertical")
        if bev_direction == "horizontal":
            self.tensor[:, 0::7] = -self.tensor[:, 0::7]
            if self.with_yaw:
                self.tensor[:, 6] = -self.tensor[:, 6] + np.pi
        else:
            self.tensor[:, 2::7] = -self.tensor[:, 2::7]
            if self.with_yaw:
                self.tensor[:, 6] = -self.tensor[:, 6]


def get_box_type(box_type: str):
    """'LiDAR' or 'Camera' -> (box class, Box3DMode)."""
    kind = box_type.lower()
    if kind == "lidar":
        return LiDARInstance3DBoxes, Box3DMode.LIDAR
    if kind == "camera":
        return CameraInstance3DBoxes, Box3DMode.CAM
    raise NotImplementedError(f"the port's data pipeline has LiDAR and "
                              f"camera boxes, not {box_type}")
