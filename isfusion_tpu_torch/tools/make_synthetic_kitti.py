"""Write a synthetic KITTI object layout (and its info pkls) on disk:

  <out>/training/velodyne/NNNNNN.bin   (N, 4) float32 ray-cast clouds
                                       (``flagship._lidar_cloud``: a
                                       LiDAR 1.73 m above the ground)
                                       and reflectance in [0, 1)
  <out>/training/calib/NNNNNN.txt      P0-P3, R0_rect, Tr_velo_to_cam,
                                       Tr_imu_to_velo (the KITTI camera of
                                       ``testing.kitti_lidar2img`` at 375 x
                                       1242)
  <out>/training/label_2/NNNNNN.txt    Car / Pedestrian / Cyclist rows at
                                       the KITTI anchors' sizes (x U(0.8,
                                       1.2)) and bottom heights, 4-60 m
                                       ahead (``--x-range``),
                                       their 2D boxes from P2, then one
                                       DontCare row
  <out>/ImageSets/{train,val}.txt      the split ids
  <out>/kitti_infos_{train,val}.pkl    ``tools/kitti_converter.py``'s

No image files: the port's KITTI path reads LiDAR only.

Usage: python -m isfusion_tpu_torch.tools.make_synthetic_kitti
           --out data/kitti_syn --train 8 --val 4 [--points 20000]
           [--objects 8] [--seed 0] [--x-range 4 60]
"""
from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from ..core.bbox.structures import Box3DMode
from ..flagship import (KITTI_CLASS_SIZES, KITTI_CLASS_Z,
                        KITTI_SENSOR_HEIGHT, _lidar_cloud)
from .kitti_converter import create_kitti_info_file

NAMES = ("Pedestrian", "Cyclist", "Car")     # KITTI_CLASS_SIZES' order
IMG_HW = (375, 1242)
CLOUD_RANGE = (-40.0, -40.0, -3.0, 70.4, 40.0, 1.0)


def kitti_calib() -> dict:
    """4x4 float64 P2 (the KITTI camera of ``testing.kitti_lidar2img`` at
    375 x 1242), R0_rect (identity) and Tr_velo_to_cam."""
    from ..testing import KITTI_CX, KITTI_CY, KITTI_FOCAL, KITTI_SCALE
    s = KITTI_SCALE * IMG_HW[0] / 384.0
    p2 = np.array([[KITTI_FOCAL * s, 0, KITTI_CX * s, 0],
                   [0, KITTI_FOCAL * s, KITTI_CY * s, 0],
                   [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    tr = np.array([[0, -1, 0, 0], [0, 0, -1, -0.08], [1, 0, 0, -0.27],
                   [0, 0, 0, 1]], np.float64)
    return dict(P2=p2, R0_rect=np.eye(4), Tr_velo_to_cam=tr)


def _row(m: np.ndarray, rows: int = 3) -> str:
    return " ".join(f"{v:.12e}" for v in m[:rows].reshape(-1))


def write_calib(path: str, calib: dict) -> None:
    p = calib["P2"]
    lines = [f"P0: {_row(p)}", f"P1: {_row(p)}", f"P2: {_row(p)}",
             f"P3: {_row(p)}",
             "R0_rect: " + " ".join(f"{v:.12e}" for v in
                                     calib["R0_rect"][:3, :3].reshape(-1)),
             f"Tr_velo_to_cam: {_row(calib['Tr_velo_to_cam'])}",
             f"Tr_imu_to_velo: {_row(np.eye(4))}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _bbox2d(box: np.ndarray, proj: np.ndarray) -> List[float]:
    """The image box of a LiDAR box's 8 corners through ``proj``, clipped
    to the image."""
    x, y, z, dx, dy, dz, yaw = box[:7]
    cs, sn = np.cos(yaw), np.sin(yaw)
    corners = []
    for ix in (-0.5, 0.5):
        for iy in (-0.5, 0.5):
            for iz in (0.0, 1.0):
                lx, ly = ix * dx, iy * dy
                corners.append([x + lx * cs - ly * sn, y + lx * sn + ly * cs,
                                z + iz * dz, 1.0])
    uvw = np.asarray(corners) @ proj.T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-3)
    h, w = IMG_HW
    return [float(np.clip(uv[:, 0].min(), 0, w - 1)),
            float(np.clip(uv[:, 1].min(), 0, h - 1)),
            float(np.clip(uv[:, 0].max(), 0, w - 1)),
            float(np.clip(uv[:, 1].max(), 0, h - 1))]


def make_sample(rng: np.random.Generator, base: str, idx: int,
                points: int, objects: int, calib: dict,
                x_range=(4.0, 60.0)) -> None:
    name = f"{idx:06d}"
    pts = np.empty((points, 4), np.float32)
    pts[:, :3] = _lidar_cloud(rng, points, CLOUD_RANGE, sweeps=1,
                              sensor_height=KITTI_SENSOR_HEIGHT)
    pts[:, 3] = rng.uniform(0, 1, points)
    pts.tofile(os.path.join(base, "velodyne", f"{name}.bin"))
    write_calib(os.path.join(base, "calib", f"{name}.txt"), calib)
    rt = calib["R0_rect"] @ calib["Tr_velo_to_cam"]
    proj = calib["P2"] @ rt
    lines = []
    for _ in range(objects):
        c = int(rng.integers(0, 3))
        x = rng.uniform(*x_range)
        y = rng.uniform(-0.4, 0.4) * x
        size = np.asarray(KITTI_CLASS_SIZES[c]) * rng.uniform(0.8, 1.2)
        yaw = rng.uniform(-np.pi, np.pi)
        # bottom centre at the class anchor's height
        box = np.array([x, y, KITTI_CLASS_Z[c], *size, yaw])
        cam = Box3DMode.convert(box[None], Box3DMode.LIDAR, Box3DMode.CAM,
                                rt_mat=rt)[0]
        l, h, w = cam[3:6]
        lines.append(
            f"{NAMES[c]} {rng.uniform(0, 0.3):.2f} {int(rng.integers(0, 3))}"
            f" {-10.0:.2f} " + " ".join(f"{v:.2f}" for v in
                                         _bbox2d(box, proj)) +
            f" {h:.2f} {w:.2f} {l:.2f} {cam[0]:.2f} {cam[1]:.2f}"
            f" {cam[2]:.2f} {cam[6]:.2f}")
    lines.append("DontCare -1 -1 -10 500.00 170.00 560.00 190.00 -1 -1 -1 "
                 "-1000 -1000 -1000 -10")
    with open(os.path.join(base, "label_2", f"{name}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def make_dataset(out: str, train: int = 8, val: int = 4,
                 points: int = 20000, objects: int = 8,
                 seed: int = 0, x_range=(4.0, 60.0)) -> List[str]:
    """Write the layout and its train / val info pkls (objects ``x_range``
    metres ahead, within 0.4 of that to the side); returns their
    paths."""
    rng = np.random.default_rng(seed)
    base = os.path.join(out, "training")
    for d in ("velodyne", "calib", "label_2"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    os.makedirs(os.path.join(out, "ImageSets"), exist_ok=True)
    calib = kitti_calib()
    for split, ids in (("train", range(train)),
                       ("val", range(train, train + val))):
        with open(os.path.join(out, "ImageSets", f"{split}.txt"), "w") as f:
            f.write("".join(f"{i:06d}\n" for i in ids))
        for i in ids:
            make_sample(rng, base, i, points, objects, calib, x_range)
    return create_kitti_info_file(out, "kitti", ("train", "val"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--train", type=int, default=8)
    ap.add_argument("--val", type=int, default=4)
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--objects", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--x-range", type=float, nargs=2, default=[4.0, 60.0])
    args = ap.parse_args(argv)
    for path in make_dataset(args.out, args.train, args.val, args.points,
                             args.objects, args.seed, tuple(args.x_range)):
        print(path)


if __name__ == "__main__":
    main()
