"""KITTI object layout -> info pkls (the port's copy of
``tools/data_converter/kitti_converter.py``, which the port may not
import): ``velodyne/``, ``label_2/``, ``calib/`` under ``training`` (or
``testing`` for the test split) and the ``ImageSets/{split}.txt`` ids
(without them, every velodyne file). Each info holds the point cloud's
index and path, the calib matrices P0-P3, R0_rect and Tr_velo_to_cam as
4x4 float32, and (but for the test split) the annos: name, truncated,
occluded, alpha, bbox, dimensions (l, h, w), location and rotation_y.
``tools/make_synthetic_kitti.py`` calls it on the layout it writes.
"""
from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np


def _read_calib(path: str) -> dict:
    rows = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            rows[key.strip()] = np.array(vals.split(), np.float64)
    calib = {}
    for k in ("P0", "P1", "P2", "P3", "Tr_velo_to_cam"):
        if k in rows:
            m = np.eye(4)
            m[:3, :4] = rows[k].reshape(3, 4)
            calib[k] = m.astype(np.float32)
    if "R0_rect" in rows:
        m = np.eye(4)
        m[:3, :3] = rows["R0_rect"].reshape(3, 3)
        calib["R0_rect"] = m.astype(np.float32)
    return calib


def _read_label(path: str) -> dict:
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = [p for p in (line.strip().split(" ") for line in f)
                    if len(p) >= 15]
    n = len(rows)

    def col(i, dt=np.float32):
        return np.asarray([float(p[i]) for p in rows], dt)

    # KITTI writes h, w, l; the annos keep (l, h, w)
    dims = [[float(p[10]), float(p[8]), float(p[9])] for p in rows]
    return dict(
        name=np.asarray([p[0] for p in rows]),
        truncated=col(1), occluded=col(2), alpha=col(3),
        bbox=np.asarray([[float(v) for v in p[4:8]] for p in rows],
                        np.float32).reshape(n, 4),
        dimensions=np.asarray(dims, np.float32).reshape(n, 3),
        location=np.asarray([[float(v) for v in p[11:14]] for p in rows],
                            np.float32).reshape(n, 3),
        rotation_y=col(14))


def create_kitti_info_file(root_path: str, info_prefix: str = "kitti",
                           splits=("train", "val"),
                           relative_path: bool = False) -> List[str]:
    """Write ``{info_prefix}_infos_{split}.pkl`` under ``root_path`` for
    each split; returns their paths."""
    written = []
    for split in splits:
        subdir = "testing" if split == "test" else "training"
        base = os.path.join(root_path, subdir)
        ids_file = os.path.join(root_path, "ImageSets", f"{split}.txt")
        if os.path.exists(ids_file):
            with open(ids_file) as f:
                ids = [s.strip() for s in f if s.strip()]
        else:
            vdir = os.path.join(base, "velodyne")
            ids = sorted(os.path.splitext(f)[0] for f in os.listdir(vdir)) \
                if os.path.isdir(vdir) else []
        infos = []
        for idx in ids:
            info = dict(
                point_cloud=dict(idx=int(idx), velodyne_path=os.path.join(
                    base, "velodyne", f"{idx}.bin")),
                calib=_read_calib(os.path.join(base, "calib", f"{idx}.txt")))
            if split != "test":
                info["annos"] = _read_label(
                    os.path.join(base, "label_2", f"{idx}.txt"))
            infos.append(info)
        path = os.path.join(root_path, f"{info_prefix}_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump(infos, f)
        written.append(path)
    return written

