"""Write a synthetic ScanNet detection layout (and its info pkls) on disk:

  <out>/points/sceneNNNN_00.bin      (N, 6) float32 points: xyz in the
                                     scan's own frame, rgb in 0-255
  <out>/scannet_infos_{train,val}.pkl  a list of infos: ``point_cloud``
                                     (``num_features`` 6, ``lidar_idx``),
                                     ``pts_path`` (relative to <out>),
                                     ``annos``: ``gt_num``, ``name``,
                                     ``gt_boxes_upright_depth`` (G, 6:
                                     gravity centre and size, axis-aligned
                                     frame), ``index``, ``class``,
                                     ``axis_align_matrix`` (4x4)

Each scene is a room of ``flagship.indoor_room`` (8 x 8 x 3 m, 8-16
boxes standing on the floor, classes over ScanNet's 18), built in the
axis-aligned frame; its points are written in a scan frame turned by a
seeded yaw and shifted, and ``axis_align_matrix`` maps them back, as
ScanNet's infos store the raw scans beside aligned boxes. Each surface
has a colour. The JAX package has no indoor converter: this tool writes
the infos itself, with the keys ``ScanNetDataset`` reads.

Usage: python -m isfusion_tpu_torch.tools.make_synthetic_scannet
           --out data/scannet_syn --train 16 --val 8 [--points 50000]
           [--seed 0]
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import List

import numpy as np

from ..datasets.indoor_datasets import ScanNetDataset
from ..flagship import indoor_room


def align_matrix(rng: np.random.Generator) -> np.ndarray:
    """A 4x4 float64 axis-alignment: a yaw in [-pi, pi) and a shift of a
    few metres (aligned = R @ scan + t)."""
    yaw = rng.uniform(-np.pi, np.pi)
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    m[:2, 3] = rng.uniform(-3, 3, 2)
    m[2, 3] = rng.uniform(-0.5, 0.5)
    return m


def make_scene(rng: np.random.Generator, out: str, name: str,
               points: int) -> dict:
    """One scene's point file and its info."""
    classes = ScanNetDataset.CLASSES
    r = indoor_room(rng, points, len(classes))
    mat = align_matrix(rng)
    scan = (r["xyz"].astype(np.float64) - mat[:3, 3]) @ mat[:3, :3]
    colour = rng.uniform(0, 255, (5 + len(r["labels"]), 3))
    rgb = np.clip(colour[r["part"]] + rng.normal(0, 8, (points, 3)), 0, 255)
    rel = os.path.join("points", f"{name}.bin")
    np.concatenate([scan, rgb], 1).astype(np.float32).tofile(
        os.path.join(out, rel))
    boxes = r["boxes"][:, :6].copy()
    boxes[:, 2] += boxes[:, 5] / 2              # gravity centres
    names = np.array([classes[i] for i in r["labels"]])
    return dict(point_cloud=dict(num_features=6, lidar_idx=name),
                pts_path=rel,
                annos=dict(gt_num=len(boxes), name=names,
                           gt_boxes_upright_depth=boxes.astype(np.float32),
                           index=np.arange(len(boxes), dtype=np.int32),
                           **{"class": r["labels"].astype(np.int64)},
                           axis_align_matrix=mat))


def make_dataset(out: str, train: int = 16, val: int = 8,
                 points: int = 50000, seed: int = 0) -> List[str]:
    """Write the layout and its train / val info pkls; returns their
    paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out, "points"), exist_ok=True)
    paths, i = [], 0
    for split, n in (("train", train), ("val", val)):
        infos = []
        for _ in range(n):
            infos.append(make_scene(rng, out, f"scene{i:04d}_00", points))
            i += 1
        path = os.path.join(out, f"scannet_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump(infos, f)
        paths.append(path)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--train", type=int, default=16)
    ap.add_argument("--val", type=int, default=8)
    ap.add_argument("--points", type=int, default=50000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for path in make_dataset(args.out, args.train, args.val, args.points,
                             args.seed):
        print(path)


if __name__ == "__main__":
    main()
