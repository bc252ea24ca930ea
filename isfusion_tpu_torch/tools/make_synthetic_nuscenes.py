"""Generate a synthetic nuScenes-style dataset on disk (the port's copy of
``tools/misc/make_synthetic_nuscenes.py``, which imports the JAX package).

For the same ``--seed`` it draws the same random numbers in the same
order as that tool, so it writes the same ``.bin`` bytes and the same
infos:

  <out>/samples/LIDAR_TOP/*.bin        5-dim float32 ray-cast clouds
  <out>/sweeps/LIDAR_TOP/*.bin         preceding sweeps with ego motion
  <out>/samples/CAM_*/*.png            6 camera views (with --images)
  <out>/nuscenes_infos_{train,val}.pkl info dicts (calib, sweeps, boxes)
  <out>/gt_database/, <out>/nuscenes_dbinfos_train.pkl
                                       GT database (with --gt-database)

The camera image of each sample is drawn as there, but written only with
``--images``, as PNG through ``datasets/pipelines/image_io.py`` (the JAX
tool writes JPEG through PIL; the infos name ``.png`` files either way).
``--gt-database`` writes the copy-paste sampler's database of the train
split (``tools/create_gt_database.py``; image patches need ``--images``).

Usage: python -m isfusion_tpu_torch.tools.make_synthetic_nuscenes
           --out data/nuscenes_learn --train 48 --val 16
           --classes car pedestrian [--points 120000 --img-hw 900 1600]
           [--images] [--gt-database]
"""
from __future__ import annotations

import argparse
import os
import pickle
import shutil
from typing import Optional, Sequence

import numpy as np

from ..datasets.pipelines.image_io import write_png
from ..flagship import _lidar_cloud

CAM_NAMES = ["CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT", "CAM_BACK",
             "CAM_BACK_LEFT", "CAM_FRONT_LEFT"]
CLASSES = ["car", "truck", "construction_vehicle", "bus", "trailer",
           "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone"]
SIZES = {  # rough (l, w, h) per class
    "car": (4.6, 1.9, 1.7), "truck": (7.0, 2.5, 2.8), "bus": (11.0, 2.9, 3.4),
    "trailer": (10.0, 2.9, 3.8), "construction_vehicle": (6.0, 2.8, 3.2),
    "barrier": (2.5, 0.6, 1.0), "motorcycle": (2.0, 0.8, 1.4),
    "bicycle": (1.7, 0.6, 1.3), "pedestrian": (0.7, 0.6, 1.7),
    "traffic_cone": (0.4, 0.4, 0.8)}
ATTR_OF = {"car": "vehicle.parked", "truck": "vehicle.parked",
           "bus": "vehicle.stopped", "trailer": "vehicle.parked",
           "construction_vehicle": "vehicle.parked",
           "motorcycle": "cycle.without_rider",
           "bicycle": "cycle.without_rider",
           "pedestrian": "pedestrian.standing",
           "barrier": "", "traffic_cone": ""}


def cam_calib(v: int, w: int, h: int):
    """Camera ``v`` of a 6-camera ring: (sensor2lidar rotation,
    translation, intrinsics)."""
    th = 2 * np.pi * v / 6
    fwd = np.array([np.cos(th), np.sin(th), 0.0])
    left = np.array([-np.sin(th), np.cos(th), 0.0])
    up = np.array([0.0, 0.0, 1.0])
    # cam axes x = right, y = down, z = forward, as columns in lidar
    r = np.stack([-left, -up, fwd], axis=1)
    t = 1.5 * fwd + np.array([0.0, 0.0, 0.2])
    f = 0.6 * w
    intr = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)
    return r, t, intr


def _with_attrs(rng, xyz: np.ndarray) -> np.ndarray:
    """(N, 3) xyz -> (N, 5) float32 [xyz, intensity, 0]."""
    return np.concatenate(
        [xyz.astype(np.float32),
         rng.uniform(0, 255, (len(xyz), 1)).astype(np.float32),
         np.zeros((len(xyz), 1), np.float32)], axis=1)


def make_sample(rng: np.random.Generator, out: str, split_dir: str, idx: int,
                num_points: int, img_hw, n_sweeps: int = 3,
                classes: Optional[Sequence[str]] = None, gt_range=(8, 24),
                images: bool = False) -> dict:
    """Write one sample's clouds (and, with ``images``, its six views, all
    the same picture); return its info dict (gravity-centre boxes, origin
    (0.5, 0.5, 0.5))."""
    h, w = img_hw
    pcr = (-54, -54, -5, 54, 54, 3)
    token = f"syn{split_dir}{idx:04d}"

    feats = _with_attrs(rng, _lidar_cloud(rng, num_points, pcr, sweeps=1))
    # absolute paths: the loading transforms read the paths as they are
    lidar_path = os.path.join(out, f"samples/LIDAR_TOP/{token}.bin")
    os.makedirs(os.path.join(out, "samples/LIDAR_TOP"), exist_ok=True)

    sweeps = []
    os.makedirs(os.path.join(out, "sweeps/LIDAR_TOP"), exist_ok=True)
    for s in range(n_sweeps):
        sfeat = _with_attrs(rng, _lidar_cloud(rng, num_points // 4, pcr,
                                              sweeps=1))
        path = os.path.join(out, f"sweeps/LIDAR_TOP/{token}_s{s}.bin")
        sfeat.tofile(path)
        yaw = 0.02 * (s + 1)
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        sweeps.append(dict(
            data_path=path,
            sensor2lidar_rotation=rot,
            sensor2lidar_translation=np.array([0.9 * (s + 1), 0.0, 0.0]),
            timestamp=(idx * 10 - (s + 1) * 0.05) * 1e6))

    # the image is drawn whether or not it is written, so that every
    # later draw matches the JAX tool's
    img = (rng.uniform(0, 60, (h, w, 3)) +
           np.linspace(0, 195, h)[:, None, None]).astype(np.uint8)
    cams = {}
    for v, cam in enumerate(CAM_NAMES):
        r, t, intr = cam_calib(v, w, h)
        path = os.path.join(out, f"samples/{cam}/{token}.png")
        if images:
            os.makedirs(os.path.join(out, f"samples/{cam}"), exist_ok=True)
            if v == 0:
                write_png(path, img)
            else:
                shutil.copyfile(cams[CAM_NAMES[0]]["data_path"], path)
        cams[cam] = dict(data_path=path, type=cam, sensor2lidar_rotation=r,
                         sensor2lidar_translation=t, cam_intrinsic=intr,
                         timestamp=idx * 10 * 1e6)

    n_gt = int(rng.integers(*gt_range))
    names = rng.choice(classes if classes is not None else CLASSES, n_gt)
    attrs = np.asarray([ATTR_OF[str(n)] for n in names])
    boxes = np.zeros((n_gt, 7), np.float32)
    objs = [feats]
    for gi, n in enumerate(names):
        l, wd, ht = SIZES[str(n)]
        boxes[gi, :2] = rng.uniform(-48, 48, 2)
        boxes[gi, 2] = -1.8 + ht / 2 + rng.normal(0, 0.05)
        boxes[gi, 3:6] = np.array([l, wd, ht]) * rng.uniform(0.9, 1.1, 3)
        boxes[gi, 6] = rng.uniform(-np.pi, np.pi)
        # object points: an anisotropic blob turned by the box yaw (the
        # box-corner convention wx = lx*c + ly*s), so that yaw is
        # learnable from the cloud
        npts = int(rng.integers(20, 400))
        local = rng.normal(0, 1, (npts, 3)) * (boxes[gi, 3:6] / 4)
        c_, s_ = np.cos(boxes[gi, 6]), np.sin(boxes[gi, 6])
        obj = np.stack([local[:, 0] * c_ + local[:, 1] * s_,
                        -local[:, 0] * s_ + local[:, 1] * c_,
                        local[:, 2]], -1) + boxes[gi, :3]
        objs.append(_with_attrs(rng, obj))
    np.concatenate(objs, axis=0).tofile(lidar_path)

    return dict(
        token=token,
        lidar_path=lidar_path,
        sweeps=sweeps,
        cams=cams,
        timestamp=idx * 10 * 1e6,
        gt_boxes=boxes,
        gt_names=names.astype(str),
        # parked / standing attributes: near-zero velocities
        gt_velocity=rng.normal(0, 0.05, (n_gt, 2)).astype(np.float32),
        num_lidar_pts=np.full(n_gt, 25),
        gt_attrs=attrs,
        num_radar_pts=np.zeros(n_gt, int),
        valid_flag=np.ones(n_gt, bool),
        lidar2ego_rotation=[1.0, 0, 0, 0],
        lidar2ego_translation=[0.94, 0.0, 1.84],
        ego2global_rotation=[np.cos(idx * 0.1), 0, 0, np.sin(idx * 0.1)],
        ego2global_translation=[100.0 + 5 * idx, 40.0, 0.0],
    )


def make_dataset(out: str, train: int = 6, val: int = 2,
                 points: int = 120000, img_hw=(900, 1600), seed: int = 0,
                 classes: Optional[Sequence[str]] = None, gt_range=(8, 24),
                 images: bool = False, gt_database: bool = False) -> None:
    """Both splits into ``out`` (the JAX tool's draw order: train, then
    val, from one ``default_rng(seed)``), then, with ``gt_database``, the
    train split's GT database."""
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(seed)
    for split, n in (("train", train), ("val", val)):
        infos = [make_sample(rng, out, split, i, points, tuple(img_hw),
                             classes=classes, gt_range=tuple(gt_range),
                             images=images) for i in range(n)]
        with open(os.path.join(out, f"nuscenes_infos_{split}.pkl"),
                  "wb") as f:
            pickle.dump(dict(infos=infos,
                             metadata=dict(version="v1.0-synthetic")), f)
    if gt_database:
        from ..datasets import NuScenesDataset
        from .create_gt_database import create_groundtruth_database
        create_groundtruth_database(NuScenesDataset(
            ann_file=os.path.join(out, "nuscenes_infos_train.pkl"),
            data_root=out, classes=CLASSES, test_mode=False,
            modality=dict(use_camera=True, use_lidar=True)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--train", type=int, default=6)
    ap.add_argument("--val", type=int, default=2)
    ap.add_argument("--points", type=int, default=120000)
    ap.add_argument("--img-hw", type=int, nargs=2, default=[900, 1600])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--classes", nargs="+", default=None,
                    help="restrict the GT classes")
    ap.add_argument("--gt-range", type=int, nargs=2, default=[8, 24])
    ap.add_argument("--images", action="store_true",
                    help="write the 6 camera views of each sample (PNG)")
    ap.add_argument("--gt-database", action="store_true",
                    help="write the train split's GT database")
    args = ap.parse_args(argv)
    make_dataset(args.out, args.train, args.val, args.points, args.img_hw,
                 args.seed, args.classes, args.gt_range, args.images,
                 args.gt_database)
    print(f"train: {args.train} samples, val: {args.val} samples")


if __name__ == "__main__":
    main()
