"""The GT database of the copy-paste sampler (the port's copy of
``tools/data_converter/create_gt_database.py``, which imports the JAX
package): each GT box's points, stored relative to the box, and, where
the box centre is in front of a camera, a square 2D box around its
projection and that image patch as PNG, with a dbinfos pkl that
``MMDataBaseSamplerV2`` reads.

    <root>/gt_database/{idx}_{name}_{gi}.npy   (P, 5) object points
    <root>/gt_database/{idx}_{name}_{gi}.png   image patch
    <root>/nuscenes_dbinfos_train.pkl          {class: [info, ...]}

The projection is ``ops/projection.py`` on the CPU; images are read and
written by ``datasets/pipelines/image_io.py``.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..core.bbox.box_np_ops import points_in_rbbox
from ..datasets.pipelines import image_io
from ..ops.projection import project_points_to_cameras


def create_groundtruth_database(dataset, out_dir: Optional[str] = None
                                ) -> str:
    """``dataset``: a NuScenesDataset in train mode (with camera inputs
    for the patches); the database goes under ``out_dir`` (default: its
    data root). Returns the dbinfos pkl's path."""
    root = out_dir or dataset.data_root
    db_dir = os.path.join(root, "gt_database")
    os.makedirs(db_dir, exist_ok=True)
    db_infos: dict = {}
    for idx in range(len(dataset)):
        input_dict = dataset.get_data_info(idx)
        ann = input_dict["ann_info"]
        pts = np.fromfile(input_dict["pts_filename"], np.float32).reshape(
            -1, 5)
        boxes = ann["gt_bboxes_3d"].numpy()
        names = ann["gt_names"]
        if len(boxes) == 0:
            continue
        inside = points_in_rbbox(pts, boxes)
        uv = depth = None
        if "lidar2img" in input_dict:
            uv, depth, front = (v.numpy() for v in project_points_to_cameras(
                torch.from_numpy(boxes[:, :3].copy()),
                torch.from_numpy(input_dict["lidar2img"])))
        cam_imgs = {}
        for gi in range(len(boxes)):
            obj_pts = pts[inside[:, gi]].copy()
            obj_pts[:, :3] -= boxes[gi, :3]
            name = str(names[gi])
            fname = f"{idx}_{name}_{gi}.npy"
            np.save(os.path.join(db_dir, fname), obj_pts)
            info = dict(
                name=name,
                path=os.path.join("gt_database", fname),
                gt_idx=gi,
                box3d_lidar=boxes[gi].astype(np.float32),
                num_points_in_gt=int(inside[:, gi].sum()),
                difficulty=0)
            if uv is not None:
                vis = front[:, gi] & (depth[:, gi] > 0)
                if vis.any():
                    cam = int(np.argmax(vis))
                    info["cam_idx"] = cam
                    u, v = uv[cam, gi]
                    half = 40.0 / max(depth[cam, gi], 1.0) * 20
                    info["bbox"] = [float(u - half), float(v - half),
                                    float(u + half), float(v + half)]
                    path = input_dict["img_filename"][cam]
                    if cam not in cam_imgs and os.path.exists(path):
                        cam_imgs[cam] = image_io.read_png(path)
                    if cam in cam_imgs:
                        im = cam_imgs[cam]
                        x1 = int(max(info["bbox"][0], 0))
                        y1 = int(max(info["bbox"][1], 0))
                        x2 = int(min(info["bbox"][2], im.shape[1]))
                        y2 = int(min(info["bbox"][3], im.shape[0]))
                        if x2 > x1 and y2 > y1:
                            pf = fname.replace(".npy", ".png")
                            image_io.write_png(os.path.join(db_dir, pf),
                                               im[y1:y2, x1:x2])
                            info["image_path"] = os.path.join(
                                "gt_database", pf)
            db_infos.setdefault(name, []).append(info)
    save = os.path.join(root, "nuscenes_dbinfos_train.pkl")
    with open(save, "wb") as f:
        pickle.dump(db_infos, f)
    return save
