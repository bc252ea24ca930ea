"""KITTI dataset, LiDAR modality (counterpart of
``isfusion_tpu/datasets/kitti_dataset.py``; reference
``mmdet3d/datasets/kitti_dataset.py``): the info pkls of
``tools/kitti_converter.py`` (annos: name, truncated, occluded, bbox,
dimensions, location, rotation_y; calib: P2, R0_rect, Tr_velo_to_cam).

``get_data_info`` gives the velodyne file and ``lidar2img`` = P2 @
R0_rect @ Tr_velo_to_cam as (1, 4, 4) float32; ``get_ann_info`` drops the
``DontCare`` rows, turns the camera-frame boxes into LiDAR boxes through
inv(R0_rect @ Tr_velo_to_cam) and carries each kept row's occlusion,
truncation and 2D box; ``evaluate`` runs ``core/evaluation/kitti_eval.py``
with the 2D boxes' heights, its IoU on ``device`` (default: the card).

The JAX package takes the first n occlusion and truncation entries for
the n kept rows; the port takes the kept rows' own. They agree when the
``DontCare`` rows come last, as KITTI's label files write them.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .. import resolve_device
from ..core.bbox.structures import Box3DMode, CameraInstance3DBoxes
from ..registry import DATASETS
from .custom_3d import Custom3DDataset


@DATASETS.register_module()
class KittiDataset(Custom3DDataset):
    CLASSES = ("car", "pedestrian", "cyclist")

    def __init__(self, ann_file: str, pipeline=None, data_root: str = "",
                 classes=None, modality=None, box_type_3d: str = "LiDAR",
                 filter_empty_gt: bool = True, test_mode: bool = False,
                 pts_prefix: str = "velodyne", **kwargs):
        self.pts_prefix = pts_prefix
        super().__init__(data_root=data_root, ann_file=ann_file,
                         pipeline=pipeline, classes=classes,
                         modality=modality or dict(use_lidar=True,
                                                   use_camera=False),
                         box_type_3d=box_type_3d,
                         filter_empty_gt=filter_empty_gt,
                         test_mode=test_mode, **kwargs)

    def get_data_info(self, index: int) -> dict:
        info = self.data_infos[index]
        calib = info.get("calib", {})
        pc = info.get("point_cloud", {})
        out = dict(sample_idx=pc.get("idx", index),
                   token=str(pc.get("idx", index)),
                   pts_filename=pc.get("velodyne_path",
                                       info.get("pts_filename", "")),
                   timestamp=index)
        if calib:
            rect, trv2c, p2 = (np.asarray(calib.get(k, np.eye(4)),
                                          np.float64)
                               for k in ("R0_rect", "Tr_velo_to_cam", "P2"))
            out["lidar2img"] = (p2 @ rect @ trv2c).astype(np.float32)[None]
        if not self.test_mode:
            out["ann_info"] = self.get_ann_info(index)
        return out

    def get_ann_info(self, index: int) -> dict:
        info = self.data_infos[index]
        annos = info["annos"]
        names = np.asarray(annos["name"])
        keep = names != "DontCare"
        n = len(names)
        cam = np.concatenate(
            [np.asarray(annos["location"], np.float32)[keep],
             np.asarray(annos["dimensions"], np.float32)[keep],     # l h w
             np.asarray(annos["rotation_y"], np.float32)[keep][:, None]],
            axis=1).astype(np.float32)
        calib = info.get("calib", {})
        rect = np.asarray(calib.get("R0_rect", np.eye(4)), np.float32)
        trv2c = np.asarray(calib.get("Tr_velo_to_cam", np.eye(4)),
                           np.float32)
        lidar = CameraInstance3DBoxes(cam).convert_to(
            Box3DMode.LIDAR, rt_mat=np.linalg.inv(rect @ trv2c))
        names = names[keep]
        labels = np.asarray([self.cat2id.get(str(s).lower(), -1)
                             for s in names], np.int64)
        return dict(
            gt_bboxes_3d=lidar, gt_labels_3d=labels, gt_names=names,
            bboxes=np.asarray(annos.get("bbox", np.zeros((n, 4))),
                              np.float32)[keep],
            occluded=np.asarray(annos.get("occluded", np.zeros(n)))[keep],
            truncated=np.asarray(annos.get("truncated", np.zeros(n)))[keep])

    def evaluate(self, results: List[dict], metric: str = "bbox",
                 device=None, **kwargs) -> dict:
        """KITTI BEV and 3D AP of ``results`` (dataset order) against the
        info-pkl GT, the IoU on ``device``."""
        from ..core.evaluation.kitti_eval import kitti_eval
        gts = []
        for i in range(len(results)):
            ann = self.get_ann_info(i)
            b2d = ann["bboxes"]
            gts.append(dict(
                boxes=ann["gt_bboxes_3d"].numpy(),
                labels=ann["gt_labels_3d"],
                occluded=np.asarray(ann["occluded"], np.float32),
                truncated=np.asarray(ann["truncated"], np.float32),
                bbox2d_height=(b2d[:, 3] - b2d[:, 1]) if len(b2d) else
                np.zeros(0)))
        return kitti_eval(results, gts, list(self.CLASSES),
                          device=resolve_device(device))
