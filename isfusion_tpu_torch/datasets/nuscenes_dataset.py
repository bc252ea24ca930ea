"""nuScenes dataset (counterpart of
``isfusion_tpu/datasets/nuscenes_dataset.py``): info-pkl loading sorted by
timestamp, ``get_data_info`` (with ``modality['use_camera']`` the six
cameras' files and their ``lidar2img``, ``camera_intrinsics`` and
``camera2lidar`` matrices) / ``get_ann_info`` / ``get_cat_ids``, LiDAR
boxes to the global frame (``_box_to_global``), the submission json
(``_format_bbox``) and the devkit-exact detection metrics over the
info-pkl ground truth (``_evaluate_internal``).

The port has no devkit branch: ``evaluate`` always runs the internal
evaluator (``core/evaluation/nuscenes_eval.py``), which implements the
``detection_cvpr_2019`` protocol itself.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..registry import DATASETS
from .custom_3d import Custom3DDataset


def quat_to_rot(q) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)]], np.float64)


def yaw_to_quat(yaw: float) -> List[float]:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def rot_to_yaw(r: np.ndarray) -> float:
    return float(np.arctan2(r[1, 0], r[0, 0]))


@DATASETS.register_module()
class NuScenesDataset(Custom3DDataset):
    CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
               'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone',
               'barrier')
    DefaultAttribute = {
        'car': 'vehicle.parked', 'pedestrian': 'pedestrian.moving',
        'trailer': 'vehicle.parked', 'truck': 'vehicle.parked',
        'bus': 'vehicle.moving', 'motorcycle': 'cycle.without_rider',
        'construction_vehicle': 'vehicle.parked',
        'bicycle': 'cycle.without_rider', 'barrier': '',
        'traffic_cone': ''}

    def __init__(self, ann_file: str, pipeline=None, data_root: str = "",
                 classes=None, load_interval: int = 1,
                 with_velocity: bool = True, modality=None,
                 box_type_3d: str = "LiDAR", filter_empty_gt: bool = True,
                 test_mode: bool = False, use_valid_flag: bool = False,
                 **kwargs):
        self.load_interval = load_interval
        self.with_velocity = with_velocity
        self.use_valid_flag = use_valid_flag
        super().__init__(data_root=data_root, ann_file=ann_file,
                         pipeline=pipeline, classes=classes,
                         modality=modality or dict(use_camera=False,
                                                   use_lidar=True),
                         box_type_3d=box_type_3d,
                         filter_empty_gt=filter_empty_gt,
                         test_mode=test_mode, **kwargs)

    def load_annotations(self, ann_file: str) -> List[dict]:
        infos = super().load_annotations(ann_file)
        infos = sorted(infos, key=lambda e: e.get("timestamp", 0))
        return infos[::self.load_interval]

    def get_cat_ids(self, idx: int) -> List[int]:
        """The class ids of a sample's GT names (valid ones with
        ``use_valid_flag``), for ``CBGSDataset``."""
        info = self.data_infos[idx]
        names = np.asarray(info["gt_names"])
        if self.use_valid_flag:
            names = names[np.asarray(info["valid_flag"], bool)]
        return sorted(self.cat2id[n] for n in set(names.tolist())
                      if n in self.cat2id)

    def get_data_info(self, index: int) -> dict:
        info = self.data_infos[index]
        input_dict = dict(
            sample_idx=index,
            token=info["token"],
            pts_filename=info["lidar_path"],
            sweeps=info.get("sweeps", []),
            timestamp=info.get("timestamp", 0),
            num_views=len(info.get("cams", {})) or 6,
        )
        if self.modality.get("use_camera") and "cams" in info:
            input_dict.update(self._camera_inputs(info["cams"]))
        if not self.test_mode:
            input_dict["ann_info"] = self.get_ann_info(index)
        return input_dict

    @staticmethod
    def _camera_inputs(cams: dict) -> dict:
        """Each camera's file and matrices, computed in float64 and kept
        as float32: lidar2img = intrinsics @ lidar2cam (4 x 4),
        camera2lidar from sensor2lidar."""
        img_paths, lidar2img, intrinsics, cam2lidar = [], [], [], []
        for cam_info in cams.values():
            img_paths.append(cam_info["data_path"])
            r = np.asarray(cam_info["sensor2lidar_rotation"], np.float64)
            t = np.asarray(cam_info["sensor2lidar_translation"], np.float64)
            lidar2cam_r = np.linalg.inv(r)
            lidar2cam_t = t @ lidar2cam_r.T
            lidar2cam = np.eye(4)
            lidar2cam[:3, :3] = lidar2cam_r.T
            lidar2cam[3, :3] = -lidar2cam_t
            intr = np.asarray(cam_info["cam_intrinsic"], np.float64)
            viewpad = np.eye(4)
            viewpad[:intr.shape[0], :intr.shape[1]] = intr
            lidar2img.append((viewpad @ lidar2cam.T).astype(np.float32))
            intrinsics.append(intr.astype(np.float32))
            c2l = np.eye(4)
            c2l[:3, :3] = r
            c2l[:3, 3] = t
            cam2lidar.append(c2l.astype(np.float32))
        return dict(img_filename=img_paths, lidar2img=np.stack(lidar2img),
                    camera_intrinsics=np.stack(intrinsics),
                    camera2lidar=np.stack(cam2lidar))

    def get_ann_info(self, index: int) -> dict:
        info = self.data_infos[index]
        if self.use_valid_flag:
            mask = np.asarray(info["valid_flag"], bool)
        else:
            mask = np.asarray(info.get(
                "num_lidar_pts", np.ones(len(info["gt_names"])))) > 0
        boxes = np.asarray(info["gt_boxes"], np.float32)[mask]
        names = np.asarray(info["gt_names"])[mask]
        labels = np.asarray(
            [self.cat2id.get(n, -1) for n in names], np.int64)
        if self.with_velocity:
            vel = np.nan_to_num(np.asarray(info["gt_velocity"],
                                           np.float32)[mask])
            boxes = np.concatenate([boxes, vel], axis=-1)
        gt_bboxes_3d = self.box_type_3d(
            boxes, box_dim=boxes.shape[-1], origin=(0.5, 0.5, 0.5))
        return dict(gt_bboxes_3d=gt_bboxes_3d, gt_labels_3d=labels,
                    gt_names=names)

    # ------------------------------------------------------------ results
    def _box_to_global(self, info: dict, box: np.ndarray):
        """LiDAR-frame (x, y, z_bottom, dx, dy, dz, yaw, vx, vy) ->
        global-frame (centre, size (w, l, h), yaw, velocity)."""
        center = box[:3].copy().astype(np.float64)
        center[2] += box[5] / 2.0
        yaw = float(box[6])
        vel = np.array([box[7], box[8], 0.0]) if box.shape[0] >= 9 else \
            np.zeros(3)
        l2e_r = quat_to_rot(info["lidar2ego_rotation"])
        l2e_t = np.asarray(info["lidar2ego_translation"], np.float64)
        e2g_r = quat_to_rot(info["ego2global_rotation"])
        e2g_t = np.asarray(info["ego2global_translation"], np.float64)
        center = e2g_r @ (l2e_r @ center + l2e_t) + e2g_t
        rot = e2g_r @ l2e_r
        # the infos store yaw = -phi - pi/2 (phi the CCW heading in lidar):
        # recover phi, compose with the ego and global rotations
        phi = -yaw - np.pi / 2
        yaw_g = rot_to_yaw(
            rot @ np.array([[np.cos(phi), -np.sin(phi), 0],
                            [np.sin(phi), np.cos(phi), 0], [0, 0, 1]]))
        vel_g = e2g_r @ (l2e_r @ vel)
        size_wlh = [float(box[3]), float(box[4]), float(box[5])]
        return center, size_wlh, yaw_g, vel_g[:2]

    def _attr(self, name: str, speed: float) -> str:
        if speed > 0.2 and name in ('car', 'construction_vehicle', 'bus',
                                    'truck', 'trailer'):
            return 'vehicle.moving'
        if speed > 0.2 and name in ('bicycle', 'motorcycle'):
            return 'cycle.with_rider'
        return self.DefaultAttribute[name]

    def _format_bbox(self, results: List[dict],
                     jsonfile_prefix: Optional[str] = None) -> str:
        """results: per-sample dict(bboxes (K, 9), scores (K,), labels
        (K,), mask (K,)). Writes the nuScenes submission json; returns its
        path."""
        nusc_annos: Dict[str, list] = {}
        for idx, det in enumerate(results):
            info = self.data_infos[idx]
            annos = []
            boxes = np.asarray(det["bboxes"])
            scores = np.asarray(det["scores"])
            labels = np.asarray(det["labels"])
            mask = np.asarray(det.get("mask", np.ones(len(scores), bool)),
                              bool)
            for i in np.nonzero(mask)[0]:
                name = self.CLASSES[int(labels[i])]
                center, size, yaw, vel = self._box_to_global(info, boxes[i])
                annos.append(dict(
                    sample_token=info["token"],
                    translation=[float(v) for v in center],
                    size=size,
                    rotation=yaw_to_quat(yaw),
                    velocity=[float(v) for v in vel],
                    detection_name=name,
                    detection_score=float(scores[i]),
                    attribute_name=self._attr(
                        name, float(np.linalg.norm(vel)))))
            nusc_annos[info["token"]] = annos
        submission = dict(
            meta=dict(use_camera=False, use_lidar=True, use_radar=False,
                      use_map=False, use_external=False),
            results=nusc_annos)
        prefix = jsonfile_prefix or "results"
        os.makedirs(prefix, exist_ok=True)
        path = os.path.join(prefix, "results_nusc.json")
        with open(path, "w") as f:
            json.dump(submission, f)
        return path

    def format_results(self, results, jsonfile_prefix=None):
        return self._format_bbox(results, jsonfile_prefix), None

    # ----------------------------------------------------------- evaluate
    def evaluate(self, results: List[dict], metric: str = "bbox",
                 jsonfile_prefix: Optional[str] = None, **kwargs) -> dict:
        """nuScenes detection metrics of ``results`` (in dataset order)
        against the info-pkl ground truth (``_evaluate_internal``)."""
        return self._evaluate_internal(results)

    def _evaluate_internal(self, results: List[dict]) -> dict:
        """The devkit protocol over info-pkl GT: class-range and
        zero-point GT filtering, 5-TP-metric NDS; AAE when the infos hold
        ``gt_attrs``."""
        from ..core.evaluation.nuscenes_eval import nuscenes_style_eval

        results = [dict(r) for r in results]
        for r in results:
            boxes = np.asarray(r.get("bboxes", r.get("boxes")))
            labels = np.asarray(r["labels"])
            r["attrs"] = np.asarray(
                [self._attr(self.CLASSES[int(l)],
                            float(np.linalg.norm(boxes[i][7:9]))
                            if len(boxes[i]) >= 9 else 0.0)
                 if 0 <= int(l) < len(self.CLASSES) else ""
                 for i, l in enumerate(labels)])
        gts, egos = [], []
        for idx in range(len(results)):
            info = self.data_infos[idx]
            boxes = np.asarray(info["gt_boxes"], np.float32)
            names = np.asarray(info["gt_names"])
            labels = np.asarray(
                [self.cat2id.get(n, -1) for n in names], np.int64)
            if self.with_velocity and "gt_velocity" in info:
                vel = np.nan_to_num(
                    np.asarray(info["gt_velocity"], np.float32))
                boxes = np.concatenate([boxes, vel], axis=-1)
            num_pts = None
            if "num_lidar_pts" in info:
                num_pts = (np.asarray(info["num_lidar_pts"]) +
                           np.asarray(info.get("num_radar_pts",
                                               np.zeros(len(names)))))
            attrs = np.asarray(info["gt_attrs"]) if "gt_attrs" in info \
                else None
            gts.append(dict(boxes=boxes, labels=labels, num_pts=num_pts,
                            attrs=attrs))
            # the devkit's range filter is ego-centric: the ego origin in
            # LiDAR coordinates is -R^T t for x_ego = R x_lidar + t
            l2e_t = np.asarray(info.get("lidar2ego_translation",
                                        [0.0, 0.0, 0.0]), np.float64)
            l2e_r = quat_to_rot(info.get("lidar2ego_rotation",
                                         [1.0, 0.0, 0.0, 0.0]))
            egos.append((-(l2e_r.T @ l2e_t))[:2])
        return nuscenes_style_eval(results, gts, list(self.CLASSES),
                                   ego_translations=egos)
