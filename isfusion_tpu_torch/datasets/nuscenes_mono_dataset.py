"""nuScenes monocular dataset, FCOS3D's data side (counterpart of
``isfusion_tpu/datasets/nuscenes_mono_dataset.py``; reference
``mmdet3d/datasets/nuscenes_mono_dataset.py``): one camera image a
sample, camera-frame 3D boxes with their projected 2D boxes, centres and
depths.

Info format: a list of dicts (or ``{'infos': [...]}``) with ``img_path``,
``cam_intrinsic`` (3x3 or 4x4) and ``annos`` (``bboxes``,
``bboxes_cam3d``, ``centers2d``, ``depths``, ``labels``, optional
``attr_labels`` and ``names``). ``evaluate`` scores camera-frame boxes by
``nuscenes_style_eval`` after permuting (x, y, z) to (z, x, y), as the JAX
package does. Neither package has mono transforms, so ``pipeline`` is
whatever the caller gives (None: the sample dicts themselves).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.bbox.structures import CameraInstance3DBoxes
from ..registry import DATASETS
from .custom_3d import Custom3DDataset

# camera (x right, y down, z front) -> the evaluator's (z, x, y) columns
_EVAL_COLUMNS = [2, 0, 1, 3, 4, 5, 6]


@DATASETS.register_module()
class NuScenesMonoDataset(Custom3DDataset):
    CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
               'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone',
               'barrier')

    def __init__(self, ann_file: str, pipeline=None, data_root: str = "",
                 classes=None, box_type_3d: str = "Camera", **kwargs):
        super().__init__(data_root=data_root, ann_file=ann_file,
                         pipeline=pipeline, classes=classes,
                         modality=dict(use_camera=True, use_lidar=False),
                         box_type_3d=box_type_3d, **kwargs)

    def get_data_info(self, index: int) -> dict:
        info = self.data_infos[index]
        intr = np.asarray(info["cam_intrinsic"], np.float32)
        cam2img = np.eye(4, dtype=np.float32)
        cam2img[:intr.shape[0], :intr.shape[1]] = intr
        out = dict(sample_idx=index, token=info.get("token", str(index)),
                   img_filename=[info["img_path"]], cam2img=cam2img,
                   timestamp=info.get("timestamp", index))
        if not self.test_mode:
            out["ann_info"] = self.get_ann_info(index)
        return out

    def get_ann_info(self, index: int) -> dict:
        annos = self.data_infos[index]["annos"]
        boxes = np.asarray(annos["bboxes_cam3d"], np.float32)
        return dict(
            gt_bboxes_3d=CameraInstance3DBoxes(boxes, box_dim=boxes.shape[-1]),
            gt_labels_3d=np.asarray(annos["labels"], np.int64),
            gt_names=np.asarray(annos.get("names", [])),
            bboxes=np.asarray(annos["bboxes"], np.float32),
            centers2d=np.asarray(annos["centers2d"], np.float32),
            depths=np.asarray(annos["depths"], np.float32),
            attr_labels=np.asarray(annos.get(
                "attr_labels", np.zeros(len(boxes))), np.int64))

    def evaluate(self, results: List[dict], metric="bbox", **kwargs) -> dict:
        """``results[i]``: the decode of sample i (``bboxes`` (K, >= 7)
        camera-frame, ``scores``, ``labels``, optional ``mask``), numpy or
        tensors. Returns the devkit metric dict."""
        from ..core.evaluation.nuscenes_eval import nuscenes_style_eval

        def cols(b):
            b = np.asarray(b)
            return b[:, _EVAL_COLUMNS] if b.shape[-1] >= 7 else b

        gts = []
        for i in range(len(results)):
            ann = self.get_ann_info(i)
            gts.append(dict(boxes=cols(ann["gt_bboxes_3d"].numpy()),
                            labels=ann["gt_labels_3d"]))
        dets = []
        for d in results:
            b = np.asarray(d["bboxes"])
            dets.append(dict(bboxes=cols(b), scores=np.asarray(d["scores"]),
                             labels=np.asarray(d["labels"]),
                             mask=np.asarray(d.get("mask", np.ones(
                                 len(b), bool)))))
        return nuscenes_style_eval(dets, gts, list(self.CLASSES))
