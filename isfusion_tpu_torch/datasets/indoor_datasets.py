"""Indoor datasets: ScanNet, SUN RGB-D and S3DIS (counterpart of
``isfusion_tpu/datasets/indoor_datasets.py``; reference mmdet3d
``scannet_dataset.py``, ``sunrgbd_dataset.py``, ``s3dis_dataset.py``):
info-pkl scenes with depth-frame boxes, evaluated by ``indoor_eval``
(AP at 3D IoU 0.25 and 0.5).

``get_data_info`` gives the scene's point file (``pts_path``, joined to
``data_root`` when relative, as the reference joins it; the JAX package
takes it as it is) and the per-point mask files where the info names
them. ``get_ann_info``: ``gt_boxes_upright_depth`` (6 columns, a yaw of 0
appended, or 7) as ``DepthInstance3DBoxes`` from gravity-centre rows,
labels by class name (-1 for a name not in ``CLASSES``), ScanNet's
``axis_align_matrix`` (identity where the info has none) for
``GlobalAlignment`` (in test mode too). ``load_interval`` keeps every
n-th scene (S3DIS's
config thins its rooms so). ``evaluate(results, device=...)`` runs
``indoor_eval`` with the IoU on ``device`` (default: the card).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from .. import resolve_device
from ..registry import DATASETS
from .custom_3d import Custom3DDataset


class _IndoorDataset(Custom3DDataset):
    ALIGNED = False   # ScanNet: ann_info carries axis_align_matrix

    def __init__(self, ann_file: str, pipeline=None, data_root: str = "",
                 classes=None, box_type_3d: str = "Depth",
                 load_interval: int = 1, **kwargs):
        self.load_interval = int(load_interval)
        super().__init__(data_root=data_root, ann_file=ann_file,
                         pipeline=pipeline, classes=classes,
                         box_type_3d=box_type_3d, **kwargs)

    def load_annotations(self, ann_file: str) -> List[dict]:
        return super().load_annotations(ann_file)[::self.load_interval]

    def _path(self, p: str) -> str:
        return p if not p or os.path.isabs(p) else \
            os.path.join(self.data_root, p)

    def get_data_info(self, index: int) -> dict:
        info = self.data_infos[index]
        pc = info.get("point_cloud", {})
        out = dict(sample_idx=pc.get("idx", index),
                   token=str(pc.get("idx", index)),
                   pts_filename=self._path(info.get(
                       "pts_path", pc.get("pts_path", ""))),
                   timestamp=index)
        for key in ("pts_instance_mask_path", "pts_semantic_mask_path"):
            if key in info:
                out[key] = self._path(info[key])
        if not self.test_mode:
            out["ann_info"] = self.get_ann_info(index)
        return out

    def prepare_test_data(self, index: int, rng: np.random.RandomState):
        """As the base's, with ScanNet's ``axis_align_matrix`` under
        ``ann_info`` for ``GlobalAlignment`` (the reference's
        ``ScanNetDataset.prepare_test_data``; the JAX package's test mode
        carries no ann_info, and its test pipeline cannot align)."""
        input_dict = self.get_data_info(index)
        if self.ALIGNED:
            input_dict["ann_info"] = dict(axis_align_matrix=np.asarray(
                self.data_infos[index]["annos"].get(
                    "axis_align_matrix", np.eye(4)), np.float32))
        self.pre_pipeline(input_dict)
        input_dict["rng"] = rng
        return self.pipeline(input_dict)

    def get_ann_info(self, index: int) -> dict:
        annos = self.data_infos[index]["annos"]
        boxes = np.asarray(annos.get("gt_boxes_upright_depth",
                                     np.zeros((0, 7))), np.float32)
        if boxes.shape[-1] == 6:          # yaw-free datasets (ScanNet)
            boxes = np.concatenate(
                [boxes, np.zeros((len(boxes), 1), np.float32)], -1)
        names = np.asarray(annos.get("name", annos.get("class",
                                                       np.array([]))))
        labels = np.asarray([self.cat2id.get(str(n), -1) for n in names],
                            np.int64)
        gt = self.box_type_3d(boxes, box_dim=boxes.shape[-1],
                              origin=(0.5, 0.5, 0.5))
        ann = dict(gt_bboxes_3d=gt, gt_labels_3d=labels, gt_names=names)
        if self.ALIGNED:
            ann["axis_align_matrix"] = np.asarray(
                annos.get("axis_align_matrix", np.eye(4)), np.float32)
        return ann

    def evaluate(self, results: List[dict], metric=None, device=None,
                 **kwargs) -> dict:
        """AP of ``results`` (dataset order: ``bboxes`` or ``boxes``,
        ``scores``, ``labels``, optionally a ``mask`` of the kept rows)
        against the info-pkl GT, the IoU on ``device``."""
        from ..core.evaluation.indoor_eval import indoor_eval
        gts, dets = [], []
        for i, d in enumerate(results):
            ann = self.get_ann_info(i)
            gts.append(dict(boxes=ann["gt_bboxes_3d"].numpy(),
                            labels=ann["gt_labels_3d"]))
            keep = np.asarray(d["mask"], bool) if "mask" in d else None
            det = dict(boxes=d.get("bboxes", d.get("boxes")),
                       scores=d["scores"], labels=d["labels"])
            dets.append({k: np.asarray(v) if keep is None
                         else np.asarray(v)[keep] for k, v in det.items()})
        return indoor_eval(dets, gts, list(self.CLASSES),
                           device=resolve_device(device))


@DATASETS.register_module()
class ScanNetDataset(_IndoorDataset):
    ALIGNED = True
    CLASSES = ("cabinet", "bed", "chair", "sofa", "table", "door",
               "window", "bookshelf", "picture", "counter", "desk",
               "curtain", "refrigerator", "showercurtrain", "toilet",
               "sink", "bathtub", "garbagebin")


@DATASETS.register_module()
class SUNRGBDDataset(_IndoorDataset):
    CLASSES = ("bed", "table", "sofa", "chair", "toilet", "desk",
               "dresser", "night_stand", "bookshelf", "bathtub")


@DATASETS.register_module()
class S3DISDataset(_IndoorDataset):
    CLASSES = ("table", "chair", "sofa", "bookcase", "board")
