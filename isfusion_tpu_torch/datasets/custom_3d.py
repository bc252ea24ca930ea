"""Base 3D dataset (counterpart of ``isfusion_tpu/datasets/custom_3d.py``):
info-pkl loading, the pipeline, the epoch forwarded to it, train and test
preparation with a retry on an empty sample, the classes of a sample
(``get_cat_ids``, for ``CBGSDataset``).

Randomness: every sample's transforms draw from a
``numpy.random.RandomState`` seeded from (``seed``, epoch, index)
(``sample_rng``), handed to the pipeline as results['rng']; the retry's
next index is drawn from it too. So a sample's augmentation depends on
nothing but those three numbers: not on the loader's worker count or
order, nor on where a resumed run restarts. ``seed`` is set by
``build_dataloader``.
"""
from __future__ import annotations

import pickle
from typing import List, Optional

import numpy as np

from ..core.bbox.structures import get_box_type
from ..registry import DATASETS
from .pipelines import Compose


@DATASETS.register_module()
class Custom3DDataset:
    CLASSES: tuple = ()

    def __init__(self, data_root: str, ann_file: str, pipeline=None,
                 classes=None, modality=None, box_type_3d: str = "LiDAR",
                 filter_empty_gt: bool = True, test_mode: bool = False,
                 **kwargs):
        self.data_root = data_root
        self.ann_file = ann_file
        self.modality = modality or {}
        self.filter_empty_gt = filter_empty_gt
        self.test_mode = test_mode
        self.box_type_3d, self.box_mode_3d = get_box_type(box_type_3d)
        self.CLASSES = tuple(classes) if classes else type(self).CLASSES
        self.cat2id = {name: i for i, name in enumerate(self.CLASSES)}
        self.data_infos = self.load_annotations(ann_file)
        self.pipeline = Compose(pipeline) if pipeline is not None else None
        self.epoch = 0
        self.seed = 0

    def load_annotations(self, ann_file: str) -> List[dict]:
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        if isinstance(data, dict) and "infos" in data:
            self.metadata = data.get("metadata", {})
            return list(data["infos"])
        self.metadata = {}
        return list(data)

    def set_epoch(self, epoch: int) -> None:
        """Drive epoch-scheduled transforms and the per-sample seeds."""
        self.epoch = epoch
        if self.pipeline is not None:
            self.pipeline.set_epoch(epoch)

    def sample_rng(self, index: int) -> np.random.RandomState:
        return np.random.RandomState([self.seed, self.epoch, int(index)])

    def get_data_info(self, index: int) -> dict:
        raise NotImplementedError

    def get_ann_info(self, index: int) -> dict:
        raise NotImplementedError

    def get_cat_ids(self, idx: int) -> List[int]:
        """The class ids present in a sample."""
        labels = np.asarray(self.get_ann_info(idx)["gt_labels_3d"])
        return np.unique(labels[labels >= 0]).tolist()

    def pre_pipeline(self, results: dict) -> None:
        results["box_type_3d"] = self.box_type_3d
        results["box_mode_3d"] = self.box_mode_3d
        results["bbox3d_fields"] = []
        results["img_fields"] = []

    def prepare_train_data(self, index: int, rng: np.random.RandomState
                           ) -> Optional[dict]:
        input_dict = self.get_data_info(index)
        self.pre_pipeline(input_dict)
        input_dict["rng"] = rng
        example = self.pipeline(input_dict)
        if example is None:
            return None
        if self.filter_empty_gt and "gt_mask" in example and \
                not example["gt_mask"].any():
            return None
        return example

    def prepare_test_data(self, index: int, rng: np.random.RandomState):
        input_dict = self.get_data_info(index)
        self.pre_pipeline(input_dict)
        input_dict["rng"] = rng
        return self.pipeline(input_dict)

    def prepare(self, idx: int, rng: np.random.RandomState):
        """Sample ``idx`` through the pipeline, drawing from ``rng``; in
        train mode an empty sample is replaced by one drawn from ``rng``."""
        if self.test_mode:
            return self.prepare_test_data(idx, rng)
        while True:
            data = self.prepare_train_data(idx, rng)
            if data is not None:
                return data
            idx = int(rng.randint(len(self)))

    def __getitem__(self, idx: int):
        return self.prepare(idx, self.sample_rng(idx))

    def __len__(self) -> int:
        return len(self.data_infos)
