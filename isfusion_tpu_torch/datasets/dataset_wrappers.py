"""Dataset wrappers (counterpart of
``isfusion_tpu/datasets/dataset_wrappers.py``): ``CBGSDataset``,
class-balanced grouping and sampling. Each class's sample list is
resampled with replacement to about 1/num_classes of the total, so rare
classes are seen about as often as common ones.

Two draws differ from the JAX package by design. The index list is drawn
from ``RandomState(seed)`` where the JAX package uses the global
``np.random`` at construction; ``seed`` is the loader's (the config's
``seed``), and setting it draws the list again. A sample's augmentation
draws come from ``RandomState([seed, epoch, outer index])``: the JAX
wrapper forwards the inner index, so two copies of one sample in an epoch
would be augmented alike.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..registry import DATASETS, build_from_cfg


@DATASETS.register_module()
class CBGSDataset:
    def __init__(self, dataset, seed: int = 0):
        self.dataset = build_from_cfg(dict(dataset), DATASETS) \
            if isinstance(dataset, dict) else dataset
        self.CLASSES = self.dataset.CLASSES
        self.epoch = 0
        self._seed = None
        self.seed = seed

    @property
    def seed(self) -> int:
        return self._seed

    @seed.setter
    def seed(self, value: int) -> None:
        if value != self._seed:
            self._seed = int(value)
            self.sample_indices = self._get_sample_indices(
                np.random.RandomState(self._seed))

    def _get_sample_indices(self, rng: np.random.RandomState) -> List[int]:
        class_sample_idxs = {i: [] for i in range(len(self.CLASSES))}
        for idx in range(len(self.dataset)):
            for cat_id in self.dataset.get_cat_ids(idx):
                if cat_id in class_sample_idxs:
                    class_sample_idxs[cat_id].append(idx)
        duplicated = sum(len(v) for v in class_sample_idxs.values())
        if duplicated == 0:
            return list(range(len(self.dataset)))
        frac = 1.0 / len(self.CLASSES)
        sample_indices = []
        for cls_inds in class_sample_idxs.values():
            if len(cls_inds) == 0:
                continue
            ratio = frac / max(len(cls_inds) / duplicated, 1e-8)
            sample_indices += rng.choice(
                cls_inds, int(len(cls_inds) * ratio)).tolist()
        return sample_indices or list(range(len(self.dataset)))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.dataset.set_epoch(epoch)

    def sample_rng(self, idx: int) -> np.random.RandomState:
        return np.random.RandomState([self._seed, self.epoch, int(idx)])

    def get_cat_ids(self, idx: int):
        return self.dataset.get_cat_ids(self.sample_indices[idx])

    def __getitem__(self, idx: int):
        return self.dataset.prepare(self.sample_indices[idx],
                                    self.sample_rng(idx))

    def __len__(self) -> int:
        return len(self.sample_indices)
