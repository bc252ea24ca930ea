"""Dataset and loader construction (counterpart of
``isfusion_tpu/datasets/builder.py``).

``build_dataloader`` loads through ``torch.utils.data.DataLoader`` with
``workers_per_gpu`` worker processes. The batches follow the JAX
package's order: per epoch ``np.random.default_rng(seed +
epoch).permutation`` (or dataset order without shuffling), then
``drop_last``, in global batches of ``samples_per_gpu * world_size``
samples. Rank ``rank`` of ``world_size`` loads rows ``[rank * spg, (rank
+ 1) * spg)`` of each global batch, so ``len(loader)`` counts global
steps, as the JAX loader of one host with ``world_size`` devices does.
``rank`` and ``world_size`` count the ranks of every node, as torchrun
numbers them, so the rank slice covers a run over several nodes too
and the JAX loader's per-host shards have no counterpart.
``collate_batch`` stacks each key into a CPU tensor (``img_metas``
stays a list). The JAX package's host plan (``plan_fn``) serves its
column engine only and is not ported.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from ..registry import DATASETS, build_from_cfg


def build_dataset(cfg):
    return build_from_cfg(dict(cfg), DATASETS)


def collate_batch(samples: list) -> dict:
    """Stack per-sample dicts of numpy arrays into (B, ...) tensors;
    'img_metas' is collected as a list. A sample given as a list of
    test-time variants (``MultiScaleFlipAug3D``) is unwrapped when it
    holds one; several raise (the merge of variants is not ported)."""
    if samples and isinstance(samples[0], list):
        if any(len(s) != 1 for s in samples):
            raise NotImplementedError(
                "multi-variant test-time augmentation: a sample's variants "
                "cannot be stacked into one batch")
        samples = [s[0] for s in samples]
    out = {}
    for k in samples[0]:
        if k == "img_metas":
            out[k] = [s[k] for s in samples]
        else:
            out[k] = torch.from_numpy(np.stack([np.asarray(s[k])
                                                for s in samples]))
    return out


class EpochBatchSampler(torch.utils.data.Sampler):
    """Rank ``rank``'s rows of each global batch of ``batch_size *
    world_size`` dataset indices, in the JAX loader's per-epoch order."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, seed: int,
                 drop_last: bool, rank: int = 0, world_size: int = 1):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} of {world_size}")
        if world_size > 1 and not drop_last:
            # a ragged global batch has no rows for some ranks: the eval
            # loader yields global batches and single_device_test pads
            raise ValueError("rank slices need drop_last")
        self.n, self.batch_size, self.shuffle = n, batch_size, shuffle
        self.seed, self.drop_last = seed, drop_last
        self.rank, self.world_size = rank, world_size
        self.epoch = 0

    def indices(self) -> np.ndarray:
        """The epoch's indices (every rank's)."""
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(
                self.n)
        g = self.batch_size * self.world_size
        if self.drop_last:
            idx = idx[:len(idx) // g * g]
        return idx

    def __iter__(self) -> Iterator[List[int]]:
        idx = self.indices().tolist()
        g = self.batch_size * self.world_size
        lo = self.rank * self.batch_size
        for i in range(0, len(idx), g):
            yield idx[i:i + g][lo:lo + self.batch_size]

    def __len__(self) -> int:
        g = self.batch_size * self.world_size
        if self.drop_last:
            return self.n // g
        return -(-self.n // g)


class DataLoader:
    """An epoch-aware loader: ``set_epoch(e)`` before iterating sets the
    order and the samples' seeds of epoch ``e``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 0, seed: int = 0, drop_last: bool = True,
                 pin_memory: bool = False, rank: int = 0,
                 world_size: int = 1):
        self.dataset = dataset
        self.dataset.seed = int(seed)
        self.batch_sampler = EpochBatchSampler(
            len(dataset), batch_size, shuffle, int(seed), drop_last, rank,
            world_size)
        # workers start per epoch, so each one forks with the epoch set
        self.loader = torch.utils.data.DataLoader(
            dataset, batch_sampler=self.batch_sampler,
            num_workers=int(num_workers), collate_fn=collate_batch,
            pin_memory=pin_memory)

    def set_epoch(self, epoch: int) -> None:
        self.batch_sampler.epoch = epoch
        self.dataset.set_epoch(epoch)

    def __iter__(self) -> Iterator[dict]:
        return iter(self.loader)

    def __len__(self) -> int:
        return len(self.batch_sampler)


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int = 0,
                     shuffle: bool = True, seed: Optional[int] = None,
                     drop_last: Optional[bool] = None,
                     pin_memory: bool = False, rank: int = 0,
                     world_size: int = 1) -> DataLoader:
    """``samples_per_gpu`` rows a rank, ``world_size`` ranks a global
    batch."""
    if drop_last is None:
        # evaluation sees every sample; training keeps full batches
        drop_last = bool(shuffle)
    return DataLoader(dataset, batch_size=samples_per_gpu, shuffle=shuffle,
                      num_workers=workers_per_gpu, seed=seed or 0,
                      drop_last=drop_last, pin_memory=pin_memory,
                      rank=rank, world_size=world_size)
