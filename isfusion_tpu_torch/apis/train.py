"""Training API (counterpart of ``isfusion_tpu/apis/train.py``): the epoch
loop, on one card or data-parallel.

``train_model(model, dataset, cfg, work_dir, resume_from, device)``
trains an already built and initialised detector. The JAX trainer
initialises its variables from the first batch; the port's weights exist
from construction (``models/layers.py:init_weights`` from ``cfg.seed``,
as ``apis/inference.py:init_model`` builds them), and nothing in the log
depends on that difference. Per epoch: ``loader.set_epoch(epoch)`` (the
data order and every sample's augmentation seed), the steps of
``parallel/train_step.py:make_train_step`` with the config's AdamW,
schedules (``total_steps`` = epochs x ``len(loader)``) and grad clip,
drawing from a ``torch.Generator(device)`` seeded from ``cfg.seed + 1``;
a checkpoint every ``checkpoint_config.interval`` epochs and the
evaluation every ``evaluation.interval`` epochs. A failed evaluation fails
the run (the JAX hook logs and goes on).

In a process group (``parallel/mesh.py:init_distributed``; every rank
builds the model from the same seed) it trains on the group's ranks:
rank ``r`` loads its rows of each global batch of ``samples_per_gpu`` x
ranks samples, the step averages the gradients
(``parallel/train_step.py``) and ``steps_per_epoch`` counts global
steps, as the JAX mesh step's loop does. Rank ``r`` draws from a generator
seeded from (``cfg.seed + 1``, r), the JAX step's ``fold_in(rng,
axis_index)``: rank 0's is the one-card run's. Rank 0 alone writes the log
and the checkpoints (which hold every rank's generator state); every rank
predicts its rows of the val split, rank 0 evaluates, then all wait for
it.

``work_dir/train_log.jsonl`` has the JAX log's records: ``epoch``,
``iter``, ``step``, ``data_time``, ``time``, ``grad_norm``, ``loss`` and
the ``loss_*`` terms at every ``log_config.interval``-th step and each
epoch's first (the only host syncs of the loop), and ``mode='val'``
records with the metrics. ``data_time`` is the wait for the batch and
its upload; ``time`` runs from there to the synced metrics.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..datasets import build_dataloader, build_dataset
from ..parallel.mesh import gather_objects, group, world
from ..parallel.train_step import make_train_step
from ..runner.checkpoint import load_checkpoint, save_checkpoint
from ..runner.optim import build_optimizer, build_schedule, grad_clip_norm
from .test import single_device_test

logger = logging.getLogger("isfusion_tpu_torch")


def set_random_seed(seed: int, deterministic: bool = False) -> None:
    """Seed numpy's and torch's global generators; ``deterministic``
    selects PyTorch's deterministic kernels (cuDNN included)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def _cfg_dict(cfg, key: str) -> dict:
    return dict(cfg.get(key, {}) or {})


def rank_seed(seed: int, rank: int) -> int:
    """The train generator's seed of rank ``rank``: ``seed + 1`` on rank 0
    (the one-card run's), else drawn from (``seed + 1``, ``rank``)."""
    if rank == 0:
        return seed + 1
    return int(np.random.SeedSequence([seed + 1, rank]).generate_state(
        1, np.uint64)[0] >> 1)


def evaluate_split(model: torch.nn.Module, cfg, split: str = "val",
                   device=None) -> Optional[dict]:
    """Predict the config's ``split`` with ``model`` and return its
    dataset's metrics. Over several ranks every rank predicts its rows of
    each global batch (``samples_per_gpu`` x ranks samples) and rank 0
    alone evaluates: the others return None."""
    data_cfg = dict(cfg.data)
    dataset = build_dataset(data_cfg[split])
    rank, size = world()
    loader = build_dataloader(
        dataset,
        samples_per_gpu=int(data_cfg.get("samples_per_gpu", 1)) * size,
        workers_per_gpu=int(data_cfg.get("workers_per_gpu", 0)),
        shuffle=False)
    results = single_device_test(model, loader, device)
    return dataset.evaluate(results, device=device) if rank == 0 else None


def train_model(model: torch.nn.Module, dataset, cfg,
                work_dir: str = "work_dir", resume_from: Optional[str] = None,
                device=None, until_epoch: Optional[int] = None
                ) -> List[dict]:
    """Train ``model`` on ``dataset`` by ``cfg`` on ``device`` (default:
    the card); resumes from a checkpoint file or directory. The schedule
    spans the config's epochs; ``until_epoch`` stops the loop after that
    many (a later call resumes). In a process group it trains on its
    ranks. Returns the log records of this call (on ranks other than 0,
    without the val records)."""
    dev = resolve_device(device)
    model.to(dev).train()
    distributed = group() is not None
    rank, size = world()
    data_cfg = _cfg_dict(cfg, "data")
    seed = int(cfg.get("seed", 0) or 0)
    loader = build_dataloader(
        dataset, samples_per_gpu=int(data_cfg.get("samples_per_gpu", 1)),
        workers_per_gpu=int(data_cfg.get("workers_per_gpu", 0)),
        shuffle=True, seed=seed, pin_memory=dev.type == "cuda",
        rank=rank, world_size=size)
    total_epochs = int(cfg.get("total_epochs")
                       or _cfg_dict(cfg, "runner").get("max_epochs", 10))
    steps_per_epoch = len(loader)
    optimizer = build_optimizer(model, dict(cfg.optimizer))
    schedule = build_schedule(
        optimizer, _cfg_dict(cfg, "lr_config") or None,
        _cfg_dict(cfg, "momentum_config") or None,
        total_steps=max(total_epochs * steps_per_epoch, 1),
        steps_per_epoch=steps_per_epoch)
    step = make_train_step(model, optimizer, schedule,
                           grad_clip_norm(_cfg_dict(cfg, "optimizer_config")))
    generator = torch.Generator(dev).manual_seed(rank_seed(seed, rank))
    start_epoch = 0
    if resume_from:
        meta = load_checkpoint(resume_from, model, optimizer, generator,
                               rank, size)
        start_epoch = int(meta["epoch"])
        step.state["count"] = int(meta["step"])
        logger.info("resumed from %s at epoch %d", resume_from, start_epoch)

    log_interval = int(_cfg_dict(cfg, "log_config").get("interval", 50))
    ckpt_interval = int(_cfg_dict(cfg, "checkpoint_config").get(
        "interval", 1))
    eval_interval = int(_cfg_dict(cfg, "evaluation").get("interval", 0)
                        or 0)
    os.makedirs(work_dir, exist_ok=True)
    log_path = os.path.join(work_dir, "train_log.jsonl")
    records: List[dict] = []

    def write(rec: dict) -> None:
        records.append(rec)
        if rank == 0:
            logger.info("%s", rec)
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    for epoch in range(start_epoch, until_epoch or total_epochs):
        loader.set_epoch(epoch)
        t_data = time.perf_counter()
        for i, batch in enumerate(loader):
            batch = {k: v.to(dev, non_blocking=True) for k, v in
                     batch.items() if k != "img_metas"}
            data_time = time.perf_counter() - t_data
            metrics = step(batch, generator)
            count = step.state["count"]
            if count % log_interval == 0 or i == 0:
                vals = {k: float(v) for k, v in metrics.items()}
                write(dict(epoch=epoch, iter=i, step=count,
                           data_time=round(data_time, 4),
                           time=round(time.perf_counter() - t_data, 4),
                           **{k: round(vals[k], 5) for k in sorted(vals)}))
            t_data = time.perf_counter()
        if (epoch + 1) % ckpt_interval == 0:
            states = gather_objects(generator.get_state()) \
                if distributed else [generator.get_state()]
            if rank == 0:
                save_checkpoint(work_dir, model, optimizer, states,
                                meta=dict(epoch=epoch + 1,
                                          step=step.state["count"]))
        if eval_interval and (epoch + 1) % eval_interval == 0 and \
                "val" in data_cfg:
            metrics = evaluate_split(model, cfg, "val", dev)
            model.train()
            if rank == 0:
                write(dict(mode="val", epoch=epoch + 1,
                           **{k: (round(float(v), 5)
                                  if isinstance(v, (int, float)) else v)
                              for k, v in metrics.items()}))
            if distributed:
                dist.barrier()
    return records
