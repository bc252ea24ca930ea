"""Optimizer and schedules from mmcv-style configs (counterpart of
``isfusion_tpu/runner/optim.py``; flagship config
``configs/isfusion/isfusion_0075voxel.py:395-402``, PointPillars
``configs/_base_/schedules/schedule_2x.py``).

- ``build_optimizer``: ``torch.optim.AdamW`` with one param group per
  ``paramwise_cfg.custom_keys`` match (the flagship's ``img_backbone`` at
  ``lr_mult`` 0.1) and one for the rest. The JAX package multiplies the
  whole AdamW update (weight decay included) by the group's multiplier,
  which is AdamW at ``lr * lr_mult``. Or ``torch.optim.SGD`` (FCOS3D:
  momentum, weight decay) with mmcv's paramwise rules: a custom key's
  ``lr_mult`` / ``decay_mult``, else ``bias_lr_mult`` and
  ``bias_decay_mult`` on the biases of every layer but the norms. Or
  ``torch.optim.Adam`` (the PointNet++ segmentation config: mmcv's Adam,
  the weight decay added to the gradient).
- ``build_schedule``: sets every group's ``lr`` and ``betas[0]`` before
  each step from a copy of the JAX cyclic policy (mmcv CyclicLrUpdater /
  CyclicMomentumUpdater: cosine from the base value to ``base *
  target_ratio[0]`` over ``step_ratio_up`` of the steps, then cosine down
  to ``base * target_ratio[1]``), the step policy with linear warmup
  (PointPillars) or CosineAnnealing with linear warmup (MVX-Net; the JAX
  package's optax cosine decay to ``base * min_lr_ratio`` after the
  warmup).
- ``grad_clip_norm``: the global-norm clip of ``optimizer_config``.

Where the two packages differ, the port follows the reference (ROADMAP
queue 3): optax's ``adamw`` still decays a parameter whose gradient is
zero (the ``img_backbone`` under ``detach=True``); torch's AdamW skips a
parameter whose ``grad`` is None. The JAX SGD is ``optax.sgd(lr,
momentum)``: it drops ``weight_decay`` and the bias multipliers, which
the port applies (with ``weight_decay=0`` and the multipliers at 1 the
two compute the same step).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch


def cyclic_schedule(base: float, target_ratio, cyclic_times: int,
                    step_ratio_up: float, total_steps: int
                    ) -> Callable[[int], float]:
    """mmcv cyclic policy as the JAX package computes it (float32 count
    arithmetic aside): value at step ``count`` (0-based)."""
    r_up, r_down = float(target_ratio[0]), float(target_ratio[1])
    period = max(total_steps // max(cyclic_times, 1), 1)
    up = max(int(period * step_ratio_up), 1)

    def cos_anneal(start, end, frac):
        return end + (start - end) * 0.5 * (math.cos(math.pi * frac) + 1)

    def sched(count: int) -> float:
        t = count % period
        if t < up:
            return cos_anneal(base, base * r_up, min(max(t / up, 0.0), 1.0))
        frac = min(max((t - up) / max(period - up, 1), 0.0), 1.0)
        return cos_anneal(base * r_up, base * r_down, frac)

    return sched


def step_schedule(base: float, steps, gamma: float = 0.1,
                  warmup: Optional[str] = None, warmup_iters: int = 0,
                  warmup_ratio: float = 1e-3, steps_per_epoch: int = 1
                  ) -> Callable[[int], float]:
    """mmcv step policy as the JAX package composes it with optax: the lr
    is multiplied by ``gamma`` at each of ``steps`` (epochs, times
    ``steps_per_epoch``), counted after a linear warmup from ``base *
    warmup_ratio`` to ``base`` over ``warmup_iters`` steps."""
    milestones = [int(e) * int(steps_per_epoch) for e in steps]
    warm = warmup == "linear" and warmup_iters > 0
    init = base * float(warmup_ratio)

    def sched(count: int) -> float:
        if warm:
            if count < warmup_iters:
                frac = 1 - min(max(count, 0), warmup_iters) / warmup_iters
                return (init - base) * frac + base
            count -= warmup_iters
        value = base
        for m in milestones:
            if count >= m:
                value *= gamma
        return value

    return sched


def cosine_schedule(base: float, total_steps: int,
                    min_lr_ratio: float = 1e-3, warmup: Optional[str] = None,
                    warmup_iters: int = 0, warmup_ratio: float = 1e-3
                    ) -> Callable[[int], float]:
    """mmcv CosineAnnealing as the JAX package composes it with optax: a
    linear warmup from ``base * warmup_ratio`` to ``base`` over
    ``warmup_iters`` steps, then ``optax.cosine_decay_schedule(base,
    total_steps - warmup_iters, alpha=min_lr_ratio)`` counted from the
    warmup's end."""
    warm = warmup == "linear" and warmup_iters > 0
    decay = max(total_steps - (warmup_iters if warm else 0), 1)
    init = base * float(warmup_ratio)

    def sched(count: int) -> float:
        if warm:
            if count < warmup_iters:
                frac = 1 - min(max(count, 0), warmup_iters) / warmup_iters
                return (init - base) * frac + base
            count -= warmup_iters
        t = min(max(count, 0), decay)
        cos = 0.5 * (1 + math.cos(math.pi * t / decay))
        return base * ((1 - min_lr_ratio) * cos + min_lr_ratio)

    return sched


_NORMS = (torch.nn.modules.batchnorm._BatchNorm, torch.nn.GroupNorm,
          torch.nn.LayerNorm)


def _paramwise_mults(model: torch.nn.Module, paramwise: dict):
    """(name, parameter, lr_mult, decay_mult) of every parameter: a
    ``custom_keys`` match (the last key its name contains, as the JAX
    package's ``_lr_mult_mask``) sets both; otherwise a bias of a layer
    other than a norm takes ``bias_lr_mult`` and ``bias_decay_mult``
    (mmcv's DefaultOptimizerConstructor, for every optimizer)."""
    keys = dict(paramwise.get("custom_keys", {}))
    bias_lr = float(paramwise.get("bias_lr_mult", 1.0))
    bias_decay = float(paramwise.get("bias_decay_mult", 1.0))
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            lr_mult = decay_mult = 1.0
            custom = [k for k in keys if k in name]
            if custom:
                kcfg = dict(keys[custom[-1]])
                lr_mult = float(kcfg.get("lr_mult", 1.0))
                decay_mult = float(kcfg.get("decay_mult", 1.0))
            elif leaf == "bias" and not isinstance(mod, _NORMS):
                lr_mult, decay_mult = bias_lr, bias_decay
            yield name, p, lr_mult, decay_mult


def build_optimizer(model: torch.nn.Module, optimizer_cfg: dict
                    ) -> torch.optim.Optimizer:
    """AdamW, Adam or SGD with a param group per (``lr_mult``,
    ``decay_mult``)
    of ``_paramwise_mults``; each group records its ``lr_mult`` (the
    schedule sets ``lr = lr(count) * lr_mult``)."""
    cfg = dict(optimizer_cfg)
    kind = cfg.pop("type", "AdamW").lower()
    if kind not in ("adamw", "adam", "sgd"):
        raise NotImplementedError(f"the port's optimizers are AdamW, Adam "
                                  f"and SGD, not {optimizer_cfg.get('type')}")
    lr = float(cfg.pop("lr", 1e-3))
    wd = float(cfg.pop("weight_decay", 0.01 if kind == "adamw" else 0.0))
    paramwise = dict(cfg.pop("paramwise_cfg", None) or {})
    groups = {}
    for _, p, lr_mult, decay_mult in _paramwise_mults(model, paramwise):
        groups.setdefault((lr_mult, decay_mult), []).append(p)
    param_groups = [dict(params=ps, lr=lr * m, lr_mult=m, base_lr=lr,
                         weight_decay=wd * d)
                    for (m, d), ps in groups.items()]
    if kind == "sgd":
        return torch.optim.SGD(param_groups, lr=lr,
                               momentum=float(cfg.pop("momentum", 0.0)),
                               weight_decay=wd)
    betas = tuple(float(b) for b in cfg.pop("betas", (0.9, 0.999)))
    if kind == "adam":       # mmcv's Adam: the decay added to the gradient
        return torch.optim.Adam(param_groups, lr=lr, betas=betas,
                                weight_decay=wd)
    return torch.optim.AdamW(param_groups, lr=lr, betas=betas,
                             weight_decay=wd)


class Schedule:
    """Sets each group's ``lr`` (= lr(count) * lr_mult) and ``betas[0]``
    (= beta1(count)) before step ``count``."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 lr: Callable[[int], float],
                 beta1: Optional[Callable[[int], float]]):
        self.optimizer, self.lr, self.beta1 = optimizer, lr, beta1

    def apply(self, count: int) -> None:
        lr = self.lr(count)
        b1 = None if self.beta1 is None else self.beta1(count)
        for g in self.optimizer.param_groups:
            g["lr"] = lr * g.get("lr_mult", 1.0)
            if b1 is not None:
                g["betas"] = (b1, g["betas"][1])


def build_schedule(optimizer: torch.optim.Optimizer,
                   lr_config: Optional[dict] = None,
                   momentum_config: Optional[dict] = None,
                   total_steps: int = 10000,
                   steps_per_epoch: int = 1) -> Schedule:
    """lr and beta1 schedules of a config: cyclic (IS-Fusion), step with
    linear warmup (PointPillars' lr) or CosineAnnealing with linear warmup
    (MVX-Net's lr), else constant."""
    base_lr = float(optimizer.param_groups[0].get(
        "base_lr", optimizer.param_groups[0]["lr"]))
    base_b1 = float(optimizer.param_groups[0].get("betas", (0.9,))[0])

    def build(cfg, base, default_ratio, is_lr):
        if not cfg:
            return None
        cfg = dict(cfg)
        if cfg.get("policy") == "step" and is_lr:
            return step_schedule(
                base, cfg.get("step", []), float(cfg.get("gamma", 0.1)),
                cfg.get("warmup"), int(cfg.get("warmup_iters", 0)),
                float(cfg.get("warmup_ratio", 1e-3)), steps_per_epoch)
        if cfg.get("policy") in ("CosineAnnealing", "cosine") and is_lr:
            return cosine_schedule(
                base, total_steps, float(cfg.get("min_lr_ratio", 1e-3)),
                cfg.get("warmup"), int(cfg.get("warmup_iters", 0)),
                float(cfg.get("warmup_ratio", 1e-3)))
        if cfg.get("policy") != "cyclic":
            raise NotImplementedError(
                f"the port's schedules are cyclic, step or CosineAnnealing "
                f"(lr), not {cfg.get('policy')}")
        return cyclic_schedule(base, cfg.get("target_ratio", default_ratio),
                               int(cfg.get("cyclic_times", 1)),
                               float(cfg.get("step_ratio_up", 0.4)),
                               total_steps)

    lr = build(lr_config, base_lr, (10, 1e-4), True) or \
        (lambda count: base_lr)
    return Schedule(optimizer, lr, build(momentum_config, base_b1,
                                         (0.85, 1), False))


def grad_clip_norm(optimizer_config: Optional[dict]) -> Optional[float]:
    clip = dict(optimizer_config or {}).get("grad_clip")
    return float(clip["max_norm"]) if clip else None


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: Optional[float]
                        ) -> torch.Tensor:
    """optax ``clip_by_global_norm``: scale every gradient by max_norm /
    norm when the global norm exceeds max_norm (in place). Returns the
    pre-clip global norm."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads])) if grads \
        else torch.zeros(())
    if max_norm is not None and grads:
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        torch._foreach_mul_(grads, scale.to(grads[0].dtype))
    return norm
