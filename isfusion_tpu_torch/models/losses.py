"""The losses of the TransFusion and Anchor3D heads (counterpart of
``isfusion_tpu/models/losses.py``): mmdet's FocalLoss (sigmoid),
GaussianFocalLoss, L1Loss, SmoothL1Loss and CrossEntropyLoss with their
``weight`` and ``avg_factor`` reduction, built from config dicts by
``build_loss``."""
from __future__ import annotations

from typing import Optional

import torch


def _reduce(loss: torch.Tensor, weight: Optional[torch.Tensor],
            reduction: str, avg_factor) -> torch.Tensor:
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is None:
        denom = weight.sum().clamp_min(1e-6) if weight is not None \
            else loss.numel()
        return loss.sum() / denom
    if torch.is_tensor(avg_factor):
        return loss.sum() / avg_factor.clamp_min(1e-6)
    return loss.sum() / max(float(avg_factor), 1e-6)


def _bce_with_logits(pred: torch.Tensor, target: torch.Tensor
                     ) -> torch.Tensor:
    return pred.clamp_min(0) - pred * target + \
        torch.log1p(torch.exp(-pred.abs()))


def sigmoid_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       gamma: float = 2.0, alpha: float = 0.25,
                       reduction: str = "mean", avg_factor=None
                       ) -> torch.Tensor:
    """Sigmoid focal loss over logits; ``target`` is one-hot (pred's
    shape)."""
    p = torch.sigmoid(pred)
    ce = _bce_with_logits(pred, target)
    p_t = p * target + (1 - p) * (1 - target)
    alpha_t = alpha * target + (1 - alpha) * (1 - target)
    loss = alpha_t * (1 - p_t) ** gamma * ce
    return _reduce(loss, weight, reduction, avg_factor)


def gaussian_focal_loss(pred: torch.Tensor, gaussian_target: torch.Tensor,
                        weight: Optional[torch.Tensor] = None,
                        alpha: float = 2.0, gamma: float = 4.0,
                        reduction: str = "mean", avg_factor=None
                        ) -> torch.Tensor:
    """CornerNet focal loss on gaussian heatmaps; ``pred`` is a
    probability (post-sigmoid)."""
    eps = 1e-12
    pos_weights = (gaussian_target == 1).to(pred.dtype)
    neg_weights = (1 - gaussian_target) ** gamma
    pos_loss = -torch.log(pred + eps) * (1 - pred) ** alpha * pos_weights
    neg_loss = -torch.log(1 - pred + eps) * pred ** alpha * neg_weights * \
        (1 - pos_weights)
    return _reduce(pos_loss + neg_loss, weight, reduction, avg_factor)


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            weight: Optional[torch.Tensor] = None, reduction: str = "mean",
            avg_factor=None) -> torch.Tensor:
    return _reduce((pred - target).abs(), weight, reduction, avg_factor)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   weight: Optional[torch.Tensor] = None, beta: float = 1.0,
                   reduction: str = "mean", avg_factor=None) -> torch.Tensor:
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return _reduce(loss, weight, reduction, avg_factor)


def cross_entropy_loss(pred: torch.Tensor, label: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       reduction: str = "mean", avg_factor=None,
                       use_sigmoid: bool = False) -> torch.Tensor:
    """CE over logits: softmax over the last axis against int class
    indices, or (``use_sigmoid``) binary CE against a target of pred's
    shape, or of pred's shape without its class axis (mean over
    classes)."""
    if use_sigmoid:
        loss = _bce_with_logits(pred, label.to(pred.dtype))
        if loss.dim() == label.dim() + 1:
            loss = loss.mean(-1)
    else:
        logp = torch.log_softmax(pred, -1)
        loss = -torch.gather(logp, -1, label.long()[..., None])[..., 0]
    return _reduce(loss, weight, reduction, avg_factor)


class _LossWrapper:
    """A config-built loss: ``loss_weight * fn(pred, target, weight,
    avg_factor, **defaults)``."""

    def __init__(self, fn, loss_weight: float = 1.0, **defaults):
        self.fn = fn
        self.loss_weight = float(loss_weight)
        self.defaults = defaults

    def __call__(self, pred, target, weight=None, avg_factor=None, **kw):
        return self.loss_weight * self.fn(pred, target, weight=weight,
                                          avg_factor=avg_factor,
                                          **{**self.defaults, **kw})


def build_loss(cfg: dict) -> _LossWrapper:
    cfg = dict(cfg)
    kind = cfg.pop("type")
    weight = cfg.pop("loss_weight", 1.0)
    reduction = cfg.pop("reduction", "mean")
    if kind == "FocalLoss":
        if not cfg.pop("use_sigmoid", True):
            raise NotImplementedError("FocalLoss needs use_sigmoid=True")
        return _LossWrapper(sigmoid_focal_loss, weight,
                            gamma=float(cfg.pop("gamma", 2.0)),
                            alpha=float(cfg.pop("alpha", 0.25)),
                            reduction=reduction)
    if kind == "GaussianFocalLoss":
        return _LossWrapper(gaussian_focal_loss, weight,
                            alpha=float(cfg.pop("alpha", 2.0)),
                            gamma=float(cfg.pop("gamma", 4.0)),
                            reduction=reduction)
    if kind == "L1Loss":
        return _LossWrapper(l1_loss, weight, reduction=reduction)
    if kind == "SmoothL1Loss":
        return _LossWrapper(smooth_l1_loss, weight,
                            beta=float(cfg.pop("beta", 1.0)),
                            reduction=reduction)
    if kind == "CrossEntropyLoss":
        return _LossWrapper(cross_entropy_loss, weight,
                            use_sigmoid=bool(cfg.pop("use_sigmoid", False)),
                            reduction=reduction)
    raise ValueError(f"unknown loss type {kind!r}")
