"""FreeAnchor3DHead (counterpart of
``isfusion_tpu/models/dense_heads/free_anchor3d_head.py``; mmdet3d
``FreeAnchor3DHead``): Anchor3DHead's network and decode with the
learning-to-match loss.

Per sample, for every GT g and anchor a: the localisation probability
``loc_p`` = clip((IoU(g, decoded a) - bbox_thr) / (t2 - bbox_thr), 0, 1),
t2 = g's best IoU floored at bbox_thr + 1e-4 (IoU: nearest-BEV); g's bag,
its ``pre_anchor_topk`` anchors by IoU with the anchor boxes (ties: the
lower index, as ``jax.lax.top_k``); the positive loss -log of the
mean-max (weights 1 / (1 - p), normalised) of cls_prob(label) * loc_p over
the bag, averaged over the valid GTs and scaled by ``alpha``; the negative
loss, focal-weighted -log(1 - P) with P = cls_prob * (1 - the class's
best ``loc_p`` over its GTs), summed and divided by (valid GTs x topk),
scaled by 1 - ``alpha``. As in the JAX package the positive bag's box
likelihood is ``loc_p`` and there is no direction loss (ROADMAP queue 3):
the direction conv gets zero gradients (weight decay alone moves it, as
optax's AdamW moves it there).

The bag's class probabilities are gathered directly at (bag, label)
(the JAX package repeats the (A, C) probabilities over the GTs first);
the per-class best ``loc_p`` is one ``scatter_reduce`` max over (A, G)
into (A, C) from 0, padded GTs adding zeros, as the JAX scatter-max.
Every clip is ``torch.maximum`` / ``torch.minimum``, whose gradient at a
tie splits as ``jnp.clip``'s does.
"""
from __future__ import annotations

import torch

from ..middle_encoders.isfusion_encoder import topk_stable
from .anchor3d_head import Anchor3DHead, bbox_overlaps_nearest_3d


class _ZeroGradient(torch.autograd.Function):
    """``out`` unchanged; ``x`` gets a zero gradient (so the parameters
    that made it get zeros, not None)."""

    @staticmethod
    def forward(ctx, out, x):
        ctx.meta = (x.shape, x.dtype, x.device)
        return out.clone()

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.meta
        return grad, torch.zeros(shape, dtype=dtype, device=device)


def _clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, a tie's gradient split."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


class FreeAnchor3DHead(Anchor3DHead):
    def __init__(self, pre_anchor_topk: int = 16, bbox_thr: float = 0.6,
                 gamma: float = 2.0, alpha: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.pre_anchor_topk = int(pre_anchor_topk)
        self.bbox_thr = float(bbox_thr)
        self.gamma = float(gamma)
        self.alpha = float(alpha)

    def loss(self, preds, gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
             gt_mask: torch.Tensor) -> dict:
        """dict(positive_bag_loss, negative_bag_loss), each averaged over
        the batch."""
        anchors, cls_scores, bbox_preds, dir_preds, _ = self._flat(preds)
        k, nc, t1 = self.pre_anchor_topk, self.num_classes, self.bbox_thr
        pos_all, neg_all = [], []
        for i in range(cls_scores.shape[0]):
            gts, gmask = gt_bboxes[i].float(), gt_mask[i].bool()
            labels = gt_labels[i].long()
            probs = torch.sigmoid(cls_scores[i])                  # (A, C)
            decoded = self.bbox_coder.decode(anchors, bbox_preds[i])
            ious = torch.where(gmask[:, None], bbox_overlaps_nearest_3d(
                gts, decoded), -1.0)                              # (G, A)
            t2 = _clip(ious.amax(1, keepdim=True), t1 + 1e-4)
            loc_p = _clip((ious - t1) / (t2 - t1), 0.0, 1.0)
            with torch.no_grad():
                a_iou = torch.where(gmask[:, None], bbox_overlaps_nearest_3d(
                    gts, anchors), -1.0)
                bag = topk_stable(a_iou, k)                       # (G, k)
            safe_lbl = labels.clamp(0, nc - 1)
            match = probs[bag, safe_lbl[:, None]] * torch.gather(loc_p, 1,
                                                                 bag)
            w_bag = 1.0 / _clip(1.0 - match, 1e-12)
            w_bag = w_bag / w_bag.sum(-1, keepdim=True)
            pos_p = (w_bag * match).sum(-1)
            pos_loss = torch.where(gmask, -torch.log(_clip(pos_p, 1e-12, 1.0)),
                                   0.0)
            num_pos = gmask.sum().clamp_min(1)
            loc_masked = torch.where(gmask[:, None], loc_p, 0.0)
            obj_p = torch.zeros_like(probs).scatter_reduce(
                1, safe_lbl[None].expand(probs.shape[0], -1), loc_masked.T,
                "amax")                                           # (A, C)
            neg_p = probs * (1 - obj_p)
            neg_loss = -(neg_p ** self.gamma) * torch.log(
                _clip(1 - neg_p, 1e-12, 1.0))
            pos_all.append(self.alpha * pos_loss.sum() / num_pos)
            neg_all.append((1 - self.alpha) * neg_loss.sum() /
                           (num_pos * k).clamp_min(1))
        out = dict(positive_bag_loss=torch.stack(pos_all).mean(),
                   negative_bag_loss=torch.stack(neg_all).mean())
        if dir_preds is not None and dir_preds.requires_grad:
            out["positive_bag_loss"] = _ZeroGradient.apply(
                out["positive_bag_loss"], dir_preds)
        return out
