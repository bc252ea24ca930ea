"""Proposal samplers of two-stage training (counterpart of
``isfusion_tpu/core/bbox/samplers.py``; reference
``mmdet3d/core/bbox/samplers/iou_neg_piecewise_sampler.py``).

Fixed-size index arrays with validity masks, as the JAX package returns
them. The draws come from an explicit ``torch.Generator``; a draw is a
vector of uniform priorities, and ``draw(n)`` (default: ``torch.rand(n,
generator=generator)``) may be given to pin them, so that a test hands
both packages the same numbers. JAX's PartA2 samples no proposals; these
come with the family.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ...models.middle_encoders.isfusion_encoder import topk_stable


def masked_choice(priorities: torch.Tensor, mask: torch.Tensor, k: int):
    """k indices of ``mask``'s True positions, without replacement, by
    descending uniform priority (masked priorities are -1; ties: the lower
    index first, as ``jax.lax.top_k``) -> (idx (k,), valid (k,))."""
    pri = torch.where(mask, priorities, torch.full_like(priorities, -1.0))
    order = topk_stable(pri, k)
    return order, mask[order]


class PseudoSampler:
    """Every positive kept, no sampling (mmdet's PseudoSampler)."""

    def sample(self, gt_inds: torch.Tensor,
               max_overlaps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               draw: Optional[Callable[[int], torch.Tensor]] = None) -> dict:
        idx = torch.arange(gt_inds.shape[0], device=gt_inds.device)
        return dict(pos_inds=idx, pos_valid=gt_inds > 0, neg_inds=idx,
                    neg_valid=gt_inds == 0)


class IoUNegPiecewiseSampler:
    """IoU piece-wise negative sampling: positives at random up to ``num *
    pos_fraction``; negatives from IoU bands (band i covers [thr_{i+1},
    thr_i), the last reaching down to 0), each with a fixed share of the
    negative budget; slots a band cannot fill are topped off by random
    negatives that no band drew, slot by slot (the JAX package's static
    form of the reference's ``extend_num``)."""

    def __init__(self, num: int, pos_fraction: float = 0.5,
                 neg_piece_fractions: Sequence[float] = (0.8, 0.2),
                 neg_iou_piece_thrs: Sequence[float] = (0.55, 0.1),
                 neg_pos_ub: float = -1, add_gt_as_proposals: bool = False,
                 return_iou: bool = False):
        if len(neg_piece_fractions) != len(neg_iou_piece_thrs):
            raise ValueError("one fraction per IoU band")
        self.num = int(num)
        self.pos_fraction = float(pos_fraction)
        self.neg_piece_fractions = [float(f) for f in neg_piece_fractions]
        self.neg_iou_thr = [float(t) for t in neg_iou_piece_thrs]
        self.return_iou = return_iou

    def sample(self, gt_inds: torch.Tensor, max_overlaps: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               draw: Optional[Callable[[int], torch.Tensor]] = None) -> dict:
        """gt_inds (N,): 0 negative, > 0 the matched GT + 1; max_overlaps
        (N,) each proposal's best IoU. The draws, in order: positives,
        each band, the top-off."""
        n = gt_inds.shape[0]
        if draw is None:
            def draw(size):
                return torch.rand(size, generator=generator,
                                  device=gt_inds.device)
        num_pos = int(self.num * self.pos_fraction)
        num_neg = self.num - num_pos
        pos_inds, pos_valid = masked_choice(draw(n), gt_inds > 0, num_pos)
        neg_mask = gt_inds == 0
        n_b = len(self.neg_iou_thr)
        budgets = [int(num_neg * f) for f in self.neg_piece_fractions]
        budgets[-1] = num_neg - sum(budgets[:-1])
        chosen, chosen_valid = [], []
        for i in range(n_b):
            hi = self.neg_iou_thr[i]
            lo = self.neg_iou_thr[i + 1] if i + 1 < n_b else 0.0
            band = neg_mask & (max_overlaps >= lo) & (max_overlaps < hi)
            idx, val = masked_choice(draw(n), band, budgets[i])
            chosen.append(idx)
            chosen_valid.append(val)
        chosen, chosen_valid = torch.cat(chosen), torch.cat(chosen_valid)
        short = ~chosen_valid
        taken = torch.zeros_like(neg_mask)
        taken[chosen[chosen_valid]] = True
        fill_idx, fill_val = masked_choice(draw(n), neg_mask & ~taken,
                                           num_neg)
        out = dict(pos_inds=pos_inds, pos_valid=pos_valid,
                   neg_inds=torch.where(short, fill_idx, chosen),
                   neg_valid=chosen_valid | (short & fill_val))
        if self.return_iou:
            out["iou"] = torch.cat([max_overlaps[pos_inds],
                                    max_overlaps[out["neg_inds"]]])
        return out
