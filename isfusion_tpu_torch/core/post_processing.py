"""Multiclass NMS and the test-time-augmentation merge (counterpart of
``isfusion_tpu/core/post_processing.py``; mmdet3d ``box3d_multiclass_nms``
and ``merge_aug_bboxes_3d``).

``box3d_multiclass_nms``: per-class rotated-BEV NMS as one K10-NMS launch
over (1, C, N) score rows, then the class-major top ``max_num`` (ties:
the lower index, as ``jax.lax.top_k``). ``weighted_nms``: the TorchEx
score-weighted NMS; its IoU matrix is one K10-BEV launch on the boxes'
device in float32, its greedy merge runs on the host in float64, as the
JAX package runs it. ``merge_aug_bboxes_3d``: each view's scale, then
rotation, then flip undone (in the results' float32), the views
concatenated, then one class-agnostic K10-NMS (plain) or a per-class
``weighted_nms``. Inputs and results are tensors; NMS and IoU run on the
device of the results (the kernels' plain versions on the CPU).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.middle_encoders.isfusion_encoder import topk_stable
from ..ops.box_ops import boxes_iou_bev, nms_bev_mask

BEV_COLS = [0, 1, 3, 4, 6]


def box3d_multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor,
                         score_thr: float, nms_thr: float, max_num: int,
                         valid: Optional[torch.Tensor] = None) -> dict:
    """Per-class rotated-BEV NMS with a fixed output budget: boxes (N,
    >=7), scores (N, C) after the sigmoid, ``valid`` (N,) -> dict of
    (max_num,) bboxes, scores, labels and ``mask`` (score > score_thr)."""
    n, nc = scores.shape
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=scores.device)
    per_class = scores.float().T.contiguous()                 # (C, N)
    ok = valid.bool()[None] & (per_class > score_thr)
    keep = nms_bev_mask(boxes[None, :, BEV_COLS].float(), per_class[None],
                        nms_thr, ok[None])[0]
    flat = torch.where(keep, per_class, 0.0).reshape(-1)      # class-major
    topi = topk_stable(flat, max_num)
    topv = flat[topi]
    return dict(bboxes=boxes[topi % n], scores=topv, labels=topi // n,
                mask=topv > score_thr)


def weighted_nms(boxes: torch.Tensor, scores: torch.Tensor,
                 nms_thr: float = 0.25, merge_thr: float = 0.7,
                 yaw_tol: float = 0.3
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score-weighted box-averaging NMS (the reference's TorchEx
    ``wnms_gpu``). Greedy rotated-BEV NMS at ``nms_thr`` over the boxes by
    descending score (a stable sort) picks the keep set; each kept box
    becomes the score-weighted average of itself and the lower-scored
    boxes with BEV IoU > ``merge_thr`` whose yaw lies within ``yaw_tol``
    of the candidates' median yaw, their yaws unwrapped to the kept box's
    branch; the kept box's score is kept. boxes (N, D >= 7), scores (N,)
    -> (merged (K, D) float64, kept scores (K,) float64, kept indices
    (K,) int64), by descending score, on the boxes' device."""
    dev = boxes.device
    b_all = boxes.detach().double().cpu().numpy()
    s_all = scores.detach().double().cpu().numpy()
    if len(b_all) == 0:
        return (boxes.double(), scores.double(),
                torch.zeros((0,), dtype=torch.long, device=dev))
    order = np.argsort(-s_all, kind="stable")
    b, s = b_all[order], s_all[order]
    bev = torch.from_numpy(b[:, BEV_COLS]).float().to(dev)
    iou = boxes_iou_bev(bev, bev).cpu().double().numpy()
    n = len(b)
    suppressed = np.zeros(n, bool)
    keep: List[int] = []
    merged: List[np.ndarray] = []
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(i)
        later = np.arange(i + 1, n)
        suppressed[later] |= iou[i, later] > nms_thr
        cand = later[iou[i, later] > merge_thr]
        if len(cand) > 2:
            median_yaw = np.sort(b[cand, 6])[len(cand) // 2]
        else:
            median_yaw = b[i, 6]
        diff = (b[cand, 6] - median_yaw + np.pi) % (2 * np.pi) - np.pi
        sel = cand[np.abs(diff) < yaw_tol]
        w = np.concatenate([[s[i]], s[sel]])
        data = np.concatenate([b[i][None], b[sel]], axis=0)
        # yaws straddling +-pi would average to ~0 (a heading flipped by
        # ~pi): unwrap them to the kept box's branch first
        data[:, 6] = b[i, 6] + ((data[:, 6] - b[i, 6] + np.pi) %
                                (2 * np.pi) - np.pi)
        merged.append((w[:, None] * data).sum(0) / w.sum())
    keep_np = np.asarray(keep, np.int64)
    return (torch.from_numpy(np.stack(merged)).to(dev),
            torch.from_numpy(s[keep_np]).to(dev),
            torch.from_numpy(order[keep_np]).to(dev))


def undo_view(b: torch.Tensor, meta: dict) -> torch.Tensor:
    """A view's boxes in the original frame: its scale, then rotation,
    then flips undone (forward views compose flip -> rotate -> scale)."""
    b = b.clone()
    if meta.get("pcd_scale_factor"):
        b[:, :6] /= float(meta["pcd_scale_factor"])
    if meta.get("pcd_rotation"):
        th = -float(meta["pcd_rotation"])
        c, si = math.cos(th), math.sin(th)
        rot = torch.tensor([[c, si], [-si, c]], dtype=b.dtype,
                           device=b.device)
        b[:, :2] = b[:, :2] @ rot
        b[:, 6] += th
        if b.shape[1] >= 9:
            b[:, 7:9] = b[:, 7:9] @ rot
    if meta.get("pcd_horizontal_flip"):
        b[:, 1] = -b[:, 1]
        b[:, 6] = -b[:, 6]
        if b.shape[1] >= 9:
            b[:, 8] = -b[:, 8]
    if meta.get("pcd_vertical_flip"):
        b[:, 0] = -b[:, 0]
        b[:, 6] = -(b[:, 6] + math.pi)
        if b.shape[1] >= 9:
            b[:, 7] = -b[:, 7]
    return b


def merge_aug_bboxes_3d(aug_results: Sequence[dict],
                        aug_metas: Sequence[dict], score_thr: float = 0.0,
                        nms_thr: float = 0.25, max_num: int = 500,
                        use_weighted_nms: bool = False,
                        merge_thr: float = 0.7) -> dict:
    """Undo each view's transforms (``aug_metas[i]``: pcd_scale_factor,
    pcd_rotation (a yaw), pcd_horizontal_flip, pcd_vertical_flip),
    concatenate the views' bboxes (N_i, D), scores, labels and optional
    mask, and keep the boxes above ``score_thr``: plain mode runs one
    class-agnostic rotated-BEV NMS and returns the top min(max_num, N)
    (kept scores, others 0); ``use_weighted_nms`` merges each class with
    ``weighted_nms`` and returns the top ``max_num`` merged boxes. Returns
    dict(bboxes, scores, labels, mask = score > score_thr)."""
    boxes = torch.cat([undo_view(r["bboxes"], m)
                       for r, m in zip(aug_results, aug_metas)])
    scores = torch.cat([r["scores"] for r in aug_results])
    labels = torch.cat([r["labels"] for r in aug_results])
    valid = torch.cat([r["mask"].bool() if "mask" in r else torch.ones(
        len(r["bboxes"]), dtype=torch.bool, device=boxes.device)
        for r in aug_results]) & (scores > score_thr)
    if use_weighted_nms:
        out_b, out_s, out_l = [], [], []
        for c in torch.unique(labels[valid]).tolist():
            sel = valid & (labels == c)
            mb, ms, _ = weighted_nms(boxes[sel], scores[sel], nms_thr=nms_thr,
                                     merge_thr=merge_thr)
            out_b.append(mb)
            out_s.append(ms)
            out_l.append(torch.full((len(ms),), c, dtype=labels.dtype,
                                    device=labels.device))
        if not out_b:
            out_b = [boxes.new_zeros((0,) + tuple(boxes.shape[1:]),
                                     dtype=torch.float64)]
            out_s = [scores.new_zeros((0,), dtype=torch.float64)]
            out_l = [labels.new_zeros((0,))]
        mb, ms, ml = torch.cat(out_b), torch.cat(out_s), torch.cat(out_l)
        order = torch.sort(ms, descending=True, stable=True).indices[
            :max_num]
        return dict(bboxes=mb[order].to(boxes.dtype),
                    scores=ms[order].to(scores.dtype), labels=ml[order],
                    mask=ms[order] > score_thr)
    keep = nms_bev_mask(boxes[None, :, BEV_COLS].float(),
                        scores.float()[None, None], nms_thr,
                        valid[None, None])[0, 0]
    flat = torch.where(keep, scores, torch.zeros_like(scores))
    topi = topk_stable(flat, min(max_num, len(boxes)))
    topv = flat[topi]
    return dict(bboxes=boxes[topi], scores=topv, labels=labels[topi],
                mask=topv > score_thr)
