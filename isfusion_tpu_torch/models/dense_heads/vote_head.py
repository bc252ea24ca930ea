"""VoteNet's head (counterpart of ``isfusion_tpu/models/dense_heads/
vote_head.py``; reference mmdet3d ``dense_heads/vote_head.py`` and
``model_utils/vote_module.py``).

The seeds (the backbone's last FP level) vote for object centres: a
shared MLP and a 1x1 conv give each seed an offset and a feature residual
(``VoteModule``). A set-abstraction level over the votes (``vote_
aggregation``: K14-FPS, K14-ball, K14-gather at 256 points) aggregates
them into proposals, and a shared MLP plus two 1x1 convs
(``conv_pred.conv_cls``: objectness and semantic logits; ``conv_reg``:
the centre offset, direction bins and residuals, size classes and
residuals) predict the boxes, decoded by ``PartialBinBasedBBoxCoder``.

The port follows the JAX package where it differs from the reference
(ROADMAP queue 3, settled): ``get_bboxes`` takes the top ``max_num`` of
objectness times semantic score with no NMS (``test_cfg``'s NMS keys are
read and ignored); the vote loss is the mean L2 distance of each seed's
vote to the centre of the GT box that contains it (the nearest such
centre), not a chamfer over 3 GT votes a seed; the objectness, centre,
direction, size and semantic losses are unweighted; the vote aggregation
takes every entry of ``mlp_channels`` as a layer's output width (the
reference reads the first as the input width) and always normalises the
grouped xyz; the vote features are rescaled by sqrt(C) after their L2
normalisation.

Layer names are the reference's: ``vote_module.vote_conv.{i}`` (Conv1d +
BN1d), ``vote_module.conv_out``, ``vote_aggregation.mlps.0.layer{i}``,
``conv_pred.shared_convs.layer{i}``, ``conv_pred.conv_cls`` /
``conv_reg``. The JAX package predicts all of them with one dense layer;
a state dict that carries it as ``conv_pred.conv_out`` (the JAX column
order, ``runner/convert.py``) is split on load (``split_joint_pred``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ...core.bbox import coders  # noqa: F401  (registers the coder)
from ...models.losses import cross_entropy_loss
from ...registry import BBOX_CODERS, build_from_cfg
from ..backbones.pointnet2 import PointSAModule, SharedMLP
from ..middle_encoders.isfusion_encoder import topk_stable


def _gravity_centers(gt: torch.Tensor) -> torch.Tensor:
    """(B, G, >=6) bottom-centred boxes -> (B, G, 3) gravity centres."""
    return torch.cat([gt[..., :2], gt[..., 2:3] + gt[..., 5:6] / 2], -1)


def _sq_norm(d: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...): (x*x + y*y) + z*z."""
    x, y, z = d.unbind(-1)
    return (x * x + y * y) + z * z


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, G, ...) at idx (B, P) -> (B, P, ...)."""
    view = idx.reshape(idx.shape + (1,) * (t.dim() - 2))
    return torch.gather(t, 1, view.expand(idx.shape + t.shape[2:]))


class VoteModule(nn.Module):
    """Seed -> vote (``model_utils/vote_module.py``): ``vote_conv`` (shared
    Conv1d + BN1d + ReLU over the valid seeds), ``conv_out`` (Conv1d with a
    bias, 3 + C outputs a vote); the vote is the seed moved by the offset
    and its features plus the residual, L2-normalised and scaled by sqrt(C)
    (``norm_feats``). One vote a seed."""

    def __init__(self, in_channels: int = 256, vote_per_seed: int = 1,
                 gt_per_seed: int = 3, conv_channels: Sequence[int] = (256,
                                                                      256),
                 norm_feats: bool = True, **unused):
        super().__init__()
        if int(vote_per_seed) != 1:
            raise NotImplementedError("VoteModule: one vote a seed (the JAX "
                                      "package's layout)")
        self.in_channels = int(in_channels)
        self.norm_feats = bool(norm_feats)
        self.vote_conv = SharedMLP(self.in_channels, conv_channels, ndim=1,
                                   prefix="")
        self.conv_out = nn.Conv1d(int(conv_channels[-1]),
                                  3 + self.in_channels, 1)

    def forward(self, seed_xyz, seed_feats, seed_mask):
        x = self.vote_conv(seed_feats, seed_mask)
        out = torch.nn.functional.linear(x, self.conv_out.weight[..., 0],
                                         self.conv_out.bias)
        offset = out[..., :3]
        vote_xyz = seed_xyz + offset
        vote_feats = seed_feats + out[..., 3:]
        if self.norm_feats:
            norm = torch.linalg.vector_norm(vote_feats, dim=-1, keepdim=True)
            vote_feats = vote_feats / norm.clamp_min(1e-6) * math.sqrt(
                float(vote_feats.shape[-1]))
        return vote_xyz, vote_feats, offset


def split_joint_pred(state_dict: dict, prefix: str, num_reg: int) -> None:
    """In place: ``{prefix}conv_out.weight`` / ``.bias``, the JAX package's
    one prediction layer (columns: objectness 2, the ``num_reg``
    regression outputs, then the semantic logits), become the reference's
    ``conv_cls`` (objectness, semantic) and ``conv_reg``."""
    for leaf in ("weight", "bias"):
        t = state_dict.pop(f"{prefix}conv_out.{leaf}", None)
        if t is None:
            continue
        state_dict[f"{prefix}conv_cls.{leaf}"] = torch.cat(
            [t[:2], t[2 + num_reg:]])
        state_dict[f"{prefix}conv_reg.{leaf}"] = t[2:2 + num_reg]


class ConvPred(nn.Module):
    """The reference's ``BaseConvBboxHead``: ``shared_convs.layer{i}``
    (Conv1d + BN1d + ReLU over the valid proposals), then ``conv_cls``
    (2 + classes) and ``conv_reg`` (3 + 2 bins + 4 sizes) Conv1d with
    biases."""

    def __init__(self, in_channels: int, shared: Sequence[int],
                 num_cls: int, num_reg: int):
        super().__init__()
        self.num_reg = int(num_reg)
        self.shared_convs = SharedMLP(in_channels, shared, ndim=1)
        c = int(shared[-1]) if shared else in_channels
        self.conv_cls = nn.Conv1d(c, int(num_cls), 1)
        self.conv_reg = nn.Conv1d(c, self.num_reg, 1)

    def forward(self, x, mask):
        x = self.shared_convs(x, mask)
        lin = torch.nn.functional.linear
        return lin(x, self.conv_cls.weight[..., 0], self.conv_cls.bias), \
            lin(x, self.conv_reg.weight[..., 0], self.conv_reg.bias)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        split_joint_pred(state_dict, prefix, self.num_reg)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class VoteHead(nn.Module):
    """``forward(feat_dict)`` (the backbone's dict: its last FP level's
    points are the seeds) -> the predictions' dict; ``loss`` the JAX
    package's terms; ``get_bboxes`` the top proposals."""

    def __init__(self, num_classes: int = 18, bbox_coder: dict = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 vote_module_cfg: Optional[dict] = None,
                 vote_aggregation_cfg: Optional[dict] = None,
                 feat_channels: Sequence[int] = (128, 128),
                 vote_loss: Optional[dict] = None, **unused):
        super().__init__()
        self.num_classes = int(num_classes)
        self.bbox_coder = build_from_cfg(dict(bbox_coder), BBOX_CODERS)
        self.test_cfg = dict(test_cfg or {})
        self.vote_loss_weight = float(dict(vote_loss or {}).get(
            "loss_weight", 1.0))
        vm = {k: v for k, v in dict(vote_module_cfg or {}).items()
              if k in ("in_channels", "vote_per_seed", "gt_per_seed",
                       "conv_channels", "norm_feats")}
        vm.setdefault("in_channels", 256)
        self.vote_module = VoteModule(**vm)
        agg = dict(vote_aggregation_cfg or {})
        mlp = list(agg.get("mlp_channels", (256, 128, 128, 128)))
        self.vote_aggregation = PointSAModule(
            num_point=int(agg.get("num_point", 256)),
            radii=[float(agg.get("radius", 0.3))],
            sample_nums=[int(agg.get("num_sample", 16))],
            mlp_channels=mlp, in_channels=vm["in_channels"], use_xyz=True,
            normalize_xyz=True)
        nb, ns = self.bbox_coder.num_dir_bins, self.bbox_coder.num_sizes
        self.conv_pred = ConvPred(int(mlp[-1]), list(feat_channels),
                                  2 + self.num_classes, 3 + nb * 2 + ns * 4)

    def forward(self, feat_dict: dict) -> dict:
        seed_xyz = feat_dict["fp_xyz"][-1]
        seed_feats = feat_dict["fp_features"][-1]
        seed_mask = feat_dict["fp_masks"][-1]
        vote_xyz, vote_feats, vote_offset = self.vote_module(
            seed_xyz, seed_feats, seed_mask)
        agg_xyz, agg_feats, _, agg_mask = self.vote_aggregation(
            vote_xyz, vote_feats, seed_mask)
        cls, reg = self.conv_pred(agg_feats, agg_mask)
        nb, ns = self.bbox_coder.num_dir_bins, self.bbox_coder.num_sizes
        dir_res_norm = reg[..., 3 + nb:3 + 2 * nb]
        size_res = reg[..., 3 + 2 * nb + ns:].reshape(reg.shape[:-1] +
                                                      (ns, 3))
        return dict(
            seed_xyz=seed_xyz, seed_mask=seed_mask, vote_xyz=vote_xyz,
            vote_offset=vote_offset, aggregated_points=agg_xyz,
            aggregated_mask=agg_mask, obj_scores=cls[..., :2],
            center=agg_xyz + reg[..., :3], dir_class=reg[..., 3:3 + nb],
            dir_res=dir_res_norm * (math.pi / nb),
            size_class=reg[..., 3 + 2 * nb:3 + 2 * nb + ns],
            size_res=size_res, sem_scores=cls[..., 2:],
            seed_indices=feat_dict["fp_indices"])

    # ------------------------------------------------------------- loss
    def loss(self, preds: dict, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_mask: torch.Tensor) -> dict:
        """gt_boxes (B, G, 7) bottom-centred, gt_labels (B, G), gt_mask
        (B, G) -> the JAX package's loss terms."""
        big = torch.full((), 1e10, device=gt_boxes.device)
        grav = _gravity_centers(gt_boxes)
        gt_mask = gt_mask.bool()
        gt_labels = gt_labels.long()

        # vote loss: a seed inside a GT box votes for its centre
        seed_xyz, smask = preds["seed_xyz"], preds["seed_mask"]
        rel = seed_xyz[:, :, None, :] - grav[:, None, :, :]
        yaw = gt_boxes[..., 6]
        cos, sin = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
        lx = rel[..., 0] * cos - rel[..., 1] * sin
        ly = rel[..., 0] * sin + rel[..., 1] * cos
        inside = (lx.abs() < gt_boxes[..., 3][:, None] / 2) & \
            (ly.abs() < gt_boxes[..., 4][:, None] / 2) & \
            (rel[..., 2].abs() < gt_boxes[..., 5][:, None] / 2) & \
            gt_mask[:, None, :]
        d2 = torch.where(inside, _sq_norm(rel), big)
        owner = d2.argmin(-1)
        w = ((d2.amin(-1) < 1e9) & smask).float()
        err = torch.sqrt(_sq_norm(preds["vote_xyz"] - _take(grav, owner)))
        losses = dict(vote_loss=self.vote_loss_weight * (err * w).sum() /
                      w.sum().clamp_min(1.0))

        # objectness and the box terms of the aggregated proposals
        agg, amask = preds["aggregated_points"], preds["aggregated_mask"]
        dd = torch.where(gt_mask[:, None, :], _sq_norm(
            agg[:, :, None] - grav[:, None]), big)
        near = torch.sqrt(dd.amin(-1))
        assign = dd.argmin(-1)
        pos = (near < 0.3) & amask
        neg = (near > 0.6) & amask
        obj_w = (pos | neg).float()

        def ce(logits, target):
            return cross_entropy_loss(logits, target, reduction="none")

        losses["objectness_loss"] = (ce(preds["obj_scores"], pos.long()) *
                                     obj_w).sum() / obj_w.sum().clamp_min(1.0)
        posw = pos.float()
        np_ = posw.sum().clamp_min(1.0)
        tgt_center = _take(grav, assign)
        losses["center_loss"] = ((preds["center"] - tgt_center).abs().sum(-1)
                                 * posw).sum() / np_
        tgt_label = _take(gt_labels, assign)
        _, size_cls_t, size_res_t, dir_cls_t, dir_res_t = \
            self.bbox_coder.encode(tgt_center, _take(gt_boxes[..., 3:6],
                                                     assign),
                                   _take(gt_boxes[..., 6], assign), tgt_label)
        losses["dir_class_loss"] = (ce(preds["dir_class"], dir_cls_t) *
                                    posw).sum() / np_
        dres = torch.gather(preds["dir_res"], -1, dir_cls_t[..., None])[..., 0]
        losses["dir_res_loss"] = ((dres - dir_res_t).abs() * posw).sum() / np_
        losses["size_class_loss"] = (ce(preds["size_class"], size_cls_t) *
                                     posw).sum() / np_
        sres = torch.gather(preds["size_res"], -2, size_cls_t[
            ..., None, None].expand(*size_cls_t.shape, 1, 3))[..., 0, :]
        losses["size_res_loss"] = ((sres - size_res_t).abs().sum(-1) *
                                   posw).sum() / np_
        losses["semantic_loss"] = (ce(preds["sem_scores"], tgt_label) *
                                   posw).sum() / np_
        return losses

    # -------------------------------------------------------- inference
    def get_bboxes(self, preds: dict, max_num: Optional[int] = None) -> dict:
        """The top ``max_num`` (``test_cfg['max_output_num']``, default
        128) proposals by objectness times their best semantic score: boxes
        (B, k, 7) bottom-centred, scores, labels, mask (score > 0)."""
        if max_num is None:
            max_num = int(self.test_cfg.get("max_output_num", 128))
        boxes = self.bbox_coder.decode(
            preds["center"], preds["dir_class"], preds["dir_res"],
            preds["size_class"], preds["size_res"])
        boxes = torch.cat([boxes[..., :2], boxes[..., 2:3] -
                           boxes[..., 5:6] / 2, boxes[..., 3:]], -1)
        obj = torch.softmax(preds["obj_scores"], -1)[..., 1]
        scores = obj[..., None] * torch.softmax(preds["sem_scores"], -1)
        best, labels = scores.amax(-1), scores.argmax(-1)
        k = min(int(max_num), best.shape[-1])
        ranked = torch.where(preds["aggregated_mask"], best,
                             torch.zeros((), device=best.device))
        top = topk_stable(ranked, k)
        topv = torch.gather(ranked, 1, top)
        return dict(bboxes=_take(boxes, top), scores=topv,
                    labels=torch.gather(labels, 1, top), mask=topv > 0)
