"""Group-Free 3D's head (counterpart of ``isfusion_tpu/models/dense_heads/
groupfree3d_head.py``; reference mmdet3d ``dense_heads/
groupfree3d_head.py``).

1. KPS: a seed objectness MLP (``PointsObjClsModule``) scores the
   backbone's last FP level; the top ``num_proposal`` valid seeds (ties in
   index order, as ``jax.lax.top_k``) are the candidates.
2. A proposal conv head (``conv_pred``: shared convs, ``conv_cls``
   (objectness, semantic), ``conv_reg``) predicts a box a candidate
   (``proposal.`` keys).
3. ``num_decoder_layers`` post-norm transformer layers refine the
   candidates' queries against every seed: each layer's query position is
   the previous stage's decoded box (centre and size, detached) through its
   own ``PositionEmbeddingLearned`` (6 wide), the keys' the seeds' xyz (3
   wide); padded seeds and candidates are masked out of the attention.
   Each layer has its own prediction head (``s{i}.`` keys).
4. The loss sums every stage's terms divided by the stage count, plus the
   KPS sampling objectness (a focal loss: the 4 seeds of each GT box's own
   points nearest its centre, in box-size units, are positive).

The port follows the JAX package where it differs from the reference
(ROADMAP queue 3, settled): a point belongs to the GT box that contains it
with the nearest gravity centre (the reference keeps up to three boxes a
point by its instance masks); ``get_bboxes`` takes the top ``max_num`` of
the stages' boxes (``test_cfg['prediction_stages']`` 'last', 'all' or
'last_three') by sigmoid objectness times softmax semantic score, with no
NMS.

Layer names follow the reference: ``points_obj_cls.mlp.layer{i}``
(Conv1d + BN1d, the last a Conv1d with a bias), ``conv_pred`` and
``prediction_heads.{i}`` (``shared_convs.layer{i}``, ``conv_cls``,
``conv_reg``), ``decoder_query_proj``, ``decoder_key_proj``,
``decoder_self_posembeds.{i}``, ``decoder_cross_posembeds.{i}``; inside
``decoder_layers.{i}`` the port's ``TransformerDecoderLayer`` names
(``self_attn``, ``multihead_attn``, ``linear1`` / ``linear2``,
``norm1``-``norm3``), not mmcv's ``attentions`` / ``ffns`` / ``norms``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox import coders  # noqa: F401  (registers the coders)
from ...models.losses import build_loss, cross_entropy_loss
from ...registry import BBOX_CODERS, build_from_cfg
from ..backbones.pointnet2 import SharedMLP
from ..middle_encoders.isfusion_encoder import topk_stable
from ..transformer import PositionEmbeddingLearned, TransformerDecoderLayer
from .vote_head import ConvPred, _gravity_centers, _sq_norm, _take


class _OutConv(nn.Module):
    """A Conv1d with a bias under ``conv`` (a ConvModule's name)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, 1)

    def forward(self, x):
        return F.linear(x, self.conv.weight[..., 0], self.conv.bias)


class PointsObjClsModule(nn.Module):
    """Seed objectness: ``num_convs - 1`` Conv1d + BN1d + ReLU layers over
    the valid seeds (the padded ones zeroed), then a Conv1d with a bias to
    one logit a seed (``mlp.layer{num_convs - 1}``)."""

    def __init__(self, in_channel: int, num_convs: int = 3):
        super().__init__()
        self.mlp = SharedMLP(in_channel, [in_channel] * (num_convs - 1),
                             ndim=1)
        self.last = f"layer{num_convs - 1}"
        self.mlp.add_module(self.last, _OutConv(in_channel, 1))

    def forward(self, feats, mask):
        return getattr(self.mlp, self.last)(self.mlp(feats, mask))[..., 0]


def _loss_weight(cfg: Optional[dict], default: float) -> float:
    """A loss config's weight. The head computes each term's function
    itself (focal gamma 2 and alpha 0.25, smooth L1 with beta 1, as the
    JAX head), so a config may say nothing else."""
    cfg = dict(cfg or {})
    extra = set(cfg) - {"type", "loss_weight"}
    if extra:
        raise ValueError(f"GroupFree3DHead takes only a loss's type and "
                         f"loss_weight, not {sorted(extra)}")
    return float(cfg.get("loss_weight", default))


class GroupFree3DHead(nn.Module):
    """``forward(feat_dict)`` -> the predictions' dict (``proposal.`` and
    ``s{i}.`` keys, the KPS logits and indices); ``loss`` the JAX
    package's terms; ``get_bboxes`` the top boxes of the chosen stages."""

    def __init__(self, num_classes: int = 18, in_channels: int = 288,
                 bbox_coder: dict = None, num_decoder_layers: int = 6,
                 num_proposal: int = 256, embed_dims: int = 288,
                 num_heads: int = 8, ffn_channels: int = 2048,
                 dropout: float = 0.1, pred_layer_cfg: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 sampling_objectness_loss: Optional[dict] = None,
                 objectness_loss: Optional[dict] = None,
                 center_loss: Optional[dict] = None,
                 dir_class_loss: Optional[dict] = None,
                 dir_res_loss: Optional[dict] = None,
                 size_class_loss: Optional[dict] = None,
                 size_res_loss: Optional[dict] = None,
                 size_reg_loss: Optional[dict] = None,
                 semantic_loss: Optional[dict] = None, **unused):
        super().__init__()
        self.num_classes = int(num_classes)
        self.bbox_coder = build_from_cfg(dict(bbox_coder), BBOX_CODERS)
        self.test_cfg = dict(test_cfg or {})
        self.num_proposal = int(num_proposal)
        self.num_decoder_layers = int(num_decoder_layers)
        self.weights = dict(
            sampling_objectness=_loss_weight(sampling_objectness_loss, 8.0),
            objectness=_loss_weight(objectness_loss, 1.0),
            center=_loss_weight(center_loss, 10.0),
            dir_class=_loss_weight(dir_class_loss, 1.0),
            dir_res=_loss_weight(dir_res_loss, 10.0),
            size_class=_loss_weight(size_class_loss, 1.0),
            size_res=_loss_weight(size_res_loss, 10.0),
            size_reg=_loss_weight(size_reg_loss, 10.0),
            semantic=_loss_weight(semantic_loss, 1.0))
        c, e = int(in_channels), int(embed_dims)
        coder = self.bbox_coder
        nb = coder.num_dir_bins
        num_reg = 6 + nb * 2 if coder.size_cls_agnostic else \
            3 + nb * 2 + coder.num_sizes * 4
        shared = list(dict(pred_layer_cfg or {}).get(
            "shared_conv_channels", (e, e)))
        self.points_obj_cls = PointsObjClsModule(c)
        self.conv_pred = ConvPred(c, shared, self.num_classes + 1, num_reg)
        self.decoder_query_proj = nn.Conv1d(c, e, 1)
        self.decoder_key_proj = nn.Conv1d(c, e, 1)
        n = self.num_decoder_layers
        self.decoder_self_posembeds = nn.ModuleList(
            PositionEmbeddingLearned(6, e) for _ in range(n))
        self.decoder_cross_posembeds = nn.ModuleList(
            PositionEmbeddingLearned(3, e) for _ in range(n))
        self.decoder_layers = nn.ModuleList(
            TransformerDecoderLayer(e, int(num_heads), int(ffn_channels),
                                    dropout=float(dropout),
                                    with_posembed=False)
            for _ in range(n))
        self.prediction_heads = nn.ModuleList(
            ConvPred(e, shared, self.num_classes + 1, num_reg)
            for _ in range(n))

    def _split_pred(self, cls_p, reg_p, base_xyz, prefix: str,
                    out: dict) -> None:
        """The JAX package's channel split of one stage's predictions."""
        coder = self.bbox_coder
        nb = coder.num_dir_bins
        out[f"{prefix}center_residual"] = reg_p[..., :3]
        out[f"{prefix}center"] = base_xyz + reg_p[..., :3]
        out[f"{prefix}dir_class"] = reg_p[..., 3:3 + nb]
        dir_res_norm = reg_p[..., 3 + nb:3 + 2 * nb]
        out[f"{prefix}dir_res_norm"] = dir_res_norm
        out[f"{prefix}dir_res"] = dir_res_norm * (math.pi / nb)
        i = 3 + 2 * nb
        if coder.size_cls_agnostic:
            out[f"{prefix}size"] = reg_p[..., i:i + 3]
        else:
            ns = coder.num_sizes
            out[f"{prefix}size_class"] = reg_p[..., i:i + ns]
            srn = reg_p[..., i + ns:i + 4 * ns].reshape(
                reg_p.shape[:-1] + (ns, 3))
            out[f"{prefix}size_res_norm"] = srn
            out[f"{prefix}size_res"] = srn * coder.mean_sizes.to(srn.device)
        out[f"{prefix}obj_scores"] = cls_p[..., :1]
        out[f"{prefix}sem_scores"] = cls_p[..., 1:]

    def forward(self, feat_dict: dict) -> dict:
        seed_xyz = feat_dict["fp_xyz"][-1]
        seed_feats = feat_dict["fp_features"][-1]
        seed_mask = feat_dict["fp_masks"][-1]
        obj_logits = self.points_obj_cls(seed_feats, seed_mask)
        k = min(self.num_proposal, seed_xyz.shape[1])
        topi = topk_stable(torch.where(seed_mask, obj_logits, torch.full(
            (), -1e9, device=obj_logits.device)), k)
        cand_xyz = _take(seed_xyz, topi)
        cand_feats = _take(seed_feats, topi)
        cand_mask = torch.gather(seed_mask, 1, topi)
        preds = dict(seeds_obj_cls_logits=obj_logits, seed_xyz=seed_xyz,
                     seed_mask=seed_mask, query_points_xyz=cand_xyz,
                     query_points_sample_inds=topi,
                     query_points_mask=cand_mask)
        self._split_pred(*self.conv_pred(cand_feats, cand_mask), cand_xyz,
                         "proposal.", preds)
        bbox3d = self.bbox_coder.decode(preds, "proposal.")
        lin = F.linear
        query = lin(cand_feats, self.decoder_query_proj.weight[..., 0],
                    self.decoder_query_proj.bias)
        key = lin(seed_feats, self.decoder_key_proj.weight[..., 0],
                  self.decoder_key_proj.bias)
        for i, layer in enumerate(self.decoder_layers):
            prefix = f"s{i}."
            qp = self.decoder_self_posembeds[i](bbox3d[..., :6].detach())
            kp = self.decoder_cross_posembeds[i](seed_xyz)
            query = layer(query, key, qp, kp, key_mask=seed_mask,
                          query_mask=cand_mask)
            self._split_pred(*self.prediction_heads[i](query, cand_mask),
                             cand_xyz, prefix, preds)
            bbox3d = self.bbox_coder.decode(preds, prefix)
        preds["num_decoder_layers"] = self.num_decoder_layers
        return preds

    # ---------------------------------------------------------- targets
    @staticmethod
    def point_instance_labels(points, gt_boxes, gt_mask):
        """(B, N) owning GT index (-1: background): of the GT boxes that
        contain the point, the one with the nearest gravity centre; and
        the (B, G, 3) gravity centres."""
        grav = _gravity_centers(gt_boxes)
        rel = points[:, :, None, :3] - grav[:, None]
        yaw = gt_boxes[..., 6]
        cos, sin = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
        lx = rel[..., 0] * cos - rel[..., 1] * sin
        ly = rel[..., 0] * sin + rel[..., 1] * cos
        inside = (lx.abs() < gt_boxes[..., 3][:, None] / 2) & \
            (ly.abs() < gt_boxes[..., 4][:, None] / 2) & \
            (rel[..., 2].abs() < gt_boxes[..., 5][:, None] / 2) & \
            gt_mask[:, None]
        d2 = torch.where(inside, _sq_norm(rel), torch.full(
            (), 1e10, device=rel.device))
        label = d2.argmin(-1)
        return torch.where(d2.amin(-1) < 1e9, label, torch.full(
            (), -1, dtype=label.dtype, device=label.device)), grav

    def loss(self, preds: dict, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_mask: torch.Tensor) -> dict:
        """gt_boxes (B, G, 7) bottom-centred, gt_labels (B, G), gt_mask
        (B, G) -> the JAX package's terms: the KPS sampling objectness,
        then each stage's objectness, centre, direction, size and semantic
        terms over the stage count. The seeds' owners are the containing
        boxes (``point_instance_labels``; the JAX package also labels the
        input points and does not read them)."""
        coder, wt = self.bbox_coder, self.weights
        gt_mask, gt_labels = gt_mask.bool(), gt_labels.long()
        bsz, g = gt_boxes.shape[:2]
        eps = 1e-6
        dev = gt_boxes.device
        seed_xyz, smask = preds["seed_xyz"], preds["seed_mask"]
        seed_inst, grav = self.point_instance_labels(seed_xyz, gt_boxes,
                                                     gt_mask)
        seed_inst = torch.where(smask, seed_inst,
                                torch.full((), -1, device=dev,
                                           dtype=seed_inst.dtype))

        # KPS supervision: the 4 seeds of a box's own nearest its centre
        delta = (seed_xyz[:, None] - grav[:, :, None]) / \
            (gt_boxes[..., 3:6][:, :, None] + eps)          # (B, G, N, 3)
        dist = torch.sqrt(_sq_norm(delta) + eps)
        owned = seed_inst[:, None, :] == torch.arange(g, device=dev)[
            None, :, None]
        dist = torch.where(owned, dist, torch.full((), 100.0, device=dev))
        top = topk_stable(-dist, 4)                         # (B, G, 4)
        ok = gt_mask[..., None] & (torch.gather(dist, -1, top) < 99.0)
        hit = torch.zeros(seed_xyz.shape[:2], device=dev).scatter_reduce(
            1, top.reshape(bsz, -1), ok.reshape(bsz, -1).float(), "amax")
        sampling_t = (hit > 0.5) & (seed_inst >= 0)
        sw = smask.float()
        sw = sw / sw.sum(-1, keepdim=True).clamp_min(1.0)
        focal = build_loss(dict(type="FocalLoss", use_sigmoid=True,
                                gamma=2.0, alpha=0.25, reduction="none"))
        s_loss = focal(preds["seeds_obj_cls_logits"][..., None],
                       sampling_t.float()[..., None])[..., 0]
        losses = dict(sampling_objectness_loss=wt["sampling_objectness"] *
                      (s_loss * sw).sum() / bsz)

        # the candidates' targets
        topi, cmask = preds["query_points_sample_inds"], \
            preds["query_points_mask"]
        cand_inst = torch.gather(seed_inst, 1, topi)
        objness_t = (cand_inst >= 0) & cmask
        ow = cmask.float()
        ow = ow / ow.sum(-1, keepdim=True).clamp_min(1.0)
        blw = objness_t.float()
        blw = blw / (blw.sum() + eps)
        assign = torch.where(cand_inst >= 0, cand_inst, torch.full(
            (), g - 1, device=dev, dtype=cand_inst.dtype))
        t_center = _take(grav, assign)
        t_dims = _take(gt_boxes[..., 3:6], assign)
        t_yaw = _take(gt_boxes[..., 6], assign)
        t_label = _take(gt_labels, assign)
        nb = coder.num_dir_bins
        if coder.with_rot:
            dir_cls_t, dir_res_t = coder.angle2class(t_yaw)
        else:
            dir_cls_t = torch.zeros(t_yaw.shape, dtype=torch.long,
                                    device=dev)
            dir_res_t = torch.zeros_like(t_yaw)
        dir_res_t = dir_res_t / torch.full((), math.pi / nb, device=dev)
        mean = coder.mean_sizes.to(dev)[t_label]
        size_res_t = (t_dims - mean) / (mean + eps)

        def ce(logits, target):
            return cross_entropy_loss(logits, target, reduction="none")

        sl1 = build_loss(dict(type="SmoothL1Loss", beta=1.0,
                              reduction="none"))
        prefixes = ["proposal."] + [f"s{i}." for i in range(
            int(preds["num_decoder_layers"]))]
        ns = len(prefixes)
        for p in prefixes:
            ol = focal(preds[f"{p}obj_scores"], objness_t.float()[..., None])
            losses[f"{p}objectness_loss"] = wt["objectness"] * (
                ol[..., 0] * ow).sum() / bsz / ns
            losses[f"{p}center_loss"] = wt["center"] * (sl1(
                preds[f"{p}center"], t_center).sum(-1) * blw).sum() / ns
            losses[f"{p}dir_class_loss"] = wt["dir_class"] * (ce(
                preds[f"{p}dir_class"], dir_cls_t) * blw).sum() / ns
            drn = torch.gather(preds[f"{p}dir_res_norm"], -1,
                               dir_cls_t[..., None])[..., 0]
            losses[f"{p}dir_res_loss"] = wt["dir_res"] * (
                sl1(drn, dir_res_t) * blw).sum() / ns
            if coder.size_cls_agnostic:
                losses[f"{p}size_reg_loss"] = wt["size_reg"] * (sl1(
                    preds[f"{p}size"], t_dims).sum(-1) * blw).sum() / ns
            else:
                losses[f"{p}size_class_loss"] = wt["size_class"] * (ce(
                    preds[f"{p}size_class"], t_label) * blw).sum() / ns
                srn = torch.gather(preds[f"{p}size_res_norm"], -2, t_label[
                    ..., None, None].expand(*t_label.shape, 1, 3))[..., 0, :]
                losses[f"{p}size_res_loss"] = wt["size_res"] * (sl1(
                    srn, size_res_t).sum(-1) * blw).sum() / ns
            losses[f"{p}semantic_loss"] = wt["semantic"] * (ce(
                preds[f"{p}sem_scores"], t_label) * blw).sum() / ns
        return losses

    # -------------------------------------------------------- inference
    def get_bboxes(self, preds: dict, max_num: Optional[int] = None) -> dict:
        """The top ``max_num`` (default ``test_cfg['max_output_num']``, else
        128) boxes of the stages ``test_cfg['prediction_stages']`` names
        ('last', 'all', 'last_three'), by sigmoid objectness times the best
        softmax semantic score: boxes (B, k, 7) bottom-centred, scores,
        labels, mask (score > 0)."""
        if max_num is None:
            max_num = int(self.test_cfg.get("max_output_num", 128))
        stages = self.test_cfg.get("prediction_stages", "last")
        nl = int(preds["num_decoder_layers"])
        if stages == "all":
            prefixes = ["proposal."] + [f"s{i}." for i in range(nl)]
        elif stages == "last_three":
            prefixes = [f"s{i}." for i in range(max(0, nl - 3), nl)]
        else:
            prefixes = [f"s{nl - 1}."]
        boxes, scores, labels, masks = [], [], [], []
        for p in prefixes:
            b = self.bbox_coder.decode(preds, p)
            boxes.append(torch.cat([b[..., :2], b[..., 2:3] - b[..., 5:6] / 2,
                                    b[..., 3:]], -1))
            sc = torch.sigmoid(preds[f"{p}obj_scores"][..., -1])[..., None] \
                * torch.softmax(preds[f"{p}sem_scores"], -1)
            scores.append(sc.amax(-1))
            labels.append(sc.argmax(-1))
            masks.append(preds["query_points_mask"])
        boxes, scores = torch.cat(boxes, 1), torch.cat(scores, 1)
        labels, masks = torch.cat(labels, 1), torch.cat(masks, 1)
        k = min(int(max_num), scores.shape[-1])
        ranked = torch.where(masks, scores, torch.zeros((),
                                                        device=scores.device))
        top = topk_stable(ranked, k)
        topv = torch.gather(ranked, 1, top)
        return dict(bboxes=_take(boxes, top), scores=topv,
                    labels=torch.gather(labels, 1, top), mask=topv > 0)
