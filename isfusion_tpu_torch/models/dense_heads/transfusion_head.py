"""TransFusionHeadV2 (counterpart of
``isfusion_tpu/models/dense_heads/transfusion_head.py``): shared conv ->
dense class heatmap -> 3x3 max-pool NMS -> top-``num_proposals`` queries
with a class embedding -> transformer decoder layer(s) -> FFN branches ->
score-fused decode (``get_bboxes``; NMS-free, or per-task circle or rotate
NMS by ``test_cfg['nms_type']``), or Hungarian targets and the focal / L1 /
gaussian-focal losses (``loss``).

The JAX head's stop-gradients sit at the same places: the proposal top-k
reads a detached heatmap, each decoder layer's query positions are the
detached centres of the layer before, the targets are computed on
detached predictions, and ``matched_ious`` carries no gradient. Matching
costs are formed on the device (IoU3DCost through one K10 launch for the
whole step) and solved on the host in one batch per step
(``ops/hungarian.py``).

NHWC BEV input. Heatmap logits, their top-k and the final FFN layers run
in float32; the rest in the config's ``compute_dtype``. Reference names:
``shared_conv``, ``heatmap_head.{0 (conv, bn), 1}``, ``class_encoding``,
``decoder.{i}``, ``prediction_heads.{i}.{task}.{0 (conv, bn), 1}``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...core.bbox.assigners import HungarianAssigner3D
from ...core.bbox.coders import TransFusionBBoxCoder
from ...ops.box_ops import circle_nms_mask, nms_bev_mask
from ...ops.gaussian import draw_heatmap_gaussian_batch, gaussian_radius
from ...ops.hungarian import assign_batch
from ..layers import BatchNorm, Conv1x1, Conv2d, ConvModule, resolve_dtype
from ..losses import build_loss
from ..middle_encoders.isfusion_encoder import maxpool_nms, topk_stable
from ..transformer import TransformerDecoderLayer


class _ConvBN1d(nn.Module):
    """Kernel-1 Conv1d (with bias, as the JAX Dense) + BN1d + ReLU."""

    def __init__(self, cin, cout, dtype=None):
        super().__init__()
        self.conv = Conv1x1(cin, cout, dtype=dtype)
        self.bn = BatchNorm(cout, dtype=dtype)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class FFN(nn.Module):
    """Per-branch prediction MLPs over (B, P, C) queries; the final layer
    of each branch runs in float32."""

    def __init__(self, in_channels, heads: dict, head_conv=64, dtype=None):
        super().__init__()
        self.heads = dict(heads)
        for key, (classes, num_conv) in self.heads.items():
            layers, c = [], in_channels
            for _ in range(int(num_conv) - 1):
                layers.append(_ConvBN1d(c, head_conv, dtype=dtype))
                c = head_conv
            layers.append(Conv1x1(c, int(classes), dtype=torch.float32))
            self.add_module(key, nn.Sequential(*layers))

    def reset_special_parameters(self):
        nn.init.constant_(self.heatmap[-1].bias, -2.19)

    def forward(self, x):
        out = {}
        for key in self.heads:
            seq = getattr(self, key)
            h = x
            for layer in seq[:-1]:
                h = layer(h)
            out[key] = seq[-1](h.float())
        return out


def clip_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    return torch.sigmoid(x).clamp(eps, 1 - eps)


class TransFusionHeadV2(nn.Module):
    def __init__(self, num_proposals=128, auxiliary=True, in_channels=384,
                 hidden_channel=128, num_classes=4, num_decoder_layers=3,
                 num_heads=8, nms_kernel_size=1, ffn_channel=256,
                 dropout=0.1, activation="relu", common_heads=None,
                 num_heatmap_convs=2, loss_cls=None, loss_bbox=None,
                 loss_heatmap=None, train_cfg=None, test_cfg=None,
                 bbox_coder=None, compute_dtype=None, **unused):
        super().__init__()
        dt = resolve_dtype(compute_dtype)
        self.cdtype = dt
        self.num_proposals, self.num_classes = num_proposals, num_classes
        self.auxiliary = bool(auxiliary)
        self.nms_kernel_size = nms_kernel_size
        self.hidden_channel = hidden_channel
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.loss_cls = build_loss(loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
            reduction="mean", loss_weight=1.0))
        self.loss_bbox = build_loss(loss_bbox or dict(
            type="L1Loss", reduction="mean", loss_weight=0.25))
        self.loss_heatmap = build_loss(loss_heatmap or dict(
            type="GaussianFocalLoss", reduction="mean", loss_weight=1.0))
        coder = dict(bbox_coder)
        coder.pop("type", None)
        self.bbox_coder = TransFusionBBoxCoder(**coder)
        self.shared_conv = Conv2d(in_channels, hidden_channel, 3, padding=1,
                                  dtype=dt)
        self.heatmap_head = nn.Sequential(
            ConvModule(hidden_channel, hidden_channel, 3, padding=1,
                       norm_cfg=dict(type="BN2d"), act_cfg=dict(type="relu"),
                       dtype=dt),
            Conv2d(hidden_channel, num_classes, 3, padding=1,
                   dtype=torch.float32))
        self.class_encoding = Conv1x1(num_classes, hidden_channel, dtype=dt)
        self.decoder = nn.ModuleList(
            TransformerDecoderLayer(hidden_channel, num_heads, ffn_channel,
                                    activation, dropout, dtype=dt)
            for _ in range(num_decoder_layers))
        heads = {**dict(common_heads or {}),
                 "heatmap": (num_classes, num_heatmap_convs)}
        self.prediction_heads = nn.ModuleList(
            FFN(hidden_channel, heads, head_conv=hidden_channel, dtype=dt)
            for _ in range(num_decoder_layers))

    def reset_special_parameters(self):
        nn.init.constant_(self.heatmap_head[1].bias, -2.19)

    def _flat_nms_classes(self) -> Tuple[int, ...]:
        ds = self.test_cfg.get("dataset", "nuScenes")
        if ds == "nuScenes" and self.num_classes >= 10:
            return (8, 9)
        if ds == "Waymo":
            return (1, 2)
        return ()

    def forward(self, feats) -> dict:
        """feats (B, H, W, C_in) or a 1-list of it -> dict of
        (B, num_proposals * num_layers, c) predictions + dense maps."""
        x = feats[0] if isinstance(feats, (tuple, list)) else feats
        if self.cdtype is not None:
            x = x.to(self.cdtype)
        b, h, w, _ = x.shape
        p, nc, c = self.num_proposals, self.num_classes, self.hidden_channel
        lidar_feat = self.shared_conv(x)
        hm = self.heatmap_head[0](lidar_feat)
        dense_heatmap = self.heatmap_head[1](hm.float())
        heat = maxpool_nms(torch.sigmoid(dense_heatmap.detach()),
                           self.nms_kernel_size, self._flat_nms_classes())
        heat_flat = heat.reshape(b, h * w, nc)
        # joint top-k over classes * positions, class-major
        top = topk_stable(heat_flat.transpose(1, 2).reshape(b, nc * h * w), p)
        top_class = top // (h * w)
        top_index = top % (h * w)
        ys = (top_index // w).float() + 0.5
        xs = (top_index % w).float() + 0.5
        query_pos = torch.stack([xs, ys], -1)                 # (B, P, 2)

        lidar_flat = lidar_feat.reshape(b, h * w, c)
        query_feat = torch.gather(lidar_flat, 1,
                                  top_index[..., None].expand(-1, -1, c))
        one_hot = torch.nn.functional.one_hot(top_class, nc).to(
            query_feat.dtype)
        query_feat = query_feat + self.class_encoding(one_hot)

        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        bev_pos = torch.from_numpy(np.stack([gx + 0.5, gy + 0.5], -1).reshape(
            1, h * w, 2).astype(np.float32)).to(x.device).expand(b, -1, -1)

        layer_preds = []
        qpos = query_pos
        for dec, ffn in zip(self.decoder, self.prediction_heads):
            query_feat = dec(query_feat, lidar_flat, qpos, bev_pos)
            res = ffn(query_feat)
            res["center"] = res["center"] + qpos
            qpos = res["center"].detach()
            layer_preds.append(res)
        preds = {k: torch.cat([lp[k] for lp in layer_preds], 1)
                 for k in layer_preds[0]}
        preds["dense_heatmap"] = dense_heatmap
        preds["query_heatmap_score"] = torch.gather(
            heat_flat, 1, top_index[..., None].expand(-1, -1, nc))
        preds["query_labels"] = top_class
        return preds

    def get_bboxes(self, preds: dict) -> dict:
        """Decode of the last layer's proposals -> (B, P) boxes, scores
        (zeroed outside ``post_center_range`` and where suppressed),
        labels, mask; NMS-free unless ``test_cfg['nms_type']`` is set
        (``_task_nms``)."""
        p, nc = self.num_proposals, self.num_classes
        score = torch.sigmoid(preds["heatmap"][:, -p:])
        one_hot = torch.nn.functional.one_hot(preds["query_labels"], nc)
        score = score * preds["query_heatmap_score"] * one_hot
        vel = preds.get("vel")
        d = self.bbox_coder.decode(
            score, preds["rot"][:, -p:], preds["dim"][:, -p:],
            preds["center"][:, -p:], preds["height"][:, -p:],
            vel[:, -p:] if vel is not None else
            torch.zeros(score.shape[:2] + (2,), dtype=score.dtype,
                        device=score.device))
        mask = self.bbox_coder.valid_mask(d["bboxes"], d["scores"])
        scores = torch.where(mask, d["scores"], 0.0)
        if self.test_cfg.get("nms_type") is not None:
            scores, mask = self._task_nms(d["bboxes"], scores, d["labels"],
                                          mask)
        return dict(bboxes=d["bboxes"], scores=scores, labels=d["labels"],
                    mask=mask)

    def _task_nms(self, bboxes, scores, labels, mask):
        """Per-task NMS (``get_bboxes:1344-1401``; the JAX head's): each
        task's class group with its radius (``circle``: K10-circle, the
        radius passed raw as the squared-distance threshold, the
        reference's ``box3d_nms.py:181`` quirk) or IoU threshold
        (``rotate``: K10-NMS on the BEV boxes); radius <= 0 keeps the whole
        group. One launch a task for the batch; nuScenes' tasks by
        default."""
        nms_type = self.test_cfg["nms_type"]
        tasks = self.test_cfg.get("tasks")
        if tasks is None:
            tasks = [dict(indices=list(range(8)), radius=-1),
                     dict(indices=[8], radius=0.175),
                     dict(indices=[9], radius=0.175)]
        b, p = scores.shape
        for task in tasks:
            radius = float(task.get("radius", -1))
            if radius <= 0:
                continue
            in_task = torch.isin(labels, torch.tensor(
                list(task["indices"]), device=labels.device))
            if nms_type == "circle":
                keep = circle_nms_mask(bboxes[..., :2], scores, radius,
                                       mask & in_task)
            else:
                keep = nms_bev_mask(bboxes[..., [0, 1, 3, 4, 6]],
                                    scores.view(b, 1, p), radius,
                                    (mask & in_task).view(b, 1, p))[:, 0]
            mask = torch.where(in_task, keep, mask)
            scores = torch.where(mask, scores, 0.0)
        return scores, mask

    # ------------------------------------------------------------ targets
    def get_targets(self, preds: dict, gt_bboxes: torch.Tensor,
                    gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                    feat_hw: Tuple[int, int]):
        """Per-layer Hungarian targets on the detached, decoded predictions
        and the dense gaussian heatmap target. ``gt_*``: (B, G, 9), (B, G),
        (B, G) padded GTs. Returns (labels, label_weights, bbox_targets,
        bbox_weights, num_pos, matched_ious, heatmap (B, H, W, nc))."""
        tc = self.train_cfg
        assigner = HungarianAssigner3D(**{
            k: v for k, v in dict(tc.get("assigner", {})).items()
            if k != "type"})
        nl = len(self.decoder) if self.auxiliary else 1
        p, nc = self.num_proposals, self.num_classes
        det = {k: preds[k][:, :nl * p].detach()
               for k in ("heatmap", "center", "height", "dim", "rot", "vel")
               if k in preds}
        boxes = self.bbox_coder.decode(det["heatmap"], det["rot"], det["dim"],
                                       det["center"], det["height"],
                                       det.get("vel"))["bboxes"]
        b, g = gt_labels.shape
        # every sample and decoder layer in one cost (one K10 launch)
        cost, iou = assigner.cost(boxes, gt_bboxes, gt_labels, gt_mask,
                                  det["heatmap"], tc)
        cols = assign_batch(cost.view(b, nl, p, g))
        res = assigner.result(
            cols, iou.view(b, nl, p, g),
            gt_labels[:, None].expand(b, nl, g),
            gt_mask[:, None].expand(b, nl, g))
        gt_inds = res.gt_inds.reshape(b, nl * p)
        matched = gt_inds >= 0
        gather = torch.gather(gt_bboxes.float(), 1, gt_inds.clamp_min(0)[
            ..., None].expand(-1, -1, gt_bboxes.shape[-1]))
        bbox_targets = self.bbox_coder.encode(gather)
        bbox_weights = matched[..., None].float()
        labels = torch.where(matched, res.labels.reshape(b, nl * p),
                             torch.full_like(gt_inds, nc))
        label_weights = torch.ones(labels.shape, device=labels.device)
        num_pos = matched.float().sum()
        matched_ious = res.max_overlaps.sum() / num_pos.clamp_min(1.0)

        # dense heatmap target over all classes (`get_targets_single:
        # 1080-1127`); grid steps in float32 like the JAX package
        pcr = [float(v) for v in tc["point_cloud_range"]]
        osf = np.float32(tc["out_size_factor"])
        sx = float(np.float32(tc["voxel_size"][0]) * osf)
        sy = float(np.float32(tc["voxel_size"][1]) * osf)
        h, w = feat_hw
        gtb = gt_bboxes.float()
        cx = (gtb[..., 0] - pcr[0]) / sx
        cy = (gtb[..., 1] - pcr[1]) / sy
        dxw, dyl = gtb[..., 3] / sx, gtb[..., 4] / sy
        radius = gaussian_radius((dyl, dxw), float(tc.get("gaussian_overlap",
                                                          0.1)))
        radius = torch.floor(radius).clamp_min(float(tc.get("min_radius", 2)))
        ok = gt_mask.bool() & (dxw > 0) & (dyl > 0) & (cx >= 0) & (cx < w) & \
            (cy >= 0) & (cy < h)
        heatmap = draw_heatmap_gaussian_batch(
            (h, w), torch.stack([cx, cy], -1), radius, ok, gt_labels, nc)
        return (labels, label_weights, bbox_targets, bbox_weights, num_pos,
                matched_ious, heatmap)

    # -------------------------------------------------------------- loss
    def loss(self, preds: dict, gt_bboxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_mask: torch.Tensor,
             ins_heatmap: Optional[torch.Tensor] = None) -> dict:
        """The loss dict of ``isfusion_tpu`` (``loss_heatmap``,
        ``loss_heatmap_ins``, ``layer_*_loss_cls``, ``layer_*_loss_bbox``,
        ``matched_ious``)."""
        h, w = preds["dense_heatmap"].shape[1:3]
        (labels, label_weights, bbox_targets, bbox_weights, num_pos,
         matched_ious, heatmap) = self.get_targets(preds, gt_bboxes,
                                                   gt_labels, gt_mask, (h, w))
        losses = {}
        hm_pos = (heatmap == 1.0).float().sum().clamp_min(1.0)
        losses["loss_heatmap"] = self.loss_heatmap(
            clip_sigmoid(preds["dense_heatmap"]), heatmap, avg_factor=hm_pos)
        if ins_heatmap is not None:
            losses["loss_heatmap_ins"] = self.loss_heatmap(
                clip_sigmoid(ins_heatmap.float()), heatmap,
                avg_factor=hm_pos)
        p, nc = self.num_proposals, self.num_classes
        nl = len(self.decoder) if self.auxiliary else 1
        code = bbox_targets.shape[-1]
        code_weights = torch.tensor(
            [float(v) for v in self.train_cfg.get("code_weights",
                                                  [1.0] * 10)][:code],
            device=bbox_targets.device)
        pred_boxes = torch.cat(
            [preds["center"], preds["height"], preds["dim"], preds["rot"]]
            + ([preds["vel"]] if "vel" in preds else []), -1)
        one_hot = torch.nn.functional.one_hot(labels, nc + 1).float()[
            ..., :nc]
        avg = num_pos.clamp_min(1.0)
        for l in range(nl):
            prefix = "layer_-1" if l == nl - 1 else f"layer_{l}"
            sl = slice(l * p, (l + 1) * p)
            losses[f"{prefix}_loss_cls"] = self.loss_cls(
                preds["heatmap"][:, sl].reshape(-1, nc),
                one_hot[:, sl].reshape(-1, nc),
                weight=label_weights[:, sl].reshape(-1)[:, None],
                avg_factor=avg)
            losses[f"{prefix}_loss_bbox"] = self.loss_bbox(
                pred_boxes[:, sl], bbox_targets[:, sl],
                weight=bbox_weights[:, sl] * code_weights, avg_factor=avg)
        losses["matched_ious"] = matched_ious.detach()
        return losses
