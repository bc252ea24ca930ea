"""FCOSMono3DHead (counterpart of
``isfusion_tpu/models/dense_heads/fcos_mono3d_head.py``; reference
``mmdet3d/models/dense_heads/fcos_mono3d_head.py`` on
``anchor_free_mono3d_head.py``), NHWC.

Forward: cls and reg towers of ``stacked_convs`` 3x3 ConvModules (GN,
ReLU), shared across the FPN levels; 1x1 branch towers and convs for the
class scores (bias -4.595), the grouped regression (offset 2, depth 1,
size 3, rot 1, velo 2), the direction bin, the attributes and the
centerness (on the reg tower). Each level has its own scales for offset,
depth and size; depth and size go through ``exp`` (size + 1e-6).

Targets (``get_targets``), vectorized over images x points x padded GTs:
center-sampled FCOS assignment (radius ``stride x center_sample_radius``
around the projected 3D centre, the level's regress range over the 2D
box, the nearest centre wins, first index on ties; background =
``num_classes``), offsets in stride units, local yaw ``-atan2(x, z) +
yaw``, centerness ``exp(-alpha * dist / (1.414 * stride))``.

Losses (as the JAX package): focal classification, one smooth-L1 over
the 9 codes weighted by ``code_weight`` (``train_cfg``; the JAX package's
fixed weights, equal to the config's, by default) with the sin difference
on yaw, direction CE with bin ``((yaw - dir_offset) mod 2pi) >= pi``,
attribute CE and centerness BCE, each over ``max(num_pos, 1)``.

Decode (``get_bboxes``): camera-frame centres through ``inv(cam2img)``,
global yaw = local + ``atan2(x, z)`` then the direction bin, score =
``sigmoid(cls) x sigmoid(ctr)`` (max and argmax over classes) and a fixed
top ``max_num`` (a stable descending sort: the lower index first on ties,
as ``jax.lax.top_k``) with ``mask = score > 0``. As in the JAX package there
is no score threshold and no rotated NMS; the test config's
``use_rotate_nms`` / ``nms_thr`` / ``score_thr`` / ``nms_pre`` are accepted
and not applied (ROADMAP queue 3).

Reference names: ``cls_convs.{i}``, ``reg_convs.{i}`` (``.conv``, ``.gn``),
``conv_cls_prev.{i}``, ``conv_cls``, ``conv_reg_prevs.{g}.{i}``,
``conv_regs.{g}``, ``conv_dir_cls_prev.{i}``, ``conv_dir_cls``,
``conv_attr_prev.{i}``, ``conv_attr``, ``conv_centerness_prev.{i}``,
``conv_centerness``, ``scales.{level}.{0,1,2}.scale``.

Batch contract (camera frame): img (B, H, W, 3); cam2img (B, 4, 4);
gt_bboxes (B, G, 4) 2D boxes; centers2d (B, G, 2); depths (B, G);
gt_bboxes_3d (B, G, >= 7) camera-frame boxes; gt_labels_3d (B, G);
attr_labels (B, G); gt_mask (B, G).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..layers import Conv2d, ConvModule, resolve_dtype
from ..losses import build_loss

INF = 1e8
# the JAX package's fixed code weights (the config's train_cfg.code_weight)
CODE_WEIGHT = (1.0, 1.0, 0.2, 1.0, 1.0, 1.0, 1.0, 0.05, 0.05)


class Scale(nn.Module):
    """A learnable scalar factor (mmcv ``Scale``)."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(scale)))

    def forward(self, x):
        return x * self.scale


def flatten_levels(maps: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, h, w, C) maps -> (B, sum h*w, C), row-major (h, w)."""
    return torch.cat([m.reshape(m.shape[0], -1, m.shape[-1]) for m in maps],
                     1)


class FCOSMono3DHead(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 2,
                 strides=(8, 16, 32, 64, 128),
                 regress_ranges=((-1, 48), (48, 96), (96, 192), (192, 384),
                                 (384, INF)),
                 center_sampling: bool = True,
                 center_sample_radius: float = 1.5,
                 norm_on_bbox: bool = True, centerness_on_reg: bool = True,
                 centerness_alpha: float = 2.5, num_attrs: int = 9,
                 group_reg_dims=(2, 1, 3, 1, 2), cls_branch=(256,),
                 reg_branch=((256,), (256,), (256,), (256,), ()),
                 dir_branch=(256,), attr_branch=(256,),
                 centerness_branch=(64,),
                 use_direction_classifier: bool = True,
                 diff_rad_by_sin: bool = True, dir_offset: float = 0.7854,
                 pred_attrs: bool = True, pred_velo: bool = True,
                 norm_cfg: Optional[dict] = None, loss_cls=None,
                 loss_bbox=None, loss_dir=None, loss_attr=None,
                 loss_centerness=None, train_cfg=None, test_cfg=None,
                 compute_dtype=None, **unused):
        super().__init__()
        if not center_sampling:
            raise NotImplementedError("the port's FCOS3D targets are center "
                                      "sampled, as the JAX package's")
        dt = resolve_dtype(compute_dtype)
        self.num_classes, self.num_attrs = int(num_classes), int(num_attrs)
        self.strides = tuple(int(s) for s in strides)
        self.regress_ranges = tuple(tuple(float(v) for v in r)
                                    for r in regress_ranges)
        self.center_sample_radius = float(center_sample_radius)
        self.norm_on_bbox = bool(norm_on_bbox)
        self.centerness_on_reg = bool(centerness_on_reg)
        self.centerness_alpha = float(centerness_alpha)
        self.group_reg_dims = tuple(int(d) for d in group_reg_dims)
        self.use_direction_classifier = bool(use_direction_classifier)
        self.diff_rad_by_sin = bool(diff_rad_by_sin)
        self.dir_offset = float(dir_offset)
        self.pred_attrs, self.pred_velo = bool(pred_attrs), bool(pred_velo)
        self.train_cfg, self.test_cfg = dict(train_cfg or {}), \
            dict(test_cfg or {})
        norm = dict(norm_cfg or dict(type="GN", num_groups=32))
        kw = dict(norm_cfg=norm, act_cfg=dict(type="relu"), dtype=dt)

        def tower(cin, channels, k):
            mods = []
            for c in channels:
                mods.append(ConvModule(cin, int(c), k, padding=k // 2, **kw))
                cin = int(c)
            return nn.ModuleList(mods), cin

        fc = int(feat_channels)
        self.cls_convs, _ = tower(in_channels, [fc] * stacked_convs, 3)
        self.reg_convs, _ = tower(in_channels, [fc] * stacked_convs, 3)
        self.conv_cls_prev, c = tower(fc, cls_branch, 1)
        self.conv_cls = Conv2d(c, self.num_classes, 1, dtype=dt)
        prevs, regs = [], []
        for g, d in enumerate(self.group_reg_dims):
            prev, c = tower(fc, reg_branch[g], 1)
            prevs.append(prev)
            regs.append(Conv2d(c, d, 1, dtype=dt))
        self.conv_reg_prevs, self.conv_regs = nn.ModuleList(prevs), \
            nn.ModuleList(regs)
        if self.use_direction_classifier:
            self.conv_dir_cls_prev, c = tower(fc, dir_branch, 1)
            self.conv_dir_cls = Conv2d(c, 2, 1, dtype=dt)
        if self.pred_attrs:
            self.conv_attr_prev, c = tower(fc, attr_branch, 1)
            self.conv_attr = Conv2d(c, self.num_attrs, 1, dtype=dt)
        self.conv_centerness_prev, c = tower(fc, centerness_branch, 1)
        self.conv_centerness = Conv2d(c, 1, 1, dtype=dt)
        self.scales = nn.ModuleList(
            nn.ModuleList(Scale(1.0) for _ in range(3))
            for _ in self.strides)
        self.loss_cls = build_loss(loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0))
        self.loss_bbox = build_loss(loss_bbox or dict(
            type="SmoothL1Loss", beta=1.0 / 9.0, loss_weight=1.0))
        self.loss_dir = build_loss(loss_dir or dict(
            type="CrossEntropyLoss", loss_weight=1.0))
        self.loss_attr = build_loss(loss_attr or dict(
            type="CrossEntropyLoss", loss_weight=1.0))
        self.loss_centerness = build_loss(loss_centerness or dict(
            type="CrossEntropyLoss", use_sigmoid=True, loss_weight=1.0))
        self.reset_special_parameters()

    @property
    def bbox_code_size(self) -> int:
        return sum(self.group_reg_dims)

    def reset_special_parameters(self):
        with torch.no_grad():
            self.conv_cls.bias.fill_(-4.595)
            for lvl in self.scales:
                for s in lvl:
                    s.scale.fill_(1.0)

    # ------------------------------------------------------------ forward
    @staticmethod
    def _run(x, mods):
        for m in mods:
            x = m(x)
        return x

    def forward(self, feats) -> list:
        """feats: per level (B, h, w, C) -> per level a dict of float32 NHWC
        maps: cls_score, bbox_pred (9 codes), dir_cls_pred, attr_pred,
        centerness."""
        outs = []
        for lvl, x in enumerate(feats):
            cls_feat = self._run(x, self.cls_convs)
            reg_feat = self._run(x, self.reg_convs)
            cls_score = self.conv_cls(self._run(cls_feat, self.conv_cls_prev))
            bbox = torch.cat([reg(self._run(reg_feat, prev)) for prev, reg in
                              zip(self.conv_reg_prevs, self.conv_regs)],
                             -1).float()
            s_off, s_dep, s_size = self.scales[lvl]
            bbox = torch.cat([s_off(bbox[..., :2]),
                              torch.exp(s_dep(bbox[..., 2:3])),
                              torch.exp(s_size(bbox[..., 3:6])) + 1e-6,
                              bbox[..., 6:]], -1)
            src = reg_feat if self.centerness_on_reg else cls_feat
            out = dict(cls_score=cls_score.float(), bbox_pred=bbox,
                       centerness=self.conv_centerness(self._run(
                           src, self.conv_centerness_prev)).float())
            out["dir_cls_pred"] = self.conv_dir_cls(self._run(
                reg_feat, self.conv_dir_cls_prev)).float() \
                if self.use_direction_classifier else None
            out["attr_pred"] = self.conv_attr(self._run(
                cls_feat, self.conv_attr_prev)).float() \
                if self.pred_attrs else None
            outs.append(out)
        return outs

    # ------------------------------------------------------------- points
    def points(self, shapes, device):
        """Grid points of every level, concatenated: (N, 2) pixel (x, y) =
        index * stride + stride // 2, and (N,) the stride of each."""
        pts, strides = [], []
        for (h, w), s in zip(shapes, self.strides):
            ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            pts.append(np.stack([xs.reshape(-1) * s + s // 2,
                                 ys.reshape(-1) * s + s // 2], -1))
            strides.append(np.full((h * w,), s))
        return (torch.from_numpy(np.concatenate(pts).astype(np.float32)).to(
            device), torch.from_numpy(np.concatenate(strides).astype(
                np.float32)).to(device))

    def ranges(self, shapes, device) -> torch.Tensor:
        r = [np.tile(np.asarray(rr, np.float32), (h * w, 1))
             for (h, w), rr in zip(shapes, self.regress_ranges)]
        return torch.from_numpy(np.concatenate(r)).to(device)

    # ------------------------------------------------------------ targets
    def get_targets(self, points, strides, ranges, gt_bboxes, centers2d,
                    depths, gt_bboxes_3d, gt_labels, attr_labels, gt_mask):
        """points (N, 2), strides (N,), ranges (N, 2); per image (B, G, ...)
        padded GTs. Returns labels (B, N) (background = num_classes), the
        9 code targets (B, N, 9), centerness (B, N), attributes (B, N)
        (background = num_attrs) and the foreground mask (B, N)."""
        xs, ys = points[None, :, 0, None], points[None, :, 1, None]
        g3 = gt_bboxes_3d.float()
        yaw_local = -torch.atan2(g3[..., 0], g3[..., 2]) + g3[..., 6]
        dx = xs - centers2d[:, None, :, 0]
        dy = ys - centers2d[:, None, :, 1]
        left = xs - gt_bboxes[:, None, :, 0]
        right = gt_bboxes[:, None, :, 2] - xs
        top = ys - gt_bboxes[:, None, :, 1]
        bottom = gt_bboxes[:, None, :, 3] - ys
        max_reg = torch.maximum(torch.maximum(left, right),
                                torch.maximum(top, bottom))
        radius = strides[None, :, None] * self.center_sample_radius
        inside = (dx.abs() < radius) & (dy.abs() < radius) & \
            (left > -radius) & (right > -radius)
        in_range = (max_reg >= ranges[None, :, 0:1]) & \
            (max_reg <= ranges[None, :, 1:2])
        dist = torch.sqrt(dx ** 2 + dy ** 2)
        dist = torch.where(inside & in_range & gt_mask[:, None, :], dist,
                           torch.full((), INF, device=dist.device))
        idx = dist.argmin(-1)          # the first index on ties, as JAX's
        fg = (dist < INF).any(-1)

        def pick(t):                   # (B, G, ...) -> (B, N, ...)
            return torch.gather(t, 1, idx.reshape(idx.shape + (1,) * (
                t.dim() - 2)).expand(idx.shape + t.shape[2:]))

        labels = torch.where(fg, pick(gt_labels), self.num_classes)
        attrs = torch.where(fg, pick(attr_labels), self.num_attrs)
        tdx = torch.gather(dx, 2, idx[..., None])[..., 0]
        tdy = torch.gather(dy, 2, idx[..., None])[..., 0]
        g = pick(g3)
        velo = g[..., 7:9] if self.pred_velo and g3.shape[-1] >= 9 else \
            torch.zeros(g.shape[:2] + (2,), device=g.device)
        code = torch.cat([tdx[..., None], tdy[..., None],
                          pick(depths.float())[..., None], g[..., 3:6],
                          pick(yaw_local)[..., None], velo], -1)
        if self.norm_on_bbox:
            code = torch.cat([code[..., :2] / strides[None, :, None],
                              code[..., 2:]], -1)
        rel = torch.sqrt(tdx ** 2 + tdy ** 2) / (1.414 * strides[None])
        centerness = torch.exp(-self.centerness_alpha * rel)
        return labels, code, centerness, attrs, fg

    # --------------------------------------------------------------- loss
    def loss(self, preds: list, batch: dict) -> dict:
        shapes = [tuple(p["cls_score"].shape[1:3]) for p in preds]
        dev = preds[0]["cls_score"].device
        points, strides = self.points(shapes, dev)
        ranges = self.ranges(shapes, dev)
        has_attr = "attr_labels" in batch
        attr_labels = batch["attr_labels"].long() if has_attr else \
            torch.zeros_like(batch["gt_labels_3d"]).long()
        labels, code_t, ctr_t, attrs_t, fg = self.get_targets(
            points, strides, ranges, batch["gt_bboxes"].float(),
            batch["centers2d"].float(), batch["depths"],
            batch["gt_bboxes_3d"], batch["gt_labels_3d"].long(),
            attr_labels, batch["gt_mask"].bool())
        cls = flatten_levels([p["cls_score"] for p in preds])
        bbox = flatten_levels([p["bbox_pred"] for p in preds])
        ctr = flatten_levels([p["centerness"] for p in preds])[..., 0]
        num_pos = fg.float().sum().clamp_min(1.0)
        one_hot = torch.nn.functional.one_hot(
            labels, self.num_classes + 1)[..., :self.num_classes].float()
        losses = dict(loss_cls=self.loss_cls(cls, one_hot,
                                             avg_factor=num_pos))
        fgw = fg.float()
        code_w = torch.tensor(self.train_cfg.get("code_weight", CODE_WEIGHT),
                              dtype=torch.float32, device=dev)[
                                  :bbox.shape[-1]]
        pred, tgt = bbox, code_t
        if self.diff_rad_by_sin:
            sa = torch.sin(pred[..., 6]) * torch.cos(tgt[..., 6])
            sb = torch.cos(pred[..., 6]) * torch.sin(tgt[..., 6])
            pred = torch.cat([pred[..., :6], sa[..., None], pred[..., 7:]],
                             -1)
            tgt = torch.cat([tgt[..., :6], sb[..., None], tgt[..., 7:]], -1)
        losses["loss_bbox"] = self.loss_bbox(
            pred, tgt, weight=fgw[..., None] * code_w, avg_factor=num_pos)
        losses["loss_centerness"] = self.loss_centerness(
            ctr.reshape(-1), ctr_t.reshape(-1), weight=fgw.reshape(-1),
            avg_factor=num_pos)
        if self.use_direction_classifier:
            dir_t = torch.remainder(code_t[..., 6] - self.dir_offset,
                                    2 * math.pi) >= math.pi
            losses["loss_dir"] = self.loss_dir(
                flatten_levels([p["dir_cls_pred"] for p in preds]),
                dir_t.long(), weight=fgw, avg_factor=num_pos)
        if self.pred_attrs and has_attr:
            losses["loss_attr"] = self.loss_attr(
                flatten_levels([p["attr_pred"] for p in preds]),
                torch.where(fg, attrs_t, 0), weight=fgw, avg_factor=num_pos)
        return losses

    # ------------------------------------------------------------- decode
    def get_bboxes(self, preds: list, cam2img: torch.Tensor,
                   max_num: int = 200) -> dict:
        """Camera-frame boxes (B, K, 9) (x, y, z, w, l, h, yaw, vx, vz),
        scores, labels, attrs and mask (B, K), K = min(max_num, points)."""
        shapes = [tuple(p["cls_score"].shape[1:3]) for p in preds]
        points, strides = self.points(shapes, cam2img.device)
        cls = torch.sigmoid(flatten_levels([p["cls_score"] for p in preds]))
        ctr = torch.sigmoid(flatten_levels(
            [p["centerness"] for p in preds]))[..., 0]
        bbox = flatten_levels([p["bbox_pred"] for p in preds])
        c2d = points[None] + bbox[..., :2] * strides[None, :, None]
        depth = bbox[..., 2:3]
        hom = torch.cat([c2d * depth, depth, torch.ones_like(depth)], -1)
        centers = (hom @ torch.linalg.inv(cam2img.float()).transpose(
            1, 2))[..., :3]
        yaw = bbox[..., 6] + torch.atan2(centers[..., 0], centers[..., 2])
        if self.use_direction_classifier:
            dir_cls = flatten_levels(
                [p["dir_cls_pred"] for p in preds]).argmax(-1)
            do, period = self.dir_offset, math.pi
            yaw_l = (yaw - do) - torch.floor((yaw - do) / period) * period
            yaw = yaw_l + do + period * dir_cls.to(yaw.dtype)
        vel = bbox[..., 7:9] if self.pred_velo else \
            torch.zeros_like(bbox[..., :2])
        boxes = torch.cat([centers, bbox[..., 3:6], yaw[..., None], vel], -1)
        scores_all = cls * ctr[..., None]
        scores, labels = scores_all.max(-1)
        k = min(int(max_num), scores.shape[1])
        top, order = torch.sort(scores, dim=1, descending=True, stable=True)
        top, order = top[:, :k], order[:, :k]

        def take(x):
            return torch.gather(x, 1, order if x.dim() == 2 else
                                order[..., None].expand(-1, -1, x.shape[-1]))

        out = dict(bboxes=take(boxes), scores=top, labels=take(labels),
                   mask=top > 0.0)
        if self.pred_attrs:
            out["attrs"] = take(flatten_levels(
                [p["attr_pred"] for p in preds])).argmax(-1)
        return out
