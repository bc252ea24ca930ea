"""CenterHead (counterpart of
``isfusion_tpu/models/dense_heads/centerpoint_head.py``): a shared 3x3
ConvModule over the BEV map, then per task a SeparateHead of ``reg``,
``height``, ``dim``, ``rot``, ``vel`` and ``heatmap`` branches (the
heatmap's final bias -2.19); gaussian heatmap targets, the gaussian focal
and masked L1 losses (``loss``); the per-task heatmap decode, circle NMS
and top ``post_max_size`` (``get_bboxes``).

NHWC maps. The convs run in the config's ``compute_dtype``; the head's
outputs, the targets, losses, decode and NMS run in float32. The targets
paint every task's heatmap in one K11 launch (the tasks' classes are
contiguous channel ranges of one (B, H, W, C) heatmap); the circle NMS of
every sample and task is one K10-circle launch (``ops/box_ops.py``), the
``nms_type='rotate'`` branch one K10-NMS launch. Reference names:
``shared_conv.{conv,bn}``, ``task_heads.{t}.{key}.{i}.{conv,bn}``,
``task_heads.{t}.{key}.{num_conv - 1}`` (the final conv).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core.bbox.coders import CenterPointBBoxCoder
from ...ops.box_ops import circle_nms_mask, nms_bev_mask
from ...ops.gaussian import draw_heatmap_gaussian_batch, gaussian_radius
from ..layers import Conv2d, ConvModule, resolve_dtype
from ..losses import build_loss
from ..middle_encoders.isfusion_encoder import topk_stable
from .transfusion_head import clip_sigmoid


class SeparateHead(nn.Module):
    """Per-task branches: for each key (out_channels, num_conv), num_conv
    - 1 ConvModules of ``head_conv`` channels, then the final conv (with
    bias); the heatmap's final bias starts at ``init_bias``."""

    def __init__(self, in_channels: int, heads: dict, head_conv: int = 64,
                 final_kernel: int = 1, init_bias: float = -2.19,
                 norm_cfg=None, dtype=None, **unused):
        super().__init__()
        self.heads = {k: (int(c), int(n)) for k, (c, n) in heads.items()}
        self.init_bias = float(init_bias)
        pad = final_kernel // 2
        for key, (classes, num_conv) in self.heads.items():
            layers, c = [], in_channels
            for _ in range(num_conv - 1):
                layers.append(ConvModule(c, head_conv, final_kernel,
                                         padding=pad, norm_cfg=norm_cfg,
                                         act_cfg=dict(type="relu"),
                                         dtype=dtype))
                c = head_conv
            layers.append(Conv2d(c, classes, final_kernel, padding=pad,
                                 bias=True, dtype=dtype))
            self.add_module(key, nn.Sequential(*layers))

    def reset_special_parameters(self):
        nn.init.constant_(self.heatmap[-1].bias, self.init_bias)

    def forward(self, x: torch.Tensor) -> dict:
        return {key: getattr(self, key)(x).float() for key in self.heads}


class CenterHead(nn.Module):
    def __init__(self, in_channels: int = 128, tasks=None, train_cfg=None,
                 test_cfg=None, bbox_coder=None, common_heads=None,
                 loss_cls=None, loss_bbox=None, separate_head=None,
                 share_conv_channel: int = 64, num_heatmap_convs: int = 2,
                 norm_cfg=None, norm_bbox: bool = True, compute_dtype=None,
                 **unused):
        super().__init__()
        dt = resolve_dtype(compute_dtype)
        self.class_names = [list(t["class_names"]) for t in tasks]
        self.num_classes = [len(n) for n in self.class_names]
        self.task_offsets = np.cumsum([0] + self.num_classes).tolist()
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.norm_bbox = bool(norm_bbox)
        norm_cfg = dict(norm_cfg or dict(type="BN2d"))
        self.shared_conv = ConvModule(in_channels, share_conv_channel, 3,
                                      padding=1, norm_cfg=norm_cfg,
                                      act_cfg=dict(type="relu"), dtype=dt)
        sep = dict(separate_head or dict(init_bias=-2.19, final_kernel=3))
        sep.pop("type", None)
        heads = []
        for nc in self.num_classes:
            branches = {k: tuple(v) for k, v in (common_heads or {}).items()}
            branches["heatmap"] = (nc, num_heatmap_convs)
            heads.append(SeparateHead(share_conv_channel, branches,
                                      norm_cfg=norm_cfg, dtype=dt, **sep))
        self.task_heads = nn.ModuleList(heads)
        self.bbox_coder = CenterPointBBoxCoder(**dict(bbox_coder or {}))
        self.loss_cls = build_loss(loss_cls or dict(
            type="GaussianFocalLoss", reduction="mean"))
        self.loss_bbox = build_loss(loss_bbox or dict(
            type="L1Loss", reduction="none", loss_weight=0.25))
        # circle NMS's per-task thresholds live with the module, and their
        # repeats over a batch are kept per (batch size, device): a request
        # copies nothing from the host for them
        self.register_buffer("nms_min_radius", torch.tensor([float(v) for v in
                             self.test_cfg.get("min_radius", [4] * len(
                                 self.num_classes))]), persistent=False)
        self._nms_thresholds = {}

    def forward(self, feats):
        """feats: an NHWC map or a list of them -> per level, per task, a
        dict of float32 (B, H, W, c) maps."""
        if torch.is_tensor(feats):
            feats = [feats]
        outs = []
        for x in feats:
            x = self.shared_conv(x)
            outs.append([head(x) for head in self.task_heads])
        return outs

    # ------------------------------------------------------------ targets
    def get_targets(self, gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
                    gt_mask: torch.Tensor, feat_hw):
        """gt_bboxes (B, G, 9) bottom-z boxes, gt_labels (B, G) global
        class ids, gt_mask (B, G) -> (heatmap (B, H, W, C) of every class,
        anno (B, G, 10), ind (B, G), valid (B, G)); task t's targets are
        the channels and valid rows of its classes."""
        tc = self.train_cfg
        h, w = feat_hw
        gtb = gt_bboxes.float()
        dev = gtb.device
        osf = np.float32(tc["out_size_factor"])
        # grid steps and divisions in float32 like the JAX package (tensor
        # divisors: true division on every device)
        step = torch.tensor([np.float32(v) * osf for v in
                             tc["voxel_size"][:2]], device=dev)
        low = torch.tensor([float(v) for v in tc["point_cloud_range"][:2]],
                           dtype=torch.float32, device=dev)
        cxy = (gtb[..., :2] - low) / step
        sizes = gtb[..., 3:5] / step                 # width, length in cells
        radius = gaussian_radius((sizes[..., 1], sizes[..., 0]),
                                 float(tc.get("gaussian_overlap", 0.1)))
        radius = torch.floor(radius).clamp_min(float(tc.get("min_radius",
                                                            2)))
        ij = torch.floor(cxy).int()
        xi, yi = ij[..., 0], ij[..., 1]
        valid = gt_mask.bool() & (xi >= 0) & (xi < w) & (yi >= 0) & \
            (yi < h) & (sizes > 0).all(-1)
        dims = gtb[..., 3:6]
        if self.norm_bbox:
            dims = torch.log(dims.clamp_min(1e-4))
        rot = gtb[..., 6:7]
        vel = gtb[..., 7:9] if gtb.shape[-1] >= 9 else \
            torch.zeros(gtb.shape[:-1] + (2,), device=dev)
        anno = torch.cat([cxy - ij.float(),
                          (gtb[..., 2] + gtb[..., 5] * 0.5)[..., None], dims,
                          torch.sin(rot), torch.cos(rot), vel], -1)
        ind = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        heatmap = draw_heatmap_gaussian_batch(
            (h, w), cxy, radius, valid, gt_labels, self.task_offsets[-1])
        return heatmap, anno, ind, valid

    # --------------------------------------------------------------- loss
    def loss(self, preds, gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
             gt_mask: torch.Tensor) -> dict:
        """Per task ``task{t}.loss_heatmap`` (gaussian focal, averaged
        over max(positives, 1)) and ``task{t}.loss_bbox`` (L1 on the GT
        cells with ``code_weights``, summed over (GT rows + 1e-4))."""
        preds = preds[0]
        h, w = preds[0]["heatmap"].shape[1:3]
        heatmap, anno, ind, valid = self.get_targets(gt_bboxes, gt_labels,
                                                     gt_mask, (h, w))
        code_weights = torch.tensor(
            [float(v) for v in self.train_cfg.get("code_weights",
                                                  [1.0] * 10)],
            device=anno.device)
        offs = self.task_offsets
        losses = {}
        for t, pred in enumerate(preds):
            heat_t = heatmap[..., offs[t]:offs[t + 1]]
            num_pos = (heat_t == 1.0).float().sum()
            losses[f"task{t}.loss_heatmap"] = self.loss_cls(
                clip_sigmoid(pred["heatmap"]), heat_t,
                avg_factor=num_pos.clamp_min(1.0))
            keys = ["reg", "height", "dim", "rot"] + \
                (["vel"] if "vel" in pred else [])
            anno_pred = torch.cat([pred[k] for k in keys], -1)
            b, code = anno_pred.shape[0], anno_pred.shape[-1]
            gathered = torch.gather(anno_pred.reshape(b, h * w, code), 1,
                                    ind[..., None].expand(-1, -1, code))
            mask_t = valid & (gt_labels >= offs[t]) & \
                (gt_labels < offs[t + 1])
            weights = mask_t[..., None].float() * code_weights[:code]
            losses[f"task{t}.loss_bbox"] = self.loss_bbox(
                gathered, anno[..., :code], weight=weights,
                reduction="none").sum() / (mask_t.float().sum() + 1e-4)
        return losses

    # ---------------------------------------------------------- inference
    def _circle_thresholds(self, b: int, device) -> torch.Tensor:
        """(B * T,) float32 ``min_radius`` of every (sample, task) set."""
        key = (b, torch.device(device))
        thr = self._nms_thresholds.get(key)
        if thr is None:
            thr = self.nms_min_radius.to(device, torch.float32).repeat(b)
            self._nms_thresholds[key] = thr
        return thr

    def get_bboxes(self, preds) -> dict:
        """Per task: decode the top ``max_num`` cells, circle NMS (every
        sample and task in one launch, each task with its ``min_radius``),
        top ``post_max_size`` of the kept scores; tasks concatenated, z
        shifted to the bottom: dict(bboxes (B, T * post_max_size, 9),
        scores, labels (global class ids), mask = kept & score > 0)."""
        preds = preds[0]
        tc = self.test_cfg
        nt = len(preds)
        post_max = int(tc.get("post_max_size", 83))
        dec = []
        for pred in preds:
            heat = torch.sigmoid(pred["heatmap"])
            dim = torch.exp(pred["dim"]) if self.norm_bbox else pred["dim"]
            vel = pred.get("vel")
            if vel is None:
                vel = torch.zeros(heat.shape[:3] + (2,), device=heat.device)
            dec.append(self.bbox_coder.decode(
                heat, pred["rot"][..., 0:1], pred["rot"][..., 1:2],
                pred["height"], dim, vel, pred["reg"]))
        boxes, scores, labels, valid = (torch.stack([d[k] for d in dec], 1)
                                        for k in ("bboxes", "scores",
                                                  "labels", "mask"))
        b, _, k, code = boxes.shape
        if tc.get("nms_type", "circle") == "circle":
            thr = self._circle_thresholds(b, boxes.device)
            keep = circle_nms_mask(boxes[..., :2].reshape(b * nt, k, 2),
                                   scores.reshape(b * nt, k), thr,
                                   valid.reshape(b * nt, k))
        else:
            keep = nms_bev_mask(boxes[..., [0, 1, 3, 4, 6]].reshape(
                b * nt, k, 5), scores.reshape(b * nt, 1, k),
                float(tc.get("nms_thr", 0.2)), valid.reshape(b * nt, 1, k))
        keep = keep.reshape(b, nt, k)
        scores = torch.where(keep, scores, 0.0)
        topi = topk_stable(scores, post_max)                # (B, T, post)
        topv = torch.gather(scores, 2, topi)
        boxes = torch.gather(boxes, 2, topi[..., None].expand(-1, -1, -1,
                                                              code))
        offs = torch.tensor(self.task_offsets[:-1], device=boxes.device)
        labels = torch.gather(labels, 2, topi) + offs[:, None]
        mask = torch.gather(keep, 2, topi) & (topv > 0)
        boxes = boxes.reshape(b, nt * post_max, code)
        # the decode gives the gravity centre's z; boxes carry the bottom's
        boxes = torch.cat([boxes[..., :2], boxes[..., 2:3] -
                           boxes[..., 5:6] * 0.5, boxes[..., 3:]], -1)
        return dict(bboxes=boxes, scores=topv.reshape(b, -1),
                    labels=labels.reshape(b, -1), mask=mask.reshape(b, -1))
