"""TransFusionHeadV2, predict path (counterpart of
``isfusion_tpu/models/dense_heads/transfusion_head.py``): shared conv ->
dense class heatmap -> 3x3 max-pool NMS -> top-``num_proposals`` queries
with a class embedding -> transformer decoder layer(s) -> FFN branches ->
NMS-free, score-fused decode.

NHWC BEV input. Heatmap logits, their top-k and the final FFN layers run
in float32; the rest in the config's ``compute_dtype``. Reference names:
``shared_conv``, ``heatmap_head.{0 (conv, bn), 1}``, ``class_encoding``,
``decoder.{i}``, ``prediction_heads.{i}.{task}.{0 (conv, bn), 1}``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ...core.bbox.coders import TransFusionBBoxCoder
from ..layers import BatchNorm, Conv1x1, Conv2d, ConvModule, resolve_dtype
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


class TransFusionHeadV2(nn.Module):
    def __init__(self, num_proposals=128, in_channels=384,
                 hidden_channel=128, num_classes=4, num_decoder_layers=3,
                 num_heads=8, nms_kernel_size=1, ffn_channel=256,
                 activation="relu", common_heads=None, num_heatmap_convs=2,
                 test_cfg=None, bbox_coder=None, compute_dtype=None,
                 **unused):
        super().__init__()
        dt = resolve_dtype(compute_dtype)
        self.cdtype = dt
        self.num_proposals, self.num_classes = num_proposals, num_classes
        self.nms_kernel_size = nms_kernel_size
        self.hidden_channel = hidden_channel
        self.test_cfg = dict(test_cfg or {})
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
                                    activation, dtype=dt)
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
        heat = maxpool_nms(torch.sigmoid(dense_heatmap), self.nms_kernel_size,
                           self._flat_nms_classes())
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
            qpos = res["center"]
            layer_preds.append(res)
        preds = {k: torch.cat([lp[k] for lp in layer_preds], 1)
                 for k in layer_preds[0]}
        preds["dense_heatmap"] = dense_heatmap
        preds["query_heatmap_score"] = torch.gather(
            heat_flat, 1, top_index[..., None].expand(-1, -1, nc))
        preds["query_labels"] = top_class
        return preds

    def get_bboxes(self, preds: dict) -> dict:
        """NMS-free decode of the last layer's proposals -> (B, P) boxes,
        scores (zeroed outside ``post_center_range``), labels, mask."""
        if self.test_cfg.get("nms_type") is not None:
            raise NotImplementedError(
                "the port's predict path is NMS-free (nms_type=None)")
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
        return dict(bboxes=d["bboxes"],
                    scores=torch.where(mask, d["scores"], 0.0),
                    labels=d["labels"], mask=mask)
