"""ISFusionEncoder — hierarchical scene fusion + instance-guided fusion
(counterpart of ``isfusion_tpu/models/middle_encoders/isfusion_encoder.py``).

- Point-to-Grid (P2G): every pillar point is projected into all cameras,
  image features are bilinearly sampled (zeros outside,
  ``align_corners=False``), summed over cameras and over the <= T points
  of the pillar, and scattered to the pillar's BEV cell. This is the JAX
  package's brute all-cameras form; its host-planned partition is a TPU
  workaround and is not ported.
- ``conv_fusion`` over [image BEV, LiDAR BEV]. The port's SparseEncoder
  emits z*C + c channels like the JAX one; they are reordered here to the
  reference's c*D + z so that ``conv_fusion.conv.weight`` keeps the
  reference layout.
- Per level: dense-window SSTv2, then (level 0) instance-guided fusion:
  class heatmap -> 3x3 max-pool NMS (flat classes 8/9 kept for nuScenes)
  -> top-``instance_num`` -> InsContextAtt (deformable attention) ->
  Instane2SceneAtt; then the SECONDV2 stage.

The IGF query positions keep the reference's (row, col) order, so its
deformable sampler reads the MIRRORED location (square BEV) — the
convention converted weights were trained under.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_attn import ms_deform_attn_sample
from ...ops.interpolate import grid_sample
from ...ops.projection import project_points_to_cameras
from ..layers import Conv2d, ConvModule, LayerNorm, Linear, resolve_dtype
from ..sst.sst import SSTv2
from ..transformer import MultiheadAttention, PositionEmbeddingLearned


def topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, ties broken by the
    lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def maxpool_nms(heat: torch.Tensor, kernel: int,
                flat_classes: Tuple[int, ...] = ()) -> torch.Tensor:
    """(B, H, W, C): keep local maxima of a k x k VALID max-pool (border
    cells are never kept), plus every cell of ``flat_classes``."""
    pad = kernel // 2
    pooled = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, stride=1)
    pooled = F.pad(pooled, (pad, pad, pad, pad), value=-float("inf"))
    keep = heat == pooled.permute(0, 2, 3, 1)
    if flat_classes:
        flat = torch.zeros(heat.shape[-1], dtype=torch.bool,
                           device=heat.device)
        flat[list(flat_classes)] = True
        keep = keep | flat
    return heat * keep


def _radial_offset_bias(n_heads: int, n_levels: int, n_points: int
                        ) -> np.ndarray:
    thetas = np.arange(n_heads, dtype=np.float32) * (2 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    """Deformable attention (``fusion_encoder.py:505``); offsets and
    weights in float32 (sampling locations are geometry)."""

    def __init__(self, d_model=256, n_levels=1, n_heads=8, n_points=4,
                 dtype=None):
        super().__init__()
        self.nh, self.nl, self.np = n_heads, n_levels, n_points
        self.value_proj = Linear(d_model, d_model, dtype=dtype)
        self.sampling_offsets = Linear(d_model,
                                       n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model,
                                        n_heads * n_levels * n_points)
        self.output_proj = Linear(d_model, d_model, dtype=dtype)

    def reset_special_parameters(self):
        nn.init.zeros_(self.sampling_offsets.weight)
        self.sampling_offsets.bias.copy_(torch.from_numpy(
            _radial_offset_bias(self.nh, self.nl, self.np)))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)

    def forward(self, query, reference_points, src,
                spatial_shapes: Sequence[Tuple[int, int]]):
        """query (B, Lq, C); reference_points (B, Lq, nl, 2) in [0, 1];
        src (B, sum HW, C)."""
        b, lq, c = query.shape
        nh, nl, npts = self.nh, self.nl, self.np
        value = self.value_proj(src)
        q32 = query.float()
        offsets = self.sampling_offsets(q32).reshape(b, lq, nh, nl, npts, 2)
        attn = torch.softmax(self.attention_weights(q32).reshape(
            b, lq, nh, nl * npts), -1).reshape(b, lq, nh, nl, npts)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        loc = reference_points[:, :, None, :, None, :] + \
            offsets / normalizer[None, None, None, :, None, :]
        starts = np.cumsum([0] + [h * w for h, w in spatial_shapes])
        val = value.reshape(b, -1, nh, c // nh)
        outs = []
        for i in range(b):
            maps = [val[i, starts[j]:starts[j + 1]].reshape(h, w, nh, -1)
                    for j, (h, w) in enumerate(spatial_shapes)]
            outs.append(ms_deform_attn_sample(maps, loc[i],
                                              attn[i].to(value.dtype)))
        return self.output_proj(torch.stack(outs).to(value.dtype))


class DeformableDecoderLayer(nn.Module):
    """Self-attn + deformable cross-attn + FFN, post-norm
    (``DeformableTransformerDecoderLayer:602``)."""

    def __init__(self, d_model, d_ffn, n_heads=8, n_points=4, n_levels=1,
                 dtype=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                       dtype=dtype)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Linear(d_model, d_ffn, dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, dtype=dtype)
        self.norm3 = LayerNorm(d_model, dtype=dtype)

    def forward(self, tgt, query_pos_embed, reference_points, src,
                spatial_shapes):
        q = tgt + query_pos_embed
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm1(tgt + self.cross_attn(
            tgt + query_pos_embed, reference_points, src, spatial_shapes))
        ff = self.linear2(torch.relu(self.linear1(tgt)))
        return self.norm3(tgt + ff)


class InsContextAtt(nn.Module):
    """Instance context via deformable attention over the scene BEV
    (``InsContextAtt:768``)."""

    def __init__(self, num_layers=2, embed_dims=128, bev_size=180,
                 n_points=16, dtype=None):
        super().__init__()
        self.bev_size = bev_size
        self.key_pos_embed = PositionEmbeddingLearned(2, embed_dims,
                                                      dtype=dtype)
        self.query_pos_embed = PositionEmbeddingLearned(2, embed_dims,
                                                        dtype=dtype)
        self.layers = nn.ModuleList(
            DeformableDecoderLayer(embed_dims, embed_dims, n_points=n_points,
                                   dtype=dtype) for _ in range(num_layers))

    def forward(self, x_ins, query_pos, scene):
        """x_ins (B, N, C); query_pos (B, N, 2) (row, col) grid coords;
        scene (B, H, W, C). Returns (B, N, C)."""
        b, h, w, c = scene.shape
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        bev_pos = torch.from_numpy(
            (np.stack([gy + 0.5, gx + 0.5], -1).reshape(1, h * w, 2)
             / float(self.bev_size)).astype(np.float32)).to(scene.device)
        key_pos = self.key_pos_embed(bev_pos.expand(b, -1, -1))
        ref = query_pos / float(self.bev_size)
        qpe = self.query_pos_embed(ref)
        src = scene.reshape(b, h * w, c) + key_pos
        out = x_ins
        for layer in self.layers:
            out = layer(out, qpe, ref[:, :, None], src, [(h, w)])
        return out


class Instane2SceneAtt(nn.Module):
    """Scene tokens attend to instances, then per-channel spatial attention
    mixes the instance-aware map back (``Instane2SceneAtt:472``; name as
    the reference spells it)."""

    def __init__(self, d_model, nhead=8, dtype=None):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, nhead, dtype=dtype)
        self.norm = LayerNorm(d_model, dtype=dtype)

    def forward(self, scene_tokens, x_ins, query_scene):
        """scene_tokens (B, HW, C); x_ins (B, N, C); query_scene
        (B, H, W, C). Returns (B, H, W, C)."""
        b, hw, c = scene_tokens.shape
        h, w = query_scene.shape[1:3]
        attn = self.multihead_attn(scene_tokens, x_ins, x_ins)
        q_ins = self.norm(scene_tokens + attn).reshape(b, h, w, c)
        aw = torch.einsum("biwc,bjwc->bcij", query_scene.float(),
                          q_ins.float())
        aw = torch.softmax(aw, -1)
        att = torch.einsum("bcij,bjwc->biwc", aw, q_ins.float())
        return query_scene + att.to(query_scene.dtype)


class ISFusionEncoder(nn.Module):
    def __init__(self, num_points_in_pillar=12, embed_dims=256,
                 num_classes=10, bev_size=180, num_views=6,
                 region_shape=((6, 6, 1), (6, 6, 1)),
                 grid_size=((180, 180, 1), (90, 90, 1)),
                 region_drop_info=None, instance_num=200, nms_kernel_size=3,
                 img_level=1, compute_dtype=None, img_channels=None,
                 lidar_channels=None, lidar_depth=2, **unused):
        super().__init__()
        emb, half = embed_dims, embed_dims // 2
        dt = resolve_dtype(compute_dtype)
        self.cdtype = dt
        self.embed_dims, self.num_classes = emb, num_classes
        self.bev_size, self.num_views = bev_size, num_views
        self.instance_num, self.nms_kernel_size = instance_num, \
            nms_kernel_size
        self.img_level = img_level
        self.lidar_depth = int(lidar_depth)
        self.region_shape = [tuple(r) for r in region_shape]
        if region_drop_info is not None:
            for lvl, (info, shape) in enumerate(zip(region_drop_info,
                                                    self.region_shape)):
                full = int(np.prod(shape))
                if min(int(d["max_tokens"]) for d in dict(info).values()) \
                        < full:
                    raise ValueError(
                        f"region_drop_info level {lvl} asks for token drop; "
                        "the dense window path is exact only for full "
                        "regions")
        bn = dict(type="BN2d")
        cin = int(img_channels) + int(lidar_channels)
        self.conv_fusion = ConvModule(cin, half, 3, padding=1, norm_cfg=bn,
                                      dtype=dt)
        self.grid2region_att = nn.ModuleList(
            SSTv2(d_model=[half * (lvl + 1)] * 4, nhead=[8] * 4,
                  num_blocks=1, dim_feedforward=[half * (lvl + 1)] * 4,
                  window_shape=self.region_shape[lvl],
                  in_channel=half if lvl == 0 else None,
                  compute_dtype=compute_dtype)
            for lvl in range(len(self.region_shape)))
        self.conv_heatmap = ConvModule(half, half, 3, padding=1, norm_cfg=bn,
                                       dtype=dt)
        self.heatmap_head_1 = ConvModule(half, emb // 4, 3, padding=1,
                                         norm_cfg=bn, dtype=dt)
        self.heatmap_head_2 = ConvModule(emb // 4, emb // 4, 3, padding=1,
                                         norm_cfg=bn, dtype=dt)
        self.heatmap_head_3 = Conv2d(emb // 4, num_classes, 3, padding=1)
        self.conv_scene = ConvModule(half, half, 3, padding=1, norm_cfg=bn,
                                     dtype=dt)
        self.instance_att = InsContextAtt(2, half, bev_size, 16, dtype=dt)
        self.conv_ins = ConvModule(half, half, 3, padding=1, norm_cfg=bn,
                                   dtype=dt)
        self.instance_to_scene_att = Instane2SceneAtt(half, dtype=dt)

    def reset_special_parameters(self):
        nn.init.constant_(self.heatmap_head_3.bias, -2.19)

    # ------------------------------------------------------ point-to-grid
    def img_to_bev(self, img_feat, pillars, pillar_coors, num_points,
                   calib) -> torch.Tensor:
        """img_feat (B, Nv, h, w, C) one FPN level; pillars (Np, T, >=3);
        pillar_coors (Np, 4) (b, z, y, x); num_points (Np,) ->
        (B, bev, bev, C)."""
        b, nv = img_feat.shape[:2]
        t = pillars.shape[1]
        c = img_feat.shape[-1]
        bevsz = self.bev_size
        img_h, img_w = calib["img_input_shape"]
        canvas = torch.zeros((b, bevsz * bevsz, c), dtype=img_feat.dtype,
                             device=img_feat.device)
        for i in range(b):
            sel = pillar_coors[:, 0] == i
            pts, coors, npts = pillars[sel], pillar_coors[sel], \
                num_points[sel]
            xyz = pts[..., :3].reshape(-1, 3)
            img_aug = calib.get("img_aug_matrix")
            lidar_aug = calib.get("lidar_aug_matrix")
            uv, _, front = project_points_to_cameras(
                xyz, calib["lidar2img"][i],
                None if lidar_aug is None else lidar_aug[i],
                None if img_aug is None else img_aug[i])
            gx = uv[..., 0] / img_w * 2 - 1
            gy = uv[..., 1] / img_h * 2 - 1
            valid = front & (gx > -1) & (gx < 1) & (gy > -1) & (gy < 1)
            grid = torch.stack([gx, gy], -1)
            acc = torch.zeros((xyz.shape[0], c), dtype=img_feat.dtype,
                              device=img_feat.device)
            for cam in range(nv):
                s = grid_sample(img_feat[i, cam].float(), grid[cam])
                acc = acc + (s * valid[cam, :, None]).to(acc.dtype)
            tmask = torch.arange(t, device=pts.device)[None] < npts[:, None]
            pillar_feat = (acc.reshape(-1, t, c) * tmask[..., None]).sum(1)
            idx = coors[:, 2].long() * bevsz + coors[:, 3].long()
            canvas[i, idx] = pillar_feat.to(canvas.dtype)
        return canvas.reshape(b, bevsz, bevsz, c)

    def _lidar_to_reference_channels(self, lidar):
        """z*C + c -> c*D + z channel order (reference ``.dense()``)."""
        b, h, w, zc = lidar.shape
        d = self.lidar_depth
        return lidar.reshape(b, h, w, d, zc // d).transpose(3, 4).reshape(
            b, h, w, zc)

    def forward(self, img_feats, lidar_feats, pillars, pillar_coors,
                pillar_num_points, calib, pts_backbone):
        dt = self.cdtype
        img_lvl = img_feats[self.img_level]
        if dt is not None:
            img_lvl, lidar_feats = img_lvl.to(dt), lidar_feats.to(dt)
        img_bev = self.img_to_bev(img_lvl, pillars, pillar_coors,
                                  pillar_num_points, calib)
        bev = self.conv_fusion(torch.cat(
            [img_bev, self._lidar_to_reference_channels(lidar_feats)], -1))
        b, h, w, _ = bev.shape
        half = self.embed_dims // 2
        x = bev
        return_feats = []
        ins_heatmap = None
        n_levels = len(self.region_shape)
        for lvl in range(n_levels):
            x = self.grid2region_att[lvl](x)
            if lvl == 0:
                hm = self.heatmap_head_2(self.heatmap_head_1(
                    self.conv_heatmap(bev)))
                # heatmap logits and top-k in float32 (score ordering)
                ins_heatmap = self.heatmap_head_3(hm.float())
                heat = maxpool_nms(
                    torch.sigmoid(ins_heatmap), self.nms_kernel_size,
                    (8, 9) if self.num_views == 6 and
                    self.num_classes >= 10 else ())
                flat = heat.reshape(b, h * w, -1).transpose(1, 2).reshape(
                    b, -1)
                top = topk_stable(flat, self.instance_num)
                top_index = top % (h * w)
                ys = (top_index // w).float() + 0.5
                xs = (top_index % w).float() + 0.5
                query_pos = torch.stack([ys, xs], -1)   # (row, col)
                x_scene = self.conv_scene(bev)
                x_ins = torch.gather(
                    x_scene.reshape(b, h * w, half), 1,
                    top_index[..., None].expand(-1, -1, half))
                x_ins = self.instance_att(x_ins, query_pos, x_scene)
                scene_tokens = self.conv_ins(bev).reshape(b, h * w, half)
                x = self.instance_to_scene_att(scene_tokens, x_ins, x)
            if lvl < n_levels - 1:
                feat, x = pts_backbone(x, stage=f"stage{lvl + 1}")
            else:
                feat = pts_backbone(x, stage=f"stage{lvl + 1}")
            return_feats.append(feat)
        return return_feats, ins_heatmap
