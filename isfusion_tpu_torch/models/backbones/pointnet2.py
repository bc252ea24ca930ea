"""PointNet++ set abstraction and feature propagation (counterpart of
``isfusion_tpu/models/backbones/pointnet2.py``; reference mmdet3d
``pointnet2_sa_ssg.py`` and ``ops/pointnet_modules``).

Points are padded (B, N, C) buffers with a (B, N) validity mask, as in the
JAX package. A set-abstraction level samples S points by K14-FPS, groups
each one's ball (K14-ball, K14-gather) and runs a shared MLP over the
grouped rows (1x1 conv + BN over the valid rows + ReLU, then the padded
rows zeroed), then max- or average-pools each ball over its valid
members. Feature propagation interpolates the coarser level's features at
the finer level's points from their 3 nearest neighbours (K14-NN,
inverse-distance weights, K14-gather) and runs a shared MLP.

The MLP layers keep the reference's names and shapes (``SA_modules.{i}.
mlps.{scale}.layer{j}.conv`` a (out, in, 1, 1) Conv2d weight, ``.bn`` a
BN2d; ``FP_modules.{i}.mlps.layer{j}``). Their input widths follow the
reference (the previous level's features, plus 3 with ``use_xyz``); the
JAX package's ``nn.Dense`` infers them. ``in_channels`` counts the point
channels, xyz included, as in the reference (the JAX package ignores it).

A max pool's gradient goes in equal parts to the tied maxima (``amax``,
as ``jnp.max``): a ball with fewer than K points repeats its first one.
``normalize_xyz`` is read from ``sa_cfg`` (default False), as the JAX
package reads it. An ``sa_cfg`` whose type names PAConv (``PAConvSASSG``)
runs a stack of ``ops/paconv.py:PAConv`` layers (``mlps.{scale}.layer{j}``,
``num_kernels`` from ``sa_cfg``, default 8) on each ball's grouped
features and ``grouped_xyz`` in place of the shared MLP; it groups by the
ball query, as the JAX package does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.pointnet_ops import (ball_query, furthest_point_sample,
                                 gather_points, group_points,
                                 interpolation_weights, three_interpolate,
                                 three_nn)
from ...ops.paconv import PAConv
from ..layers import MaskedBatchNorm


class PointConv(nn.Module):
    """One shared-MLP layer over (..., C) point rows: a bias-free 1x1 conv
    (``conv``: a Conv1d (out, in, 1) or Conv2d (out, in, 1, 1) weight, the
    reference's shape), a ``MaskedBatchNorm`` (``bn``: eps 1e-5, momentum
    0.1; statistics over the valid rows) and a ReLU."""

    def __init__(self, in_channels: int, out_channels: int, ndim: int = 2):
        super().__init__()
        conv = nn.Conv2d if ndim == 2 else nn.Conv1d
        self.conv = conv(in_channels, out_channels, 1, bias=False)
        self.bn = MaskedBatchNorm(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, x, mask):
        w = self.conv.weight.reshape(self.conv.out_channels, -1)
        return torch.relu(self.bn(F.linear(x, w), mask))


class SharedMLP(nn.Module):
    """``layer{i}`` PointConvs, then the padded rows zeroed (the JAX
    package's ``_SharedMLP``)."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 ndim: int = 2, prefix: str = "layer"):
        super().__init__()
        self.names = []
        for i, c in enumerate(channels):
            self.names.append(f"{prefix}{i}")
            self.add_module(self.names[-1], PointConv(in_channels, int(c),
                                                      ndim))
            in_channels = int(c)

    def forward(self, x, mask):
        for name in self.names:
            x = getattr(self, name)(x, mask)
        return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class PAConvMLP(nn.Module):
    """``layer{j}`` PAConv layers (the reference's ``PAConvSAModule`` mlp):
    ``forward(g (B, S, K, C), grouped_xyz (B, S, K, 3), valid)``."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 num_kernels: int):
        super().__init__()
        self.names = []
        for j, c in enumerate(channels):
            self.names.append(f"layer{j}")
            self.add_module(self.names[-1], PAConv(in_channels, int(c),
                                                   num_kernels=num_kernels))
            in_channels = int(c)

    def forward(self, g, grouped_xyz, valid):
        for name in self.names:
            g = getattr(self, name)(g, grouped_xyz, valid)
        return g


class PointSAModule(nn.Module):
    """Single- or multi-scale set abstraction: ``forward(xyz (B, N, 3),
    feats (B, N, C) or None, mask (B, N))`` -> (new_xyz (B, S, 3),
    new_feats (B, S, C'), indices (B, S) int32, new_mask (B, S)).
    ``sa_type='paconv'``: PAConv layers of ``num_kernels`` kernels in
    place of the shared MLP."""

    def __init__(self, num_point: int, radii: Sequence[float],
                 sample_nums: Sequence[int], mlp_channels,
                 in_channels: int, use_xyz: bool = True,
                 pool_mod: str = "max", normalize_xyz: bool = False,
                 sa_type: str = "mlp", num_kernels: int = 8):
        super().__init__()
        if sa_type not in ("mlp", "paconv"):
            raise ValueError(f"sa_type {sa_type!r}")
        if pool_mod not in ("max", "avg"):
            raise ValueError(f"pool_mod {pool_mod!r}")
        mlps = mlp_channels
        if not isinstance(mlps[0], (list, tuple)):
            mlps = [mlps]
        self.num_point = int(num_point)
        self.radii = [float(r) for r in radii]
        self.sample_nums = [int(k) for k in sample_nums]
        self.use_xyz, self.pool_mod = bool(use_xyz), pool_mod
        self.normalize_xyz = bool(normalize_xyz)
        cin = int(in_channels) + (3 if use_xyz else 0)
        self.paconv = sa_type == "paconv"
        self.mlps = nn.ModuleList(
            PAConvMLP(cin, ch, int(num_kernels)) if self.paconv
            else SharedMLP(cin, ch) for ch in mlps)

    def forward(self, xyz, feats, mask):
        idx = furthest_point_sample(xyz, self.num_point, mask)      # (B, S)
        new_xyz = gather_points(xyz, idx)
        new_mask = torch.gather(mask, 1, idx.long())
        outs = []
        for radius, k, mlp in zip(self.radii, self.sample_nums, self.mlps):
            gi, gv = ball_query(radius, k, xyz, new_xyz, mask)
            grouped_xyz = group_points(xyz, gi) - new_xyz[:, :, None, :]
            if self.normalize_xyz:
                grouped_xyz = grouped_xyz / radius
            parts = [grouped_xyz] if self.use_xyz else []
            if feats is not None:
                parts.append(group_points(feats, gi))
            g = torch.cat(parts, -1)                            # (B, S, K, C)
            valid = gv & new_mask[:, :, None]
            g = mlp(g, grouped_xyz, valid) if self.paconv else mlp(g, valid)
            if self.pool_mod == "max":
                g = g.masked_fill(~valid[..., None], float("-inf")).amax(2)
                g = torch.where(torch.isfinite(g), g, torch.zeros(
                    (), dtype=g.dtype, device=g.device))
            else:
                cnt = valid.sum(-1).clamp_min(1)[..., None]
                g = torch.where(valid[..., None], g, torch.zeros(
                    (), dtype=g.dtype, device=g.device)).sum(2) / cnt
            outs.append(g)
        return new_xyz, torch.cat(outs, -1), idx, new_mask


class PointFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation of the
    source features at the target points, the target features before them,
    then the shared MLP (``mlps.layer{i}``)."""

    def __init__(self, in_channels: int, mlp_channels: Sequence[int]):
        super().__init__()
        self.mlps = SharedMLP(in_channels, mlp_channels)

    def forward(self, target_xyz, target_feats, source_xyz, source_feats,
                target_mask, source_mask):
        d, idx = three_nn(target_xyz, source_xyz, source_mask)
        up = three_interpolate(source_feats, idx, interpolation_weights(d))
        if target_feats is not None:
            up = torch.cat([target_feats, up], -1)
        return self.mlps(up, target_mask)


class PointNet2SASSG(nn.Module):
    """Single-scale-grouping PointNet++ (``pointnet2_sa_ssg.py``):
    ``forward(points (B, N, 3 + C), points_mask (B, N))`` -> dict of the SA
    and FP pyramids (``sa_xyz``, ``sa_features``, ``sa_masks``, ``fp_xyz``,
    ``fp_features``, ``fp_masks``) and ``fp_indices``, the last FP level's
    points' indices in the input cloud (the heads read ``fp_*[-1]``).
    ``sa_channels_out`` holds the widths of ``sa_features`` (the input's
    features first; a segmentation head takes them)."""

    def __init__(self, in_channels: int = 4,
                 num_points: Sequence[int] = (2048, 1024, 512, 256),
                 radius: Sequence[float] = (0.2, 0.4, 0.8, 1.2),
                 num_samples: Sequence[int] = (64, 32, 16, 16),
                 sa_channels=((64, 64, 128), (128, 128, 256),
                              (128, 128, 256), (128, 128, 256)),
                 fp_channels=((256, 256), (256, 256)),
                 norm_cfg: Optional[dict] = None,
                 sa_cfg: Optional[dict] = None, **unused):
        super().__init__()
        sa_cfg = dict(sa_cfg or {})
        sa_type = "paconv" if "PAConv" in str(sa_cfg.get("type", "")) \
            else "mlp"
        self.SA_modules = nn.ModuleList()
        channels = [int(in_channels) - 3]
        for i in range(len(num_points)):
            self.SA_modules.append(PointSAModule(
                num_point=num_points[i], radii=[radius[i]],
                sample_nums=[num_samples[i]],
                mlp_channels=list(sa_channels[i]), in_channels=channels[-1],
                use_xyz=bool(sa_cfg.get("use_xyz", True)),
                pool_mod=sa_cfg.get("pool_mod", "max"),
                normalize_xyz=bool(sa_cfg.get("normalize_xyz", False)),
                sa_type=sa_type,
                num_kernels=int(sa_cfg.get("num_kernels", 8))))
            channels.append(int(sa_channels[i][-1]))
        self.sa_channels_out = list(channels)
        self.FP_modules = nn.ModuleList()
        source = channels[-1]
        for i, ch in enumerate(fp_channels):
            target = channels[len(channels) - i - 2]
            self.FP_modules.append(PointFPModule(source + target, list(ch)))
            source = int(ch[-1])
        self.out_channels = source          # the heads' seed features

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor
                ) -> dict:
        xyz = points[..., :3].contiguous()
        feats = points[..., 3:].contiguous() if points.shape[-1] > 3 \
            else None
        sa_xyz, sa_feats, sa_masks, sa_inds = [xyz], [feats], \
            [points_mask], [None]
        for sa in self.SA_modules:
            nx, nf, idx, nm = sa(sa_xyz[-1], sa_feats[-1], sa_masks[-1])
            sa_xyz.append(nx)
            sa_feats.append(nf)
            sa_masks.append(nm)
            sa_inds.append(idx)
        fp_xyz, fp_feats, fp_masks = [sa_xyz[-1]], [sa_feats[-1]], \
            [sa_masks[-1]]
        n_sa = len(sa_xyz)
        for i, fp in enumerate(self.FP_modules):
            t = n_sa - i - 2
            fp_feats.append(fp(sa_xyz[t], sa_feats[t], fp_xyz[-1],
                               fp_feats[-1], sa_masks[t], fp_masks[-1]))
            fp_xyz.append(sa_xyz[t])
            fp_masks.append(sa_masks[t])
        tgt = n_sa - len(self.FP_modules) - 1
        fp_indices = sa_inds[1].long()
        for i in range(2, tgt + 1):
            fp_indices = torch.gather(fp_indices, 1, sa_inds[i].long())
        return dict(sa_xyz=sa_xyz, sa_features=sa_feats, sa_masks=sa_masks,
                    fp_xyz=fp_xyz, fp_features=fp_feats, fp_masks=fp_masks,
                    fp_indices=fp_indices)


def PAConvSASSG(**kwargs) -> PointNet2SASSG:
    """PointNet2SASSG with PAConv set abstraction (the reference's
    ``sa_cfg=dict(type='PAConvSAModule')`` composition for scene
    segmentation; the JAX package's ``PAConvSASSG``)."""
    kwargs.setdefault("sa_cfg", dict(type="PAConvSAModule"))
    return PointNet2SASSG(**kwargs)
