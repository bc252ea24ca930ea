"""Sparse-token SST: window partition with token drop on sparse voxels
(counterpart of ``isfusion_tpu/models/sst/sst_sparse.py``:
``SSTInputLayerV2``, ``_BucketAttention``, ``SSTv2Sparse``).

SST as a standalone LiDAR backbone over sparse voxels (the dense path of
``sst.py`` covers IS-Fusion's always-full 6 x 6 windows). Each shift
variant partitions the voxels into windows (K17-part,
``ops/sst_window.py:sst_partition``): a window's drop level follows its
voxel count through ``drop_info``, a voxel past its level's
``max_tokens`` drops, and each level's windows sit in fixed-size buckets
(B, cap_l, T_l, C). Each encoder layer moves the voxel rows into the
buckets (K17-move op 0), attends within every level's windows with one
set of weights (the port's ``SSTEncoderLayer``: window attention, FFN,
post-norm; q = k = tokens + in-window position embedding, v = tokens) and
moves the tokens back (op 1); the canvas takes the drop survivors' rows
(op 2). As the reference's ``drop_voxel``, a voxel dropped by either
shift's budget is removed before the final partitions (a no-shift pass,
then a shift pass on its survivors) and never reaches the canvas.

Inputs as the JAX package's: (B, V, C) voxel features, (B, V, 3) zyx int
coordinates (unique within a sample, inside ``sparse_shape``) and a (B, V)
mask; the output is the channels-last (B, ny, nx, d_model) canvas.
Reference names as the port's SSTv2: ``linear0``, ``block_list.{b}.
encoder_list.{l}.{win_attn.self_attn, norm1, norm2, linear1, linear2}``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.sst_window import (WindowPartition, flat_to_canvas,
                               flat_to_window, norm_drop_info, sst_partition,
                               window_geometry, window_to_flat)
from ..layers import Linear
from .sst import SSTEncoderLayer, _Block, sst_window_pos_embed

DEFAULT_DROP_INFO = ({"max_tokens": 36, "drop_range": (0, 100000)},)


class SSTInputLayerV2(nn.Module):
    """Regional grouping (``sst_input_layer_v2.py:18``), no parameters:
    ``forward(coords, valid)`` -> ([no-shift, shift] partitions of the drop
    survivors, their (B, V) mask ``eff``). Survivors: valid, kept by the
    no-shift partition, and kept by the shift partition of those.
    ``shuffle_voxels`` is a host-side option kept for configs, as in the
    JAX package."""

    def __init__(self, drop_info=DEFAULT_DROP_INFO, window_shape=(6, 6, 1),
                 sparse_shape=(400, 400, 1), shuffle_voxels: bool = False,
                 win_caps: Optional[Sequence[int]] = None):
        super().__init__()
        self.drop_info = norm_drop_info(drop_info)
        self.window_shape = tuple(int(w) for w in window_shape)
        self.sparse_shape = tuple(int(s) for s in sparse_shape)
        self.shuffle_voxels = shuffle_voxels
        self.win_caps = None if win_caps is None else \
            [int(c) for c in win_caps]

    def partition(self, coords, valid, do_shift: bool) -> WindowPartition:
        return sst_partition(coords, valid, self.sparse_shape,
                             self.window_shape, self.drop_info,
                             self.win_caps, do_shift)

    def forward(self, coords: torch.Tensor, valid: torch.Tensor
                ) -> Tuple[List[WindowPartition], torch.Tensor]:
        coords, valid = coords.to(torch.int32), valid.bool()
        k0 = self.partition(coords, valid, False).keep
        k1 = self.partition(coords, valid & k0, True).keep
        eff = valid & k0 & k1
        return [self.partition(coords, eff, s) for s in (False, True)], eff


class SSTv2Sparse(nn.Module):
    """Standalone sparse-voxel SST backbone (``sst_v2.py:12`` over the
    sparse input layer): (B, V, C) voxel rows + (B, V, 3) zyx + (B, V)
    mask -> (B, ny, nx, d_model) (``recover_bev:97``). ``num_blocks`` x
    (no-shift, shift) layers, each shared by every drop level's buckets;
    ``in_channel`` adds the input projection ``linear0``."""

    def __init__(self, d_model: int = 128, nhead: int = 8,
                 num_blocks: int = 1, dim_feedforward: int = 256,
                 window_shape=(6, 6, 1), sparse_shape=(64, 64, 1),
                 drop_info=DEFAULT_DROP_INFO,
                 win_caps: Optional[Sequence[int]] = None,
                 in_channel: Optional[int] = None, dropout: float = 0.0,
                 layer_cfg=None):
        super().__init__()
        self.input_layer = SSTInputLayerV2(drop_info, window_shape,
                                           sparse_shape, win_caps=win_caps)
        (wx, wy, _), _ = window_geometry(sparse_shape, window_shape)
        self.linear0 = Linear(in_channel, d_model) \
            if in_channel is not None else None
        self.block_list = nn.ModuleList(_Block(
            [SSTEncoderLayer(d_model, nhead, dim_feedforward, wx, shift,
                             dropout=dropout, layer_cfg=layer_cfg)
             for shift in (False, True)]) for _ in range(num_blocks))
        self.wx = wx
        # each token's in-window embedding: row y * wx + x
        self.register_buffer("pos", torch.from_numpy(sst_window_pos_embed(
            (wx, wy), d_model)), persistent=False)

    def position_buckets(self, part: WindowPartition, dtype
                         ) -> List[torch.Tensor]:
        """Each level's (B, cap_l, T_l, d_model) embeddings of its tokens'
        in-window (y, x), zeros where no token sits."""
        idx = (part.inner[..., 1] * self.wx + part.inner[..., 2]).clamp(
            0, self.pos.shape[0] - 1)
        return flat_to_window(self.pos.to(dtype)[idx.long()], part)

    def forward(self, feats: torch.Tensor, coords: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        if self.linear0 is not None:
            feats = self.linear0(feats)
        parts, _ = self.input_layer(coords, valid)
        pos = [self.position_buckets(p, feats.dtype) for p in parts]
        token_valid = [[p.token_valid(l) for l in range(len(p.levels))]
                       for p in parts]
        x = feats
        for blk in self.block_list:
            for li, layer in enumerate(blk.encoder_list):
                part = parts[li]
                updated = []
                for tok, pb, tv in zip(flat_to_window(x, part), pos[li],
                                       token_valid[li]):
                    b, cap, t, c = tok.shape
                    updated.append(layer.encode(
                        tok.reshape(b * cap, t, c),
                        (tok + pb).reshape(b * cap, t, c),
                        tv.reshape(b * cap, t)).view(b, cap, t, c))
                x = window_to_flat(updated, part, x)
        return flat_to_canvas(x, parts[0])
