"""SparseUNet, PartA2's U-shaped sparse backbone (counterpart of
``isfusion_tpu/models/middle_encoders/sparse_unet.py:SparseUNet``;
reference ``mmdet3d/models/middle_encoders/sparse_unet.py``).

Encoder: conv_input (SubM) -> stages of conv modules (in every stage but
the first, block 0 is a stride-2 SparseConv3d with the stage's padding,
the other blocks SubM convs on that stage's rulebook), each stage's site
table and rulebook kept -> conv_out (kernel (3, 1, 1), stride (2, 1, 1))
-> the dense BEV ``spatial_features`` (B, ny, nx, D * C), channel z*C + c.

Decoder, as the JAX module (not the reference's lateral / merge /
upsample layers, ROADMAP queue 3): at level i, with the skip source the
encoder table i + 1 levels down, ``decoder_conv{i}`` (SubM, on the
rulebook of the table it starts from), then ``decoder_up{i}`` (a sparse
inverse conv, kernel 3, stride 2, padding 1, onto the skip source's saved
sites) where the grids differ or ``decoder_same{i}`` (SubM) where they
match, then the concat with the skip features and ``decoder_merge{i}``
(SubM). The last level's features at the input voxels are
``seg_features`` (N, C), in the order of the input rows.

Every conv is followed by BN and ReLU, runs on the rulebook engine of
``ops/sparse_conv.py`` (K12 forward and backward; no capacity caps) in
``compute_dtype``, BN statistics over the active sites. The JAX config's
``stage_cap_ratios`` (TPU table sizes) and ``decoder_paddings`` (which the
JAX module never reads) are read and ignored.

Names: ``conv_input.{0,1}``, ``encoder_layers.encoder_layer{i}.{j}.{0,1}``
and ``conv_out.{0,1}`` as the reference's; ``decoder_conv{i}``,
``decoder_up{i}``, ``decoder_same{i}``, ``decoder_merge{i}`` (each
``.{0,1}``) are the JAX module's own names; spconv2 weight layout (out,
kz, ky, kx, in) for every conv, the inverse convs included.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.sparse_conv import (SparseTensor, build_sparse, inverse_rulebook,
                                linear_keys, sparse_conv, subm_rulebook)
from ..layers import BatchNorm, bn_args, resolve_dtype
from .sparse_encoder import (SparseConv3dWeight, SparseConvModule,
                             _EncoderLayers, _pad3, to_dense_bev)


class SparseInverseConvModule(nn.Sequential):
    """Sparse inverse conv (``0``) + BN (``1``) + ReLU onto a saved site
    table (the JAX package's ``_SparseInverseConvModule``)."""

    def __init__(self, cin, cout, kernel_size=(3, 3, 3), stride=2,
                 padding=1, eps=1e-3, momentum=0.01, sync=False):
        super().__init__(SparseConv3dWeight(cin, cout, kernel_size),
                         BatchNorm(cout, eps=eps, momentum=momentum,
                                   sync=sync))
        self.ks, self.stride, self.padding = tuple(kernel_size), stride, \
            padding

    def forward(self, low: SparseTensor, target: SparseTensor
                ) -> SparseTensor:
        rows, found = inverse_rulebook(low, target, self.ks, self.stride,
                                       self.padding)
        x = torch.relu(self[1](sparse_conv(low.feats, rows, found,
                                           self[0].weight)))
        return target._replace(feats=x.to(low.feats.dtype))


def _strided_shape(shape, pad):
    return tuple((shape[d] + 2 * pad[d] - 3) // 2 + 1 for d in range(3))


class SparseUNet(nn.Module):
    """(voxel feats (N, C), coors (N, 4) (b, z, y, x), batch size) ->
    dict(spatial_features (B, ny, nx, D * C_out) NHWC, seg_features (N,
    C_dec)). ``sparse_shape`` is (nz, ny, nx)."""

    def __init__(self, in_channels=4, sparse_shape=(41, 1600, 1408),
                 order=("conv", "norm", "act"), norm_cfg=None,
                 base_channels=16, output_channels=128,
                 encoder_channels=((16,), (32, 32, 32), (64, 64, 64),
                                   (64, 64, 64)),
                 encoder_paddings=((1,), (1, 1, 1), (1, 1, 1),
                                   ((0, 1, 1), 1, 1)),
                 decoder_channels=((64, 64, 64), (64, 64, 32),
                                   (32, 32, 16), (16, 16, 16)),
                 decoder_paddings=None, compute_dtype="float32",
                 stage_cap_ratios=None, **unused):
        super().__init__()
        if tuple(order) != ("conv", "norm", "act"):
            raise NotImplementedError("the port's SparseUNet runs its "
                                      "modules in ('conv', 'norm', 'act') "
                                      "order")
        if len(decoder_channels) != len(encoder_channels):
            raise ValueError("SparseUNet: one decoder level per encoder "
                             "stage")
        bn = bn_args(norm_cfg or dict(type="BN1d", eps=1e-3, momentum=0.01),
                     1e-3, 0.01)
        self.sparse_shape = tuple(int(s) for s in sparse_shape)
        self.cdtype = resolve_dtype(compute_dtype) or torch.float32
        self.conv_input = SparseConvModule(in_channels, base_channels, **bn)
        self.encoder_layers = _EncoderLayers()
        # each table's channels and grid: conv_input's, then each stage's
        widths, grids = [int(base_channels)], [self.sparse_shape]
        in_ch, shape = int(base_channels), self.sparse_shape
        for i, blocks in enumerate(encoder_channels):
            stage = nn.ModuleList()
            for j, out_ch in enumerate(tuple(blocks)):
                pad = _pad3(tuple(encoder_paddings[i])[j])
                if i != 0 and j == 0:
                    stage.append(SparseConvModule(in_ch, out_ch, stride=2,
                                                  padding=pad, subm=False,
                                                  **bn))
                    shape = _strided_shape(shape, pad)
                else:
                    stage.append(SparseConvModule(in_ch, out_ch, **bn))
                in_ch = int(out_ch)
            self.encoder_layers.add_module(f"encoder_layer{i + 1}", stage)
            widths.append(in_ch)
            grids.append(shape)
        self.n_stages = len(encoder_channels)
        self.out_depth = (shape[0] - 3) // 2 + 1
        self.conv_out = SparseConvModule(in_ch, output_channels,
                                         kernel_size=(3, 1, 1),
                                         stride=(2, 1, 1), padding=0,
                                         subm=False, **bn)
        # decoder level i: from table n - i onto its skip source n - 1 - i
        n = self.n_stages
        self.upsample = []
        for i, ch in enumerate(decoder_channels):
            ch = tuple(int(c) for c in ch)
            src = n - 1 - i
            self.add_module(f"decoder_conv{i}",
                            SparseConvModule(in_ch, ch[0], **bn))
            up = grids[src + 1] != grids[src]
            self.upsample.append(up)
            if up:
                self.add_module(f"decoder_up{i}",
                                SparseInverseConvModule(ch[0], ch[1], **bn))
            else:
                self.add_module(f"decoder_same{i}",
                                SparseConvModule(ch[0], ch[1], **bn))
            self.add_module(f"decoder_merge{i}",
                            SparseConvModule(ch[1] + widths[src], ch[-1],
                                             **bn))
            in_ch = ch[-1]
        self.seg_channels = in_ch

    def forward(self, voxel_features: torch.Tensor, coors: torch.Tensor,
                batch_size: int, return_stats: Optional[dict] = None
                ) -> dict:
        """``return_stats`` (a dict, optional) receives the active-site
        count of each encoder table and of conv_out's."""
        order = torch.argsort(linear_keys(coors, self.sparse_shape))
        sp = build_sparse(voxel_features.to(self.cdtype), coors,
                          self.sparse_shape, batch_size)
        rb = subm_rulebook(sp)
        sp, _ = self.conv_input(sp, rb)
        tables, rulebooks = [sp], [rb]
        for i in range(self.n_stages):
            for blk in getattr(self.encoder_layers, f"encoder_layer{i + 1}"):
                if blk.subm:
                    sp, _ = blk(sp, rb)
                else:
                    sp, _ = blk(sp)
                    rb = subm_rulebook(sp)
            tables.append(sp)
            rulebooks.append(rb)
        out, _ = self.conv_out(sp)
        if return_stats is not None:
            return_stats["active_sites"] = [int(t.feats.shape[0])
                                            for t in tables[1:]] + \
                [int(out.feats.shape[0])]
        x, n = sp, self.n_stages
        for i, up in enumerate(self.upsample):
            target, rb = tables[n - 1 - i], rulebooks[n - 1 - i]
            x, _ = getattr(self, f"decoder_conv{i}")(x, rulebooks[n - i])
            if up:
                x = getattr(self, f"decoder_up{i}")(x, target)
            else:
                x, _ = getattr(self, f"decoder_same{i}")(x, rb)
            x = x._replace(feats=torch.cat([x.feats, target.feats], -1))
            x, _ = getattr(self, f"decoder_merge{i}")(x, rb)
        seg = x.feats[torch.argsort(order)]
        return dict(spatial_features=to_dense_bev(out), seg_features=seg)
