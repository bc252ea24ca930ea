"""SECOND-style sparse 3D conv encoder (counterpart of
``isfusion_tpu/models/middle_encoders/sparse_encoder.py:SparseEncoder``).

conv_input (SubM) -> encoder stages (basicblock layout: residual
SparseBasicBlocks, each non-final stage closed by a stride-2
SparseConv3d) -> conv_out (kernel (3,1,1), stride (2,1,1)) -> dense BEV
(B, ny, nx, Z*C) with channel order z*C + c.

Runs on the rulebook engine of ``ops/sparse_conv.py`` (spconv
semantics, no capacity caps); its backward is built from the K12 gather.
Train-mode BatchNorm takes its statistics over the active sites only —
the rows of the site table — as the JAX package's ``zmask`` does. The
JAX config's capacity keys (``stage_cap_ratios``, ``dilation_ratio(s)``,
``subm_dilation_ratios``, ``dense_from_stage``, ``engine``,
``z_pad_to``) size TPU tables and are read and ignored. ``z_windows`` is semantics: its first entry (z_lo,
width) keeps voxels with z in [z_lo, z_lo + width) and drops the rest. The
later windows are exact strided images of the first (the JAX package
checks it at trace time, ``check_window_coverage``), so they drop nothing
and need no code here.

Reference names: ``conv_input.{0,1}``,
``encoder_layers.encoder_layer{i}.{j}.{conv1,bn1,conv2,bn2}`` (blocks) or
``.{0,1}`` (strided convs), ``conv_out.{0,1}``; spconv2 weight layout
(out, kz, ky, kx, in).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.sparse_conv import (SparseTensor, build_sparse, sparse_conv,
                                strided_rulebook, subm_rulebook)
from ..layers import BatchNorm, norm_eps, norm_momentum, resolve_dtype


def _pad3(p) -> Tuple[int, int, int]:
    return tuple(int(v) for v in p) if isinstance(p, (tuple, list)) \
        else (int(p),) * 3


class SparseConv3dWeight(nn.Module):
    """Holds one spconv weight (out, kz, ky, kx, in); no bias."""

    def __init__(self, cin, cout, kernel_size=(3, 3, 3)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, *kernel_size, cin))


class SparseConvModule(nn.Sequential):
    """conv (``0``) + BN (``1``) (+ReLU) on a site table; a SubM conv keeps
    the sites, a strided one makes new ones."""

    def __init__(self, cin, cout, kernel_size=(3, 3, 3), stride=1,
                 padding=1, subm=True, eps=1e-3, momentum=0.01,
                 with_act=True):
        super().__init__(SparseConv3dWeight(cin, cout, kernel_size),
                         BatchNorm(cout, eps=eps, momentum=momentum))
        self.ks, self.stride, self.padding = tuple(kernel_size), stride, \
            padding
        self.subm, self.with_act = subm, with_act

    def forward(self, sp: SparseTensor, rulebook=None
                ) -> Tuple[SparseTensor, Any]:
        if self.subm:
            out_sp = sp
        else:
            out_sp, *rulebook = strided_rulebook(sp, self.ks, self.stride,
                                                 self.padding)
        x = self[1](sparse_conv(sp.feats, *rulebook, self[0].weight))
        if self.with_act:
            x = torch.relu(x)
        return out_sp._replace(feats=x.to(sp.feats.dtype)), rulebook


class SparseBasicBlock(nn.Module):
    """Residual pair of SubM convs (``ops/sparse_block.py:199``). With
    in != out channels a SubM projection conv runs first — a JAX-package
    extension the reference layout cannot express, keyed ``{j}.0``/``{j}.1``
    as the JAX converter maps it."""

    def __init__(self, cin, ch, eps=1e-3, momentum=0.01):
        super().__init__()
        if cin != ch:
            self.add_module("0", SparseConv3dWeight(cin, ch))
            self.add_module("1", BatchNorm(ch, eps=eps, momentum=momentum))
        self.conv1 = SparseConv3dWeight(ch, ch)
        self.bn1 = BatchNorm(ch, eps=eps, momentum=momentum)
        self.conv2 = SparseConv3dWeight(ch, ch)
        self.bn2 = BatchNorm(ch, eps=eps, momentum=momentum)

    def forward(self, sp: SparseTensor, rulebook) -> SparseTensor:
        x = sp.feats
        if "0" in self._modules:
            x = torch.relu(self._modules["1"](sparse_conv(
                x, *rulebook, self._modules["0"].weight))).to(x.dtype)
        identity = x
        out = torch.relu(self.bn1(sparse_conv(x, *rulebook,
                                              self.conv1.weight)))
        out = self.bn2(sparse_conv(out.to(x.dtype), *rulebook,
                                   self.conv2.weight))
        return sp._replace(feats=torch.relu(out + identity).to(x.dtype))


class _EncoderLayers(nn.Module):
    pass


class SparseEncoder(nn.Module):
    """(voxel feats (N, C), coors (N, 4) (b, z, y, x), batch size) ->
    (B, ny_out, nx_out, C_out * nz_out) NHWC dense BEV.
    ``sparse_shape`` is (nz, ny, nx) like the reference."""

    def __init__(self, in_channels=5, sparse_shape=(41, 1440, 1440),
                 order=("conv", "norm", "act"), norm_cfg=None,
                 base_channels=16, output_channels=128,
                 encoder_channels=((16,), (32, 32, 32), (64, 64, 64),
                                   (64, 64, 64)),
                 encoder_paddings=((1,), (1, 1, 1), (1, 1, 1),
                                   ((0, 1, 1), 1, 1)),
                 block_type="conv_module", z_windows=None,
                 compute_dtype="float32",
                 # TPU table capacities: read and ignored (module doc)
                 stage_cap_ratios=None, dilation_ratio=None,
                 dilation_ratios=None, subm_dilation_ratios=None,
                 dense_from_stage=None, engine=None, z_pad_to=None,
                 **unused):
        super().__init__()
        if block_type != "basicblock":
            raise NotImplementedError(
                "the port's SparseEncoder implements block_type="
                "'basicblock' (the IS-Fusion layout)")
        norm_cfg = norm_cfg or dict(type="BN1d", eps=1e-3, momentum=0.01)
        eps = norm_eps(norm_cfg, 1e-3)
        bn = dict(eps=eps, momentum=norm_momentum(norm_cfg, 0.01))
        self.sparse_shape = tuple(int(s) for s in sparse_shape)
        self.z_window = tuple(int(v) for v in z_windows[0]) \
            if z_windows and z_windows[0] is not None else None
        self.cdtype = resolve_dtype(compute_dtype) or torch.float32
        self.conv_input = SparseConvModule(in_channels, base_channels, **bn)
        self.encoder_layers = _EncoderLayers()
        in_ch = base_channels
        n_stages = len(encoder_channels)
        nz = self.sparse_shape[0]
        for i, blocks in enumerate(encoder_channels):
            stage = nn.ModuleList()
            for j, out_ch in enumerate(tuple(blocks)):
                pad = _pad3(tuple(encoder_paddings[i])[j])
                if j == len(blocks) - 1 and i != n_stages - 1:
                    stage.append(SparseConvModule(in_ch, out_ch, stride=2,
                                                  padding=pad, subm=False,
                                                  **bn))
                    nz = (nz + 2 * pad[0] - 3) // 2 + 1
                else:
                    stage.append(SparseBasicBlock(in_ch, out_ch, **bn))
                in_ch = out_ch
            self.encoder_layers.add_module(f"encoder_layer{i + 1}", stage)
        self.n_stages = n_stages
        self.output_channels = int(output_channels)
        # z extent of the dense BEV: its channels are out_depth * C_out
        self.out_depth = (nz - 3) // 2 + 1
        self.conv_out = SparseConvModule(in_ch, output_channels,
                                         kernel_size=(3, 1, 1),
                                         stride=(2, 1, 1), padding=0,
                                         subm=False, **bn)

    def forward(self, voxel_features: torch.Tensor, coors: torch.Tensor,
                batch_size: int, return_stats: Optional[dict] = None
                ) -> torch.Tensor:
        """``return_stats`` (a dict, optional) receives the active-site
        count of each stage table."""
        feats = voxel_features.to(self.cdtype)
        if self.z_window is not None:
            lo, width = self.z_window
            keep = (coors[:, 1] >= lo) & (coors[:, 1] < lo + width)
            feats, coors = feats[keep], coors[keep]
        sp = build_sparse(feats, coors, self.sparse_shape, batch_size)
        rb = subm_rulebook(sp)
        sp, _ = self.conv_input(sp, rb)
        counts = [int(sp.feats.shape[0])]
        for i in range(self.n_stages):
            for blk in getattr(self.encoder_layers, f"encoder_layer{i + 1}"):
                if isinstance(blk, SparseBasicBlock):
                    sp = blk(sp, rb)
                else:
                    sp, _ = blk(sp)
                    rb = subm_rulebook(sp)
                    counts.append(int(sp.feats.shape[0]))
        out, _ = self.conv_out(sp)
        counts.append(int(out.feats.shape[0]))
        if return_stats is not None:
            return_stats["active_sites"] = counts
        return to_dense_bev(out)


def to_dense_bev(sp: SparseTensor) -> torch.Tensor:
    """Site table over (nz, ny, nx) -> (B, ny, nx, nz * C), channel
    z*C + c (the reference's N, C*D, H, W up to that channel order)."""
    nz, ny, nx = sp.shape
    c = sp.feats.shape[1]
    dense = torch.zeros((sp.batch_size, nz, ny, nx, c), dtype=sp.feats.dtype,
                        device=sp.feats.device)
    b, z, y, x = sp.coords.long().unbind(-1)
    dense[b, z, y, x] = sp.feats
    return dense.permute(0, 2, 3, 1, 4).reshape(sp.batch_size, ny, nx,
                                                nz * c)
