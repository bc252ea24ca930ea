"""PAConv (counterpart of ``isfusion_tpu/ops/paconv.py``; reference mmdet3d
``ops/paconv``) — K15: the weight-bank contraction and
``assign_score_withk``.

- ``paconv_bank(x (R, C), scores (R, M), bank (C, M O))`` -> (R, O):
  ``y[r, o] = sum_m scores[r, m] sum_c x[r, c] bank[c, m O + o]``, the
  PAConv layer's contraction (``paconv.py:123-125``: ``feats @ bank``, then
  the einsum), differentiable in all three. The bank keeps the reference's
  (2 Cin, M O) layout, column m O + o, so converted weights drop in.
- ``assign_score_withk(scores (B, S, K, M), point_feats (B, N, M, O),
  center_feats (B, N, M, O), knn_idx (B, S, K))`` -> (B, S, K, O) (``:21``):
  ``sum_m scores * (point_feats[knn] - center_feats[knn[..., :1]])``,
  divided by M for ``aggregate='avg'``; differentiable in the scores and
  both features.
- ``assign_kernel_withoutk`` (``:39``): two matrix products and the odd
  ``Cin``'s coordinate half, plain PyTorch on every device.
- ``ScoreNet`` (``:54``) and ``PAConv`` (``:79``), the modules, with the
  reference's parameter names (``weight_bank``, ``scorenet.mlps.layer{i}.
  conv`` / ``.bn``, ``bn``).

On a CPU tensor the two kernels' wrappers take their plain versions
(``*_ref``: the product and einsum as JAX writes them, under autograd); on
a CUDA tensor they launch ``csrc/paconv.cu`` (forward and backward, a
``torch.autograd.Function``) or raise. ``cuda_build.LAUNCHES``
counts ``paconv_bank`` and ``paconv_score`` launches, backward ones
included. The kernels take float32 (the plain versions any one dtype).
"""
from __future__ import annotations

import ctypes
import functools
import struct
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .pointnet_ops import _fn, _launched, _on_card, _stream
from ..models.layers import BatchNorm, MaskedBatchNorm

_BANK_FWD, _BANK_GRAD_X, _BANK_GRAD_W = 0, 1, 2
_SCORE_FWD, _SCORE_GRAD_S, _SCORE_GRAD_P, _SCORE_GRAD_C = 0, 1, 2, 3


# ------------------------------------------------------------ plain parts
def paconv_bank_ref(x: torch.Tensor, scores: torch.Tensor,
                    bank: torch.Tensor) -> torch.Tensor:
    """Plain version of K15-bank: ``(x @ bank)`` viewed (R, M, O), then
    the einsum with the scores."""
    r, m = scores.shape
    nf = (x @ bank.to(x.dtype)).view(r, m, -1)
    return torch.einsum("rm,rmo->ro", scores, nf)


def assign_score_withk_ref(scores: torch.Tensor, point_feats: torch.Tensor,
                           center_feats: torch.Tensor, knn_idx: torch.Tensor,
                           aggregate: str = "sum") -> torch.Tensor:
    """Plain version of K15-score."""
    b, s, k = knn_idx.shape
    idx = knn_idx.long()
    rows = torch.arange(b, device=idx.device)[:, None, None]
    p = point_feats[rows, idx]                            # (B, S, K, M, O)
    c = center_feats[rows, idx[..., :1]]                  # (B, S, 1, M, O)
    out = torch.einsum("bskm,bskmo->bsko", scores, p - c)
    if aggregate == "avg":
        out = out / scores.shape[-1]
    return out


def assign_kernel_withoutk(features: torch.Tensor, kernels: torch.Tensor,
                           m: int):
    """features (B, N, Cin), kernels (2 Cin, M O) -> (point_feats,
    center_feats), each (B, N, M, O) (``utils.assign_kernel_withoutk``)."""
    b, n, cin = features.shape
    half1 = torch.matmul(features, kernels[:cin]).reshape(b, n, m, -1)
    half2 = torch.matmul(features, kernels[cin:]).reshape(b, n, m, -1)
    if cin % 2 != 0:
        half_coord = torch.matmul(features[..., :3],
                                  kernels[cin:cin + 3]).reshape(b, n, m, -1)
    else:
        half_coord = torch.zeros_like(half2)
    return half1 + half2, half1 + half_coord


# --------------------------------------------------------------- kernels
_PACK = {n: struct.Struct(f"{n}q").pack_into for n in (12, 17)}
_ARGS = threading.local()


def _call(name: str, stream_of: torch.Tensor, *args) -> None:
    """One call of ``name`` with its int64 arguments packed into a buffer
    of this thread (tensors as their data pointers, None as 0); a generic
    packer, as K15's calls are few and long (K14-gather keeps its own
    unrolled one, ``pointnet_ops._gather_call``)."""
    n = len(args)
    buf = getattr(_ARGS, f"buf{n}", None)
    if buf is None:
        arr = (ctypes.c_longlong * n)()
        buf = (arr, ctypes.addressof(arr))
        setattr(_ARGS, f"buf{n}", buf)
    _PACK[n](buf[0], 0, *[0 if a is None else a.data_ptr()
                          if torch.is_tensor(a) else int(a) for a in args])
    _launched(name, _fn(name)(buf[1], _stream(stream_of)))


@functools.lru_cache(maxsize=256)
def _bank_chunks(r: int, c: int, m: int, o: int) -> int:
    return _fn("paconv_bank_chunks")(r, c, m, o)


@functools.lru_cache(maxsize=256)
def _score_words(segs: int, slots: int) -> int:
    return _fn("point_gather_scratch")(segs, slots)


def _bank_forward(x, s, w) -> torch.Tensor:
    r, c = x.shape
    m = s.shape[1]
    o = w.shape[1] // m
    y = x.new_empty((r, o))
    if r:
        _call("paconv_bank", x, _BANK_FWD, x, s, w, None, y, None, None, r,
              c, m, o)
    return y


class _Bank(torch.autograd.Function):
    """K15-bank with its backward: ``csrc/paconv.cu`` op 1 (dX and dS in
    one launch) and op 2 (dW: the row chunks' partials, then their sum in
    order, two launches)."""

    @staticmethod
    def forward(ctx, x, s, w):
        ctx.save_for_backward(x, s, w)
        return _bank_forward(x, s, w)

    @staticmethod
    def backward(ctx, g):
        x, s, w = ctx.saved_tensors
        g = g.contiguous()
        r, c = x.shape
        m = s.shape[1]
        o = w.shape[1] // m
        dx = ds = dw = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dx, ds = x.new_empty((r, c)), s.new_empty((r, m))
            if r:
                _call("paconv_bank", g, _BANK_GRAD_X, x, s, w, g, dx, ds,
                      None, r, c, m, o)
        if ctx.needs_input_grad[2]:
            dw = w.new_empty(w.shape)
            if r:
                part = g.new_empty((_bank_chunks(r, c, m, o), m * c, o))
                _call("paconv_bank", g, _BANK_GRAD_W, x, s, w, g, dw, None,
                      part, r, c, m, o)
            else:
                dw.zero_()
        return dx, ds, dw


def paconv_bank(x: torch.Tensor, scores: torch.Tensor,
                bank: torch.Tensor) -> torch.Tensor:
    """K15-bank: x (R, C), scores (R, M), bank (C, M O), float32 ->
    (R, O)."""
    if x.dim() != 2 or scores.dim() != 2 or bank.dim() != 2 or \
            scores.shape[0] != x.shape[0] or bank.shape[0] != x.shape[1] or \
            bank.shape[1] % max(scores.shape[1], 1) != 0:
        raise ValueError(f"paconv_bank: shapes x {tuple(x.shape)}, scores "
                         f"{tuple(scores.shape)}, bank {tuple(bank.shape)}")
    if not x.dtype == scores.dtype == bank.dtype:
        raise TypeError("paconv_bank: x, scores and bank of one dtype")
    if not _on_card("paconv_bank", x, scores, bank):
        return paconv_bank_ref(x, scores, bank)
    if x.dtype != torch.float32:
        raise TypeError("paconv_bank: the kernel takes float32")
    x, scores, bank = x.contiguous(), scores.contiguous(), bank.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or scores.requires_grad
                                    or bank.requires_grad):
        return _Bank.apply(x, scores, bank)
    return _bank_forward(x, scores, bank)


class _Score(torch.autograd.Function):
    """K15-score with its backward: the scores' gradient (op 1), the point
    features' (op 2) and the centre features' (op 3), each list of slots
    built in its own call (``stable_lists.cuh``)."""

    @staticmethod
    def forward(ctx, scores, pf, cf, knn, avg):
        ctx.save_for_backward(scores, pf, cf, knn)
        ctx.avg = avg
        return _score_forward(scores, pf, cf, knn, avg)

    @staticmethod
    def backward(ctx, g):
        scores, pf, cf, knn = ctx.saved_tensors
        g = g.contiguous()
        b, s, k, m = scores.shape
        n, o = pf.shape[1], pf.shape[3]
        dims = (b, n, s, k, m, o, int(ctx.avg), 0)
        ds = dp = dc = None
        if ctx.needs_input_grad[0]:
            ds = scores.new_empty(scores.shape)
            _call("paconv_score", g, _SCORE_GRAD_S, None, pf, cf, knn, None,
                  g, ds, None, *dims)
        if ctx.needs_input_grad[1]:
            dp = pf.new_empty(pf.shape)
            scratch = torch.empty(_score_words(b * n, b * s * k),
                                  dtype=torch.int32, device=g.device)
            _call("paconv_score", g, _SCORE_GRAD_P, scores, None, None, knn,
                  None, g, dp, scratch, *dims)
        if ctx.needs_input_grad[2]:
            dc = cf.new_empty(cf.shape)
            scratch = torch.empty(_score_words(b * n, b * s),
                                  dtype=torch.int32, device=g.device)
            knn0 = knn[..., 0].contiguous()
            _call("paconv_score", g, _SCORE_GRAD_C, scores, None, None, knn,
                  knn0, g, dc, scratch, *dims)
        return ds, dp, dc, None, None


def _score_forward(scores, pf, cf, knn, avg: bool) -> torch.Tensor:
    b, s, k, m = scores.shape
    n, o = pf.shape[1], pf.shape[3]
    out = scores.new_empty((b, s, k, o))
    _call("paconv_score", scores, _SCORE_FWD, scores, pf, cf, knn, None, None,
          out, None, b, n, s, k, m, o, int(avg), 0)
    return out


def assign_score_withk(scores: torch.Tensor, point_feats: torch.Tensor,
                       center_feats: torch.Tensor, knn_idx: torch.Tensor,
                       aggregate: str = "sum") -> torch.Tensor:
    """K15-score: scores (B, S, K, M), point_feats and center_feats (B, N,
    M, O) float32, knn_idx (B, S, K) integer (knn_idx[..., 0] the centre's
    own index) -> (B, S, K, O)."""
    if aggregate not in ("sum", "avg"):
        raise ValueError(f"assign_score_withk: aggregate {aggregate!r}")
    b, s, k, m = scores.shape
    if knn_idx.shape != (b, s, k) or point_feats.dim() != 4 or \
            point_feats.shape != center_feats.shape or \
            point_feats.shape[0] != b or point_feats.shape[2] != m:
        raise ValueError("assign_score_withk: shapes do not agree")
    if not scores.dtype == point_feats.dtype == center_feats.dtype:
        raise TypeError("assign_score_withk: scores and features of one "
                        "dtype")
    if not _on_card("assign_score_withk", scores, point_feats, center_feats,
                    knn_idx):
        return assign_score_withk_ref(scores, point_feats, center_feats,
                                      knn_idx, aggregate)
    if scores.dtype != torch.float32:
        raise TypeError("assign_score_withk: the kernel takes float32")
    out_shape = (b, s, k, point_feats.shape[3])
    if scores.numel() == 0 or point_feats.shape[3] == 0:
        return scores.new_zeros(out_shape)
    args = (scores.contiguous(), point_feats.contiguous(),
            center_feats.contiguous(), knn_idx.to(torch.int32).contiguous(),
            aggregate == "avg")
    if torch.is_grad_enabled() and any(a.requires_grad for a in args[:3]):
        return _Score.apply(*args)
    return _score_forward(*args)


# --------------------------------------------------------------- modules
class _ScoreLayer(nn.Module):
    """A 1x1 conv (``conv``: Conv2d (out, in, 1, 1), a bias without a
    norm) over the last axis, a ``BatchNorm`` over every row (``bn``, eps
    1e-5, torch momentum 0.1: flax's 0.9) and a ReLU, or the conv alone."""

    def __init__(self, cin: int, cout: int, norm: bool, act: bool):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=not norm)
        self.bn = BatchNorm(cout, eps=1e-5, momentum=0.1) if norm else None
        self.act = act

    def forward(self, x):
        w = self.conv.weight.reshape(self.conv.out_channels, -1)
        x = F.linear(x, w, self.conv.bias)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x) if self.act else x


class ScoreNet(nn.Module):
    """The MLP over each grouped point's position feature -> its M kernel
    scores (``paconv.py:ScoreNet``): ``mlp_channels`` (input, hidden...,
    M); the hidden layers conv + BN + ReLU (``mlps.layer{i}``), the last a
    conv with a bias (BN, no bias, with ``last_bn``), then softmax or
    sigmoid over M with ``temp_factor`` (or the raw scores)."""

    def __init__(self, mlp_channels: Sequence[int],
                 score_norm: str = "softmax", temp_factor: float = 1.0,
                 last_bn: bool = False):
        super().__init__()
        if score_norm not in ("softmax", "sigmoid", "identity"):
            raise ValueError(f"score_norm {score_norm!r}")
        self.score_norm, self.temp_factor = score_norm, float(temp_factor)
        ch = [int(c) for c in mlp_channels]
        self.mlps = nn.Module()
        for i in range(len(ch) - 1):
            last = i == len(ch) - 2
            self.mlps.add_module(f"layer{i}", _ScoreLayer(
                ch[i], ch[i + 1], norm=not last or last_bn, act=not last))
        self.depth = len(ch) - 1

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self.mlps, f"layer{i}")(x)
        if self.score_norm == "softmax":
            return torch.softmax(x / self.temp_factor, -1)
        if self.score_norm == "sigmoid":
            return torch.sigmoid(x / self.temp_factor)
        return x


_SCORENET_IN = {"identity": 3, "w_neighbor": 6, "w_neighbor_dist": 7}


class PAConv(nn.Module):
    """Position-adaptive convolution over grouped neighbourhoods
    (``paconv.py:PAConv``), channels-last: ``forward(feats (B, S, K, Cin),
    rel_xyz (B, S, K, 3), valid (B, S, K))`` -> (B, S, K, out). With
    ``kernel_input='w_neighbor'`` each point's features are ``(feat -
    centre, feat)``, the centre being the ball's first grouped slot (as
    the JAX package takes it: ``feats[:, :, :1]``); ScoreNet reads ``(rel
    - rel[first slot], rel, |rel + 1e-12|)`` (``'w_neighbor_dist'``); K15-bank
    contracts the features with the bank (``weight_bank``, (C, M out)) by
    the scores; then a ``MaskedBatchNorm`` over the valid rows (``bn``,
    eps 1e-5, momentum 0.1), a ReLU, the invalid rows zeroed."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_kernels: int = 8, kernel_input: str = "w_neighbor",
                 scorenet_input: str = "w_neighbor_dist",
                 scorenet_cfg: Optional[dict] = None):
        super().__init__()
        if kernel_input not in ("w_neighbor", "identity"):
            raise ValueError(f"kernel_input {kernel_input!r}")
        self.kernel_input, self.scorenet_input = kernel_input, scorenet_input
        self.num_kernels, self.out_channels = int(num_kernels), \
            int(out_channels)
        cin = int(in_channels) * (2 if kernel_input == "w_neighbor" else 1)
        cfg = dict(scorenet_cfg or dict(mlp_channels=[16, 16, 16],
                                        score_norm="softmax",
                                        temp_factor=1.0, last_bn=False))
        mlp = [_SCORENET_IN[scorenet_input]] + list(
            cfg.pop("mlp_channels")) + [self.num_kernels]
        self.scorenet = ScoreNet(mlp, **cfg)
        self.weight_bank = nn.Parameter(torch.zeros(
            cin, self.num_kernels * self.out_channels))
        self.bn = MaskedBatchNorm(self.out_channels, eps=1e-5, momentum=0.1)

    def forward(self, feats, rel_xyz, valid):
        b, s, k, _ = feats.shape
        if self.kernel_input == "w_neighbor":
            feats = torch.cat([feats - feats[:, :, :1], feats], -1)
        if self.scorenet_input == "identity":
            xyz_feat = rel_xyz
        elif self.scorenet_input == "w_neighbor":
            xyz_feat = torch.cat([rel_xyz, rel_xyz - rel_xyz[:, :, :1]], -1)
        else:
            dist = torch.linalg.norm(rel_xyz + 1e-12, dim=-1, keepdim=True)
            xyz_feat = torch.cat([rel_xyz - rel_xyz[:, :, :1], rel_xyz, dist],
                                 -1)
        scores = self.scorenet(xyz_feat)
        out = paconv_bank(feats.reshape(b * s * k, -1),
                          scores.reshape(b * s * k, -1), self.weight_bank)
        out = torch.relu(self.bn(out.view(b, s, k, -1), valid))
        return torch.where(valid[..., None], out, torch.zeros(
            (), dtype=out.dtype, device=out.device))
