"""Shared PyTorch building blocks (counterpart of ``isfusion_tpu/models/layers.py``).

Precision follows the JAX package's per-module ``compute_dtype``: a layer
built with ``dtype=d`` casts its input and parameters to ``d`` (float32
master parameters, bf16 compute for the flagship); ``dtype=None`` promotes
the input with the float32 parameters, as flax does. Norm statistics are
always taken in float32 and the result is cast back.

Every layer here works channels-last (NHWC maps, (..., N, C) tokens), the
JAX package's layout, while keeping torch's parameter shapes (Linear
(out, in), Conv2d OIHW, Conv1d (out, in, 1)) so that ``state_dict`` keys
and shapes are those of the reference mmdet3d checkpoints.

``model.train()`` / ``model.eval()`` select the behaviour of BatchNorm
(batch statistics and a running update, or the running statistics) and of
dropout and drop path. Every random draw of a train-mode forward comes
from the ``torch.Generator`` installed by ``random_source`` (the detector's
``forward(..., generator=)`` installs it), never from the global one.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import world

# flax's LayerNorm default; the reference's torch LayerNorms use 1e-5
LN_EPS = 1e-6


def resolve_dtype(name) -> Optional[torch.dtype]:
    """Config string -> torch compute dtype (None = promote inputs)."""
    if name is None or name == "":
        return None
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def compute_dtype(x: torch.Tensor, dtype: Optional[torch.dtype]
                  ) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(
        x.dtype, torch.float32)


def _cast(t: Optional[torch.Tensor], dt: torch.dtype):
    return None if t is None else t.to(dt)


class Linear(nn.Linear):
    """Dense layer over the last axis, computed in ``dtype``."""

    def __init__(self, in_features, out_features, bias=True, dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.cdtype = dtype

    def forward(self, x):
        dt = compute_dtype(x, self.cdtype)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv1x1(nn.Conv1d):
    """Kernel-1 Conv1d (reference naming/shape) applied channels-last."""

    def __init__(self, in_channels, out_channels, bias=True, dtype=None):
        super().__init__(in_channels, out_channels, 1, bias=bias)
        self.cdtype = dtype

    def forward(self, x):
        dt = compute_dtype(x, self.cdtype)
        return F.linear(x.to(dt), self.weight[..., 0].to(dt),
                        _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """Conv2d over NHWC maps (OIHW weight, reference layout). On the CPU a
    strided 1x1 conv without padding samples its input first and runs at
    stride 1 (the same products and sums): PyTorch's CPU backward of a
    strided 1x1 conv over a channels-last input corrupts the heap (the
    process then fails at exit). The card has no such fault and runs the
    strided conv."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.cdtype = dtype

    def forward(self, x):
        dt = compute_dtype(x, self.cdtype)
        stride = self.stride
        if self.kernel_size == (1, 1) and self.padding == (0, 0) and \
                stride != (1, 1) and x.device.type == "cpu":
            x, stride = x[:, ::stride[0], ::stride[1]], 1
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                     _cast(self.bias, dt), stride, self.padding,
                     self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class Conv3d(nn.Conv3d):
    """Conv3d over (B, C, D, H, W) volumes (OIDHW weight), computed in
    ``dtype``."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.cdtype = dtype

    def forward(self, x):
        dt = compute_dtype(x, self.cdtype)
        return F.conv3d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                        self.stride, self.padding, self.dilation,
                        self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d over NHWC maps ((in, out, kh, kw) weight)."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.cdtype = dtype

    def forward(self, x):
        dt = compute_dtype(x, self.cdtype)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), _cast(self.bias, dt),
                               self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class _AllReduceSum(torch.autograd.Function):
    """psum over the ranks of the default process group. Every rank reads
    the sum, so the backward sums the incoming gradients over the ranks
    too (psum's transpose)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis, statistics in float32.

    Train mode normalises with the batch statistics of every row (all
    leading axes) and updates the running ones with torch's momentum
    convention; the running variance takes the unbiased batch variance, as
    torch and the reference do (flax takes the biased one). Eval mode uses
    the running statistics. Keeps BatchNorm1d/2d's parameter and buffer
    names (weight, bias, running_mean, running_var, num_batches_tracked).

    ``sync=True`` (a norm type containing 'sync') pools the statistics of
    the data-parallel ranks (``parallel/mesh.py:world``) in train mode
    when there are more than one: one all-reduce of (count, sum x, sum
    x^2) in float32, then the count-weighted mean and ``E[x^2] - mean^2``
    (the JAX package's ``MaskedBatchNorm`` rule: exact global-batch
    statistics; the running variance unbiased by the global count). On
    one rank, and in eval mode, a sync norm is the plain one."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, dtype=None,
                 sync: bool = False):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.cdtype = dtype
        self.sync = bool(sync)

    def forward(self, x):
        out_dt = compute_dtype(x, self.cdtype)
        if self.training and self.sync and world()[1] > 1:
            return self.pooled(x.float(), None, unbiased=True).to(out_dt)
        if self.training:
            self.num_batches_tracked.add_(1)
            y = F.batch_norm(x.float().reshape(-1, x.shape[-1]),
                             self.running_mean, self.running_var,
                             self.weight.float(), self.bias.float(), True,
                             self.momentum, self.eps)
            return y.reshape(x.shape).to(out_dt)
        inv = torch.rsqrt(self.running_var.float() + self.eps) * \
            self.weight.float()
        y = (x.float() - self.running_mean.float()) * inv + self.bias.float()
        return y.to(out_dt)

    def pooled(self, x32: torch.Tensor, m: Optional[torch.Tensor],
               unbiased: bool) -> torch.Tensor:
        """Normalise float32 ``x32`` (..., C) with the statistics of the
        rows of every rank (those where the (..., 1) float mask ``m`` is 1)
        and update the running ones (variance unbiased by the global count
        when ``unbiased``); the ranks' sums are pooled when ``sync``."""
        self.num_batches_tracked.add_(1)
        dims = tuple(range(x32.dim() - 1))
        c = x32.shape[-1]
        if m is None:
            cnt = torch.full((1,), float(x32.numel() // c),
                             device=x32.device)
            s1, s2 = x32.sum(dims), (x32 ** 2).sum(dims)
        else:
            cnt = m.sum().reshape(1)
            s1, s2 = (x32 * m).sum(dims), ((x32 * m) ** 2).sum(dims)
        stats = torch.cat([cnt, s1, s2])
        if self.sync and world()[1] > 1:
            stats = _AllReduceSum.apply(stats)
        total = stats[0]
        n = total.clamp_min(1.0)
        mean = stats[1:c + 1] / n
        var = (stats[c + 1:] / n - mean ** 2).clamp_min(0.0)
        with torch.no_grad():
            run_var = var * total / (total - 1.0).clamp_min(1.0) \
                if unbiased else var
            self.running_mean.mul_(1 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(
                self.momentum * run_var)
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x32 - mean) * inv + self.bias.float()


class BatchNorm3d(BatchNorm):
    """``BatchNorm`` (without ``sync``) over dim 1 of channels-first
    (B, C, D, H, W) volumes: the same statistics and running updates,
    normalised in place of a move of the channels to the last axis."""

    def forward(self, x):
        out_dt = compute_dtype(x, self.cdtype)
        if self.training:
            self.num_batches_tracked.add_(1)
            return F.batch_norm(x.float(), self.running_mean,
                                self.running_var, self.weight.float(),
                                self.bias.float(), True, self.momentum,
                                self.eps).to(out_dt)
        shape = (-1,) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var.float() + self.eps) * \
            self.weight.float()
        y = (x.float() - self.running_mean.float().view(shape)) * \
            inv.view(shape) + self.bias.float().view(shape)
        return y.to(out_dt)


_GENERATOR: contextvars.ContextVar = contextvars.ContextVar(
    "isfusion_tpu_torch_generator", default=None)


@contextlib.contextmanager
def random_source(generator: Optional[torch.Generator]):
    """Make ``generator`` the source of every random draw (dropout, drop
    path, pixel jitter) inside the block (per thread and task)."""
    token = _GENERATOR.set(generator)
    try:
        yield
    finally:
        _GENERATOR.reset(token)


def rand(shape, device) -> torch.Tensor:
    """U[0, 1) float32 draws from the installed generator; raises if none
    is installed, so a train-mode forward never falls back to global
    randomness."""
    gen = _GENERATOR.get()
    if gen is None:
        raise RuntimeError("a train-mode forward draws its random numbers "
                           "from an explicit torch.Generator: pass "
                           "generator= to the detector's forward")
    return torch.rand(tuple(shape), generator=gen, device=device)


def dropout(x: torch.Tensor, p: float, training: bool,
            broadcast_leading: int = 0) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with 1 - p, scale kept values by 1/(1-p).
    The mask is shared over the first ``broadcast_leading`` axes (flax's
    attention-weight dropout shares it over batch and heads)."""
    if not training or p == 0.0:
        return x
    shape = (1,) * broadcast_leading + tuple(x.shape[broadcast_leading:])
    keep = rand(shape, x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


class DropPath(nn.Module):
    """Stochastic depth: drop a whole sample's residual branch with
    probability ``p``, scale kept ones by 1/(1-p)."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = rand((x.shape[0],) + (1,) * (x.dim() - 1), x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the channels (last axis) of NHWC maps, statistics in
    float32 (flax ``nn.GroupNorm``, mmcv's ``gn``)."""

    def __init__(self, num_groups, num_channels, eps=1e-5, dtype=None):
        super().__init__(num_groups, num_channels, eps=eps)
        self.cdtype = dtype

    def forward(self, x):
        out_dt = compute_dtype(x, self.cdtype)
        y = F.group_norm(x.float().movedim(-1, 1), self.num_groups,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.movedim(1, -1).to(out_dt)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, statistics in float32."""

    def __init__(self, normalized_shape, eps=LN_EPS, dtype=None):
        super().__init__(normalized_shape, eps=eps)
        self.cdtype = dtype

    def forward(self, x):
        out_dt = compute_dtype(x, self.cdtype)
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(out_dt)


def build_activation(act_cfg: Optional[dict]):
    if act_cfg is None:
        return None
    t = act_cfg["type"].lower() if isinstance(act_cfg, dict) \
        else str(act_cfg).lower()
    return {
        "relu": nn.ReLU(),
        "gelu": nn.GELU(),
        "silu": nn.SiLU(),
        "swish": nn.SiLU(),
        "leakyrelu": nn.LeakyReLU(0.01),
        "sigmoid": nn.Sigmoid(),
        "tanh": nn.Tanh(),
    }[t]


# norm types a config may name for the port's BatchNorm; the kinds whose
# name contains 'sync' build it with sync=True (``is_sync_norm``)
BN_TYPES = ("BN", "BN1d", "BN2d", "SyncBN", "naiveSyncBN1d", "naiveSyncBN2d")


def norm_eps(norm_cfg: Optional[dict], default: float = 1e-5) -> float:
    """eps of a batch-norm config; raises for another norm type."""
    kind = (norm_cfg or {}).get("type", "BN")
    if kind not in BN_TYPES:
        raise NotImplementedError(f"norm type {kind!r}: the port builds "
                                  f"{', '.join(BN_TYPES)}")
    return float((norm_cfg or {}).get("eps", default))


def norm_momentum(norm_cfg: Optional[dict], default: float = 0.1) -> float:
    """torch momentum of a norm config (flax's is 1 - this)."""
    return float((norm_cfg or {}).get("momentum", default))


def is_sync_norm(norm_cfg: Optional[dict]) -> bool:
    """Whether a norm config syncs its statistics over the ranks (the
    JAX package's ``is_sync_norm``)."""
    return "sync" in str((norm_cfg or {}).get("type", "")).lower()


def bn_args(norm_cfg: Optional[dict], eps: float = 1e-5,
            momentum: float = 0.1) -> dict:
    """``BatchNorm`` keyword arguments of a batch-norm config (defaults
    ``eps``, ``momentum``)."""
    return dict(eps=norm_eps(norm_cfg, eps),
                momentum=norm_momentum(norm_cfg, momentum),
                sync=is_sync_norm(norm_cfg))


def is_group_norm(norm_cfg: Optional[dict]) -> bool:
    return norm_cfg is not None and str(norm_cfg.get("type", "")).upper() \
        .startswith("GN")


class ConvModule(nn.Module):
    """conv(+norm)(+act) over NHWC maps — mmcv ConvModule naming (``conv``,
    then ``bn`` for a batch norm or ``gn`` for a GroupNorm config, with
    its ``num_groups`` and ``eps``, default 1e-5). The conv has a bias iff
    there is no norm (bias='auto')."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, bias="auto", norm_cfg=None, act_cfg=None,
                 dtype=None):
        super().__init__()
        use_bias = (norm_cfg is None) if bias == "auto" else bool(bias)
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding, bias=use_bias,
                           dtype=dtype)
        self.bn = self.gn = None
        if is_group_norm(norm_cfg):
            self.gn = GroupNorm(int(norm_cfg.get("num_groups", 32)),
                                out_channels, float(norm_cfg.get("eps", 1e-5)),
                                dtype=dtype)
        elif norm_cfg is not None:
            self.bn = BatchNorm(out_channels, dtype=dtype,
                                **bn_args(norm_cfg))
        self.act = build_activation(act_cfg)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.gn is not None:
            x = self.gn(x)
        if self.act is not None:
            x = self.act(x)
        return x


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over padded (..., N, C) buffers with a (..., N) validity
    mask — the JAX package's ``MaskedBatchNorm``. Train mode takes the
    statistics of the valid rows only, as that package computes them
    (mean and mean square in float32, variance ``meansqr - mean**2``
    floored at 0; pooled over the ranks when ``sync``), normalises every
    row with them, and feeds the same biased variance into
    ``running_var``."""

    def forward(self, x, mask):
        if not self.training:
            return super().forward(x)
        y = self.pooled(x.float(), mask.float()[..., None], unbiased=False)
        return y.to(compute_dtype(x, self.cdtype))


class LinearNormAct(nn.Module):
    """Linear (no bias) + BN1d + ReLU over point rows — the reference's
    VFE layer (``linear``, ``norm``). Computes in float32. With
    ``masked=True`` it works on padded (..., N, C) buffers: the norm is a
    ``MaskedBatchNorm`` and ``forward(x, mask)`` zeroes the padded rows
    after the ReLU (the JAX package's ``LinearNormAct``)."""

    def __init__(self, in_channels, out_channels, norm_cfg=None,
                 masked: bool = False):
        super().__init__()
        self.linear = Linear(in_channels, out_channels, bias=False)
        bn = MaskedBatchNorm if masked else BatchNorm
        self.norm = bn(out_channels, **bn_args(norm_cfg, 1e-3, 0.01))

    def forward(self, x, mask=None):
        if mask is None:
            return torch.relu(self.norm(self.linear(x)))
        y = torch.relu(self.norm(self.linear(x), mask))
        return torch.where(mask[..., None], y, torch.zeros((), dtype=y.dtype,
                                                           device=y.device))


def init_weights(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random initialisation of every parameter and buffer.

    Weights with two or more dims get N(0, 1/fan_in) (fan_in = all but
    the output axis of the reference layout), 1-D weights of norms 1,
    biases 0, BN running statistics (0, 1). Modules may then apply their
    own special biases through ``reset_special_parameters``. Uses a
    ``torch.Generator`` on the CPU so the draw is the same on any device."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() >= 2:
                fan_in = _fan_in(name, p)
                p.copy_(torch.randn(p.shape, generator=g) /
                        math.sqrt(max(fan_in, 1)))
            elif leaf == "weight":
                p.fill_(1.0)
            else:
                p.zero_()
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.zero_()
            elif name.endswith("running_var"):
                b.fill_(1.0)
        for m in module.modules():
            fn = getattr(m, "reset_special_parameters", None)
            if fn is not None:
                fn()
    return module


def _fan_in(name: str, p: torch.Tensor) -> int:
    if name.endswith("relative_position_bias_table"):
        return 2500         # ~ truncated_normal(0.02) scale
    if p.dim() == 5:        # spconv (out, kz, ky, kx, in)
        return int(p[0].numel())
    if "deblocks" in name and p.dim() == 4 and p.shape[-1] > 1:
        return int(p.shape[0])   # ConvTranspose2d (in, out, kh, kw)
    return int(p[0].numel())
