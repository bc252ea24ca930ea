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

BatchNorm runs in inference mode only (running statistics): the port
covers the predict forward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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
    """Conv2d over NHWC maps (OIHW weight, reference layout)."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.cdtype = dtype

    def forward(self, x):
        dt = compute_dtype(x, self.cdtype)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                     _cast(self.bias, dt), self.stride, self.padding,
                     self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


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


class BatchNorm(nn.BatchNorm1d):
    """Inference BatchNorm over the last axis, statistics in float32.

    Keeps BatchNorm1d/2d's parameter and buffer names (weight, bias,
    running_mean, running_var, num_batches_tracked)."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, dtype=None):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.cdtype = dtype

    def forward(self, x):
        out_dt = compute_dtype(x, self.cdtype)
        inv = torch.rsqrt(self.running_var.float() + self.eps) * \
            self.weight.float()
        y = (x.float() - self.running_mean.float()) * inv + self.bias.float()
        return y.to(out_dt)


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


def norm_eps(norm_cfg: Optional[dict], default: float = 1e-5) -> float:
    return float((norm_cfg or {}).get("eps", default))


class ConvModule(nn.Module):
    """conv(+bn)(+act) over NHWC maps — mmcv ConvModule naming (``conv``,
    ``bn``). The conv has a bias iff there is no norm (bias='auto')."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, bias="auto", norm_cfg=None, act_cfg=None,
                 dtype=None):
        super().__init__()
        use_bias = (norm_cfg is None) if bias == "auto" else bool(bias)
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding, bias=use_bias,
                           dtype=dtype)
        self.bn = BatchNorm(out_channels, eps=norm_eps(norm_cfg),
                            dtype=dtype) if norm_cfg is not None else None
        self.act = build_activation(act_cfg)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


class LinearNormAct(nn.Module):
    """Linear (no bias) + BN1d + ReLU over point rows — the reference's
    VFE layer (``linear``, ``norm``). Computes in float32."""

    def __init__(self, in_channels, out_channels, norm_cfg=None):
        super().__init__()
        self.linear = Linear(in_channels, out_channels, bias=False)
        self.norm = BatchNorm(out_channels, eps=norm_eps(norm_cfg, 1e-3))

    def forward(self, x):
        return torch.relu(self.norm(self.linear(x)))


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
