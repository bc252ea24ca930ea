"""Segment reductions (counterpart of ``isfusion_tpu/ops/scatter.py``).

Plain PyTorch for now (ROADMAP queue K2 for a hand-written kernel). The port
uses dynamic shapes: segments are dense ids in [0, num_segments) and every
row belongs to one; there is no trash slot.
"""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; empty segments give 0 (the JAX encoders zero the
    -inf of an empty segment)."""
    ids = segment_ids.long().view(-1, *([1] * (data.dim() - 1)))
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, ids.expand_as(data), data, "amax",
                               include_self=False)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype,
                                   device=data.device), segment_ids,
                        num_segments)
    return total / count.clamp_min(1.0).view(-1, *([1] * (data.dim() - 1)))
