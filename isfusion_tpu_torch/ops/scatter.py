"""Segment reductions (counterpart of ``isfusion_tpu/ops/scatter.py``) —
``segment_max`` and ``segment_mean`` are K2.

The port uses dynamic shapes: segments are dense ids in [0, num_segments)
and every row belongs to one; there is no trash slot. Empty segments give
0 (the JAX encoders zero the -inf of an empty segment).

On a CPU tensor ``segment_max`` / ``segment_mean`` take their plain
versions (``segment_max_ref``: ``scatter_reduce`` amax; ``segment_mean_ref``:
``index_add_`` sums over the counts); on a CUDA tensor they launch
``csrc/dynamic_scatter.cu`` or raise. Both are autograd functions. The
max's gradient goes in equal parts to the rows equal to the maximum, as
``jax.ops.segment_max`` splits it (PyTorch's own ``scatter_reduce``
backward also counts the zero it starts from when a maximum is exactly 0,
so the plain version spells the split out). The mean's gradient is the
segment's gradient over its count. The kernel's max, forward and
backward, equals the plain version bit for bit; its mean sums each
segment's rows in increasing row order (the CPU's ``index_add_`` order),
so it repeats from run to run on the card and equals the plain version on
the CPU bit for bit.
"""
from __future__ import annotations

import torch

from . import cuda_build

def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def _counts(segment_ids: torch.Tensor, num_segments: int,
            dtype: torch.dtype) -> torch.Tensor:
    return segment_sum(torch.ones(segment_ids.shape[:1], dtype=dtype,
                                  device=segment_ids.device), segment_ids,
                       num_segments)


class _SegmentMaxRef(torch.autograd.Function):
    """``scatter_reduce`` amax forward; the gradient split equally among
    the rows equal to the maximum: grad_out / ties, gathered, times 0 or
    1."""

    @staticmethod
    def forward(ctx, data, ids, num_segments):
        idx = ids.view(-1, *([1] * (data.dim() - 1))).expand_as(data)
        out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                          dtype=data.dtype, device=data.device)
        out.scatter_reduce_(0, idx, data, "amax", include_self=False)
        ctx.save_for_backward(data, ids, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        data, ids, out = ctx.saved_tensors
        eq = (data == out[ids]).to(data.dtype)
        ties = torch.zeros_like(out).index_add_(0, ids, eq)
        return eq * (grad_out / ties)[ids], None, None


def segment_max_ref(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of ``segment_max``."""
    return _SegmentMaxRef.apply(data, segment_ids.long(), int(num_segments))


def segment_mean_ref(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of ``segment_mean`` (autograd through
    ``index_add_``)."""
    total = segment_sum(data, segment_ids, num_segments)
    count = _counts(segment_ids, num_segments, data.dtype)
    return total / count.clamp_min(1.0).view(-1, *([1] * (data.dim() - 1)))


def _check(name, data, ids, num_segments):
    if data.dim() != 2 or ids.dim() != 1 or ids.shape[0] != data.shape[0]:
        raise ValueError(f"{name}: data (P, C) and segment ids (P,), got "
                         f"{tuple(data.shape)} and {tuple(ids.shape)}")
    if data.device != ids.device:
        raise ValueError(f"{name}: data and ids on different devices")
    if num_segments < 0 or data.shape[1] == 0:
        raise ValueError(f"{name}: needs num_segments >= 0 and C >= 1")


def _launch(op, data, ids, s, out, grad_out=None, ties=None, grad_in=None,
            counts=None, cursor=None, prefix=None, tile_sums=None,
            members=None, total=None):
    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = cuda_build.load("dynamic_scatter")
    err = lib.dynamic_scatter(
        op, data.data_ptr(), ids.data_ptr(), data.shape[0], data.shape[1], s,
        ptr(out), ptr(grad_out), ptr(ties), ptr(grad_in), ptr(counts),
        ptr(cursor), ptr(prefix), ptr(tile_sums), ptr(members), ptr(total),
        torch.cuda.current_stream(data.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dynamic_scatter: kernel launch failed with CUDA "
                           f"error {err}")
    cuda_build.LAUNCHES["dynamic_scatter"] += 1


def _cuda_operands(name, data, ids):
    if data.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {data.device}")
    if data.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 data")
    return data.contiguous(), ids.to(torch.int64).contiguous()


class _SegmentMaxKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_segments):
        out = torch.zeros((num_segments, data.shape[1]), dtype=data.dtype,
                          device=data.device)
        _launch(0, data, ids, num_segments, out)
        ctx.save_for_backward(data, ids, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        data, ids, out = ctx.saved_tensors
        ties = torch.zeros(out.shape, dtype=torch.int32, device=out.device)
        grad_in = torch.empty_like(data)
        _launch(1, data, ids, out.shape[0], out,
                grad_out=grad_out.contiguous(), ties=ties, grad_in=grad_in)
        return grad_in, None, None


class _SegmentMeanKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_segments):
        p, c = data.shape
        dev = data.device
        counts = torch.zeros(num_segments, dtype=torch.int32, device=dev)
        cursor = torch.zeros(num_segments, dtype=torch.int32, device=dev)
        prefix = torch.empty(num_segments, dtype=torch.int32, device=dev)
        tile_sums = torch.empty(max(-(-num_segments //
                                      cuda_build.PREFIX_SCAN_TILE), 1),
                                dtype=torch.int32, device=dev)
        members = torch.empty(p, dtype=torch.int32, device=dev)
        total = torch.empty(1, dtype=torch.int64, device=dev)
        out = torch.zeros((num_segments, c), dtype=data.dtype, device=dev)
        _launch(2, data, ids, num_segments, out, counts=counts,
                cursor=cursor, prefix=prefix, tile_sums=tile_sums,
                members=members, total=total)
        ctx.save_for_backward(ids, counts)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        ids, counts = ctx.saved_tensors
        count = counts.to(grad_out.dtype).clamp_min(1.0)
        return (grad_out / count[:, None])[ids], None, None


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(P, C) rows, (P,) ids in [0, num_segments) -> (num_segments, C)
    per-segment max; empty segments give 0 — K2."""
    _check("segment_max", data, segment_ids, num_segments)
    if data.device.type == "cpu":
        return segment_max_ref(data, segment_ids, num_segments)
    data, ids = _cuda_operands("segment_max", data, segment_ids)
    return _SegmentMaxKernel.apply(data, ids, int(num_segments))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """(P, C) rows, (P,) ids in [0, num_segments) -> (num_segments, C)
    per-segment mean; empty segments give 0 — K2."""
    _check("segment_mean", data, segment_ids, num_segments)
    if data.device.type == "cpu":
        return segment_mean_ref(data, segment_ids, num_segments)
    data, ids = _cuda_operands("segment_mean", data, segment_ids)
    return _SegmentMeanKernel.apply(data, ids, int(num_segments))
