"""Segment reductions (counterpart of ``isfusion_tpu/ops/scatter.py``) —
``segment_max`` and ``segment_mean`` are K2.

The port uses dynamic shapes: segments are dense ids in [0, num_segments)
and every row belongs to one; there is no trash slot. Empty segments give
0 (the JAX encoders zero the -inf of an empty segment).

On a CPU tensor ``segment_max`` / ``segment_mean`` take their plain
versions (``segment_max_ref``: ``scatter_reduce`` amax; ``segment_mean_ref``:
``index_add_`` sums over the counts) and ignore ``layout``; on a CUDA
tensor they launch ``csrc/dynamic_scatter.cu`` or raise. The kernel reads
each segment's rows from a list, ``layout = (voxel_ptr, point_order)``
(int32 CSR offsets and rows, each segment's in increasing order): the one
K1 emits with a voxelization (``DynamicVoxels``), or one built from the
ids by K1's list stage (``voxel.segment_layout``) when the caller passes
none. Both are autograd functions. The max's gradient goes in equal parts
to the rows equal to the maximum, as ``jax.ops.segment_max`` splits it
(PyTorch's own ``scatter_reduce`` backward also counts the zero it starts
from when a maximum is exactly 0, so the plain version spells the split
out). The mean's gradient is the segment's gradient over its count. The
kernel's max, forward and backward, equals the plain version bit for bit;
its mean sums each segment's rows in increasing row order (the CPU's
``index_add_`` order), so it repeats from run to run on the card and
equals the plain version on the CPU bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_build
from .voxel import segment_layout

Layout = Tuple[torch.Tensor, torch.Tensor]


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


def _launch(op, data, ptr, order, out, grad_out=None, grad_in=None):
    def addr(t):
        return None if t is None else t.data_ptr()
    lib = cuda_build.load("dynamic_scatter")
    err = lib.dynamic_scatter(
        op, data.data_ptr(), ptr.data_ptr(), order.data_ptr(), data.shape[0],
        data.shape[1], out.shape[0], out.data_ptr(), addr(grad_out),
        addr(grad_in), torch.cuda.current_stream(data.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dynamic_scatter: kernel launch failed with CUDA "
                           f"error {err}")
    cuda_build.LAUNCHES["dynamic_scatter"] += 1


def _cuda_operands(name, data, ids, num_segments,
                   layout: Optional[Layout]):
    """data, int64 ids and the list (the caller's, checked, or K1's list
    stage's) for a kernel launch."""
    if data.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {data.device}")
    if data.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 data")
    ids = ids.to(torch.int64).contiguous()
    if layout is None:
        ptr, order = segment_layout(ids, num_segments)
    else:
        ptr, order = layout
        if ptr.dtype != torch.int32 or order.dtype != torch.int32 or \
                tuple(ptr.shape) != (num_segments + 1,) or \
                tuple(order.shape) != (data.shape[0],) or \
                ptr.device != data.device or order.device != data.device:
            raise ValueError(
                f"{name}: layout (voxel_ptr (S + 1,), point_order (P,)) "
                f"int32 on {data.device}, got {ptr.dtype} "
                f"{tuple(ptr.shape)}, {order.dtype} {tuple(order.shape)}")
    return data.contiguous(), ids, ptr.contiguous(), order.contiguous()


def _reduce(op, data, ptr, order):
    out = torch.empty((ptr.shape[0] - 1, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    _launch(op, data, ptr, order, out)
    return out


class _SegmentMaxKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ptr, order):
        out = _reduce(0, data, ptr, order)
        ctx.save_for_backward(data, ptr, order, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        data, ptr, order, out = ctx.saved_tensors
        grad_in = torch.empty_like(data)
        _launch(1, data, ptr, order, out, grad_out=grad_out.contiguous(),
                grad_in=grad_in)
        return grad_in, None, None


class _SegmentMeanKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, ptr, order):
        ctx.save_for_backward(ids, ptr)
        return _reduce(2, data, ptr, order)

    @staticmethod
    def backward(ctx, grad_out):
        ids, ptr = ctx.saved_tensors
        count = (ptr[1:] - ptr[:-1]).to(grad_out.dtype).clamp_min(1.0)
        return (grad_out / count[:, None])[ids], None, None, None


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, layout: Optional[Layout] = None
                ) -> torch.Tensor:
    """(P, C) rows, (P,) ids in [0, num_segments) -> (num_segments, C)
    per-segment max; empty segments give 0 — K2. ``layout``: the
    segments' rows (``voxel_ptr``, ``point_order``) where the caller has
    them."""
    _check("segment_max", data, segment_ids, num_segments)
    if data.device.type == "cpu":
        return segment_max_ref(data, segment_ids, num_segments)
    data, _, ptr, order = _cuda_operands("segment_max", data, segment_ids,
                                         int(num_segments), layout)
    if not (data.requires_grad and torch.is_grad_enabled()):
        return _reduce(0, data, ptr, order)
    return _SegmentMaxKernel.apply(data, ptr, order)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, layout: Optional[Layout] = None
                 ) -> torch.Tensor:
    """(P, C) rows, (P,) ids in [0, num_segments) -> (num_segments, C)
    per-segment mean; empty segments give 0 — K2. ``layout`` as for
    ``segment_max``."""
    _check("segment_mean", data, segment_ids, num_segments)
    if data.device.type == "cpu":
        return segment_mean_ref(data, segment_ids, num_segments)
    data, ids, ptr, order = _cuda_operands("segment_mean", data, segment_ids,
                                           int(num_segments), layout)
    if not (data.requires_grad and torch.is_grad_enabled()):
        return _reduce(2, data, ptr, order)
    return _SegmentMeanKernel.apply(data, ids, ptr, order)
