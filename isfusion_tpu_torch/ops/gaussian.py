"""Gaussian heatmap targets (counterpart of ``isfusion_tpu/ops/gaussian.py``;
reference ``mmdet3d/core/utils/gaussian.py``) — K11.

``draw_heatmap_gaussian_batch(shape_hw, centers_xy (..., N, 2), radii
(..., N), valid (..., N), labels (..., N), num_classes) -> (..., H, W,
num_classes)``: for each sample (the leading dims) and class, the maximum
over that class's valid objects of exp(-((x - cx)^2 + (y - cy)^2) / (2
sigma^2)), cx, cy the floored centres in grid units, sigma = (2 r + 1) /
6, inside the object's square window |x - cx| <= r, |y - cy| <= r, and 0
elsewhere: the JAX package's ``draw_heatmap_gaussian_batch`` of every
class at once. CenterHead's and TransFusionHeadV2's targets call it once
per train step.

On a CPU tensor it takes its plain PyTorch version
(``draw_heatmap_gaussian_batch_ref``: every object's gaussian on the whole
grid, the maximum per class by ``scatter_reduce``); on a CUDA tensor it
launches ``csrc/gaussian_heatmap.cu`` (one block per object over its
window, ``atomicMax`` on the float bits) or raises. Both evaluate the same
float32 expression in the same order, so the kernel's heatmap equals the
plain version's on the card, and the peaks are exactly 1. Valid objects
need a finite centre and a finite, non-negative radius.
"""
from __future__ import annotations

import math

import torch

from . import cuda_build


def gaussian_radius(det_size, min_overlap: float = 0.5):
    """Radius such that a shifted box still overlaps >= ``min_overlap``;
    ``det_size`` = (height, width) tensors (or numbers)."""
    height, width = det_size
    sqrt = torch.sqrt if torch.is_tensor(height) else (lambda v: v ** 0.5)
    relu = (lambda v: v.clamp_min(0)) if torch.is_tensor(height) else \
        (lambda v: max(v, 0))
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + sqrt(relu(b1 ** 2 - 4 * c1))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + sqrt(relu(b2 ** 2 - 16 * c2))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + sqrt(relu(b3 ** 2 - 4 * a3 * c3))) / 2
    if torch.is_tensor(height):
        return torch.minimum(torch.minimum(r1, r2), r3)
    return min(r1, r2, r3)


def _flat_args(centers_xy, radii, valid, labels):
    """(lead shape, N, centres (S, N, 2), radii, valid, labels (S, N))."""
    n = radii.shape[-1] if radii.dim() else 0
    lead = tuple(radii.shape[:-1])
    if radii.dim() < 1 or tuple(centers_xy.shape) != lead + (n, 2) or \
            tuple(valid.shape) != lead + (n,) or \
            tuple(labels.shape) != lead + (n,):
        raise ValueError(
            f"draw_heatmap_gaussian_batch: centres (..., N, 2), radii, valid "
            f"and labels (..., N), got {tuple(centers_xy.shape)}, "
            f"{tuple(radii.shape)}, {tuple(valid.shape)}, "
            f"{tuple(labels.shape)}")
    if len({centers_xy.device, radii.device, valid.device,
            labels.device}) != 1:
        raise ValueError("draw_heatmap_gaussian_batch: inputs on different "
                         "devices")
    s = math.prod(lead)
    return (lead, n, centers_xy.reshape(s, n, 2).float(),
            radii.reshape(s, n).float(), valid.reshape(s, n).bool(),
            labels.reshape(s, n).long())


def draw_heatmap_gaussian_batch_ref(shape_hw, centers_xy: torch.Tensor,
                                    radii: torch.Tensor, valid: torch.Tensor,
                                    labels: torch.Tensor, num_classes: int
                                    ) -> torch.Tensor:
    """Plain PyTorch version of ``draw_heatmap_gaussian_batch``."""
    h, w = shape_hw
    lead, n, c, r, v, lab = _flat_args(centers_xy, radii, valid, labels)
    dev = c.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    cx = torch.floor(c[..., 0])[..., None, None]
    cy = torch.floor(c[..., 1])[..., None, None]
    r = r[..., None, None]
    # a tensor divisor: true division on every device (CUDA multiplies by
    # the reciprocal of a Python scalar divisor)
    sigma = (2 * r + 1) / torch.full((), 6.0, device=dev)
    den = 2 * (sigma * sigma)
    dx, dy = xs - cx, ys - cy
    g = torch.exp(-(dx * dx + dy * dy) / den)
    inside = (dx.abs() <= r) & (dy.abs() <= r)
    ok = v & (lab >= 0) & (lab < num_classes)
    g = torch.where(inside & ok[..., None, None], g,
                    torch.zeros((), device=dev))
    heat = torch.zeros((c.shape[0], num_classes, h, w), dtype=torch.float32,
                       device=dev)
    if n:
        idx = lab.clamp(0, num_classes - 1)[..., None, None]
        heat.scatter_reduce_(1, idx.expand_as(g), g, "amax")
    return heat.permute(0, 2, 3, 1).reshape(lead + (h, w, num_classes))


def draw_heatmap_gaussian_batch(shape_hw, centers_xy: torch.Tensor,
                                radii: torch.Tensor, valid: torch.Tensor,
                                labels: torch.Tensor, num_classes: int
                                ) -> torch.Tensor:
    """(..., H, W, num_classes) max-combined gaussians of N objects per
    sample: centres (..., N, 2) (x, y) in grid units, radii, validity and
    labels (..., N); one kernel launch for all samples and classes."""
    h, w = (int(v) for v in shape_hw)
    lead, n, c, r, v, lab = _flat_args(centers_xy, radii, valid, labels)
    if c.device.type == "cpu":
        return draw_heatmap_gaussian_batch_ref(shape_hw, centers_xy, radii,
                                               valid, labels, num_classes)
    if c.device.type != "cuda":
        raise RuntimeError(f"draw_heatmap_gaussian_batch: no kernel for "
                           f"{c.device}")
    heat = torch.empty(lead + (h, w, num_classes), dtype=torch.float32,
                       device=c.device)
    if heat.numel() == 0 or n == 0:
        return heat.zero_()
    if c.shape[0] * n >= 2 ** 31:
        raise ValueError("draw_heatmap_gaussian_batch: at most 2**31 - 1 "
                         "objects")
    c, r, v, lab = (t.contiguous() for t in (c, r, v, lab))
    lib = cuda_build.load("gaussian_heatmap")
    stream = torch.cuda.current_stream(c.device).cuda_stream
    err = lib.gaussian_heatmap(c.data_ptr(), r.data_ptr(), v.data_ptr(),
                               lab.data_ptr(), heat.data_ptr(), c.shape[0],
                               n, h, w, num_classes, stream)
    if err != 0:
        raise RuntimeError(f"gaussian_heatmap: kernel launch failed with "
                           f"CUDA error {err}")
    cuda_build.LAUNCHES["gaussian_heatmap"] += 1
    return heat


def gaussian_heatmap_bytes(heat_shape, n_objects: int) -> int:
    """Least bytes K11 moves: the float32 heatmap written once, and each
    object's centre, radius, validity and label read once."""
    return 4 * math.prod(int(s) for s in heat_shape) + \
        n_objects * (8 + 4 + 1 + 8)
