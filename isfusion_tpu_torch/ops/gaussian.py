"""Gaussian heatmap targets (counterpart of ``isfusion_tpu/ops/gaussian.py``;
reference ``mmdet3d/core/utils/gaussian.py``). Plain PyTorch on the device
(a hand-written kernel is ROADMAP queue K11): every object's gaussian is
painted on the full grid and the maximum is taken per class."""
from __future__ import annotations

import torch


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


def draw_heatmap_gaussian_batch(shape_hw, centers_xy: torch.Tensor,
                                radii: torch.Tensor, valid: torch.Tensor,
                                labels: torch.Tensor, num_classes: int
                                ) -> torch.Tensor:
    """(H, W, num_classes) max-combined gaussians of N objects: centres
    (N, 2) (x, y) in grid units, radii (N,), validity (N,), labels (N,).
    Each gaussian is cut to its square window of half-width ``radius``."""
    h, w = shape_hw
    dev = centers_xy.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    cx = torch.floor(centers_xy[:, 0].float())[:, None, None]
    cy = torch.floor(centers_xy[:, 1].float())[:, None, None]
    r = radii.float()[:, None, None]
    sigma = (2 * r + 1) / 6.0
    g = torch.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sigma ** 2))
    inside = ((xs - cx).abs() <= r) & ((ys - cy).abs() <= r)
    ok = valid.bool() & (labels >= 0) & (labels < num_classes)
    g = torch.where(inside & ok[:, None, None], g,
                    torch.zeros((), device=dev))
    heat = torch.zeros((num_classes, h, w), dtype=torch.float32, device=dev)
    if g.shape[0]:
        idx = labels.long().clamp(0, num_classes - 1)[:, None, None]
        heat.scatter_reduce_(0, idx.expand_as(g), g, "amax")
    return heat.permute(1, 2, 0)
