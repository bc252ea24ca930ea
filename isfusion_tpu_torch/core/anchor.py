"""3D anchor generation (counterpart of ``isfusion_tpu/core/anchor.py``;
reference ``mmdet3d/core/anchor/anchor_3d_generator.py``).

A numpy copy of the JAX package's generators, so the port's anchors equal
``Anchor3DHead.anchors_for`` there exactly. Anchors depend only on the
config and the feature-map size; the head builds them once per size.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class Anchor3DRangeGenerator:
    """Anchors on a BEV grid over given 3D ranges.

    Each entry of ``ranges`` pairs with an entry of ``sizes`` (or a single
    range is shared). Output per level: (H, W, num_pairs, num_rots, box_dim)
    flattened to (N, box_dim) when reshape_out.
    """

    aligned = False

    def __init__(self, ranges: Sequence[Sequence[float]],
                 sizes: Sequence[Sequence[float]] = ((1.6, 3.9, 1.56),),
                 scales: Sequence[int] = (1,),
                 rotations: Sequence[float] = (0.0, 1.5707963),
                 custom_values: Sequence[float] = (),
                 reshape_out: bool = True,
                 size_per_range: bool = True, **unused):
        self.ranges = [list(map(float, r)) for r in ranges]
        self.sizes = [list(map(float, s)) for s in sizes]
        self.scales = list(scales)
        self.rotations = list(map(float, rotations))
        self.custom_values = list(map(float, custom_values))
        self.reshape_out = reshape_out
        if size_per_range and len(self.ranges) != len(self.sizes):
            assert len(self.ranges) == 1
            self.ranges = self.ranges * len(self.sizes)
        assert len(self.ranges) == len(self.sizes)

    @property
    def num_base_anchors(self) -> int:
        """anchors per grid location"""
        return len(self.rotations) * len(self.sizes)

    def _centers(self, n: int, lo: float, hi: float) -> np.ndarray:
        if self.aligned:
            step = (hi - lo) / n
            return lo + (np.arange(n) + 0.5) * step
        return np.linspace(lo, hi, n)

    def single_range_anchors(self, feature_size: Tuple[int, int],
                             anchor_range: Sequence[float],
                             size: Sequence[float],
                             scale: float = 1.0) -> np.ndarray:
        """(H, W, 1, num_rot, box_dim) anchors for one (range, size) pair;
        feature_size is (H=ny, W=nx)."""
        ny, nx = feature_size
        x_centers = self._centers(nx, anchor_range[0], anchor_range[3])
        y_centers = self._centers(ny, anchor_range[1], anchor_range[4])
        z_center = (anchor_range[2] + anchor_range[5]) / 2
        yy, xx, rr = np.meshgrid(y_centers, x_centers,
                                 np.array(self.rotations), indexing="ij")
        zz = np.full_like(xx, z_center)
        sz = np.array(size, np.float32) * scale
        dims = np.broadcast_to(sz, xx.shape + (3,))
        anchors = np.concatenate([np.stack([xx, yy, zz], -1), dims,
                                  rr[..., None]], -1).astype(np.float32)
        if self.custom_values:
            cv = np.broadcast_to(
                np.array(self.custom_values, np.float32),
                anchors.shape[:-1] + (len(self.custom_values),))
            anchors = np.concatenate([anchors, cv], -1)
        return anchors[:, :, None]

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]
                     ) -> List[np.ndarray]:
        """Anchors per feature level: (N, box_dim) if reshape_out, else
        (H, W, num_pairs * num_rot, box_dim)."""
        out = []
        for lvl, fs in enumerate(featmap_sizes):
            scale = self.scales[lvl] if lvl < len(self.scales) else \
                self.scales[0]
            anchors = np.concatenate(
                [self.single_range_anchors(fs, rng, size, scale)
                 for rng, size in zip(self.ranges, self.sizes)], axis=2)
            h, w, p, r, d = anchors.shape
            anchors = anchors.reshape(h, w, p * r, d)
            out.append(anchors.reshape(-1, d) if self.reshape_out
                       else anchors)
        return out


class AlignedAnchor3DRangeGenerator(Anchor3DRangeGenerator):
    """Anchor centres on grid-cell centres."""

    aligned = True


ANCHOR_GENERATORS = {c.__name__: c for c in (Anchor3DRangeGenerator,
                                             AlignedAnchor3DRangeGenerator)}


def build_anchor_generator(cfg: dict) -> Anchor3DRangeGenerator:
    cfg = dict(cfg)
    return ANCHOR_GENERATORS[cfg.pop("type")](**cfg)
