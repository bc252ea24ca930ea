"""Test-time augmentation wrapper (counterpart of
``isfusion_tpu/datasets/pipelines/test_time_aug.py``):
``MultiScaleFlipAug3D`` runs its transforms once per (point scale,
horizontal flip, vertical flip) variant on a copy of the sample and
returns the list of variants, each with its flips and scale in
'img_metas'. A one-variant list is unwrapped by the loader's collate; a
batch of several variants raises there, as in the JAX package (its
merge of variants is not ported)."""
from __future__ import annotations

import copy
from typing import Any, Dict, List

from ...registry import PIPELINES
from .compose import Compose


@PIPELINES.register_module()
class MultiScaleFlipAug3D:
    def __init__(self, transforms: List[dict], img_scale=None,
                 pts_scale_ratio=1.0, flip: bool = False,
                 flip_direction="horizontal",
                 pcd_horizontal_flip: bool = False,
                 pcd_vertical_flip: bool = False):
        self.transforms = Compose(transforms)
        self.pts_scale_ratio = (
            [float(pts_scale_ratio)] if isinstance(
                pts_scale_ratio, (int, float)) else
            [float(s) for s in pts_scale_ratio])
        self.flip = flip
        self.pcd_horizontal_flip = pcd_horizontal_flip
        self.pcd_vertical_flip = pcd_vertical_flip

    def __call__(self, results: Dict[str, Any]) -> List[Dict[str, Any]]:
        aug_data = []
        flips_h = [False, True] if (self.flip and
                                    self.pcd_horizontal_flip) else [False]
        flips_v = [False, True] if (self.flip and
                                    self.pcd_vertical_flip) else [False]
        for scale in self.pts_scale_ratio:
            for fh in flips_h:
                for fv in flips_v:
                    r = copy.deepcopy(results)
                    if "points" in r:
                        if fh:
                            r["points"].flip("horizontal")
                        if fv:
                            r["points"].flip("vertical")
                        if scale != 1.0:
                            r["points"].scale(scale)
                    r["pcd_horizontal_flip"] = fh
                    r["pcd_vertical_flip"] = fv
                    r["pcd_scale_factor"] = scale
                    out = self.transforms(r)
                    if out is not None:
                        out.setdefault("img_metas", {})
                        out["img_metas"].update(
                            pcd_horizontal_flip=fh, pcd_vertical_flip=fv,
                            pcd_scale_factor=scale)
                        aug_data.append(out)
        return aug_data
