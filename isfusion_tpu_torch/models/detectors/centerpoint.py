"""CenterPoint and DynamicCenterPoint (counterpart of
``isfusion_tpu/models/detectors/centerpoint.py``): the MVX LiDAR branch
-> SparseEncoder -> SECOND -> SECONDFPN -> CenterHead (K10-circle decode,
K11 targets). ``CenterPoint`` voxelizes as its config says (the 0.075 m
config: hard voxels -> HardSimpleVFE); ``DynamicCenterPoint`` runs
dynamic voxels (K1) -> DynamicVFE / DynamicSimpleVFE (K2) and raises on
a hard voxel layer (the JAX package would run it as hard voxels)."""
from __future__ import annotations

from ...registry import DETECTORS
from .mvx_two_stage import MVXTwoStageDetector


@DETECTORS.register_module()
class CenterPoint(MVXTwoStageDetector):
    """CenterPoint; hard or dynamic voxels by ``max_num_points``."""


@DETECTORS.register_module()
class DynamicCenterPoint(MVXTwoStageDetector):
    """CenterPoint on dynamic voxels (``max_num_points <= 0``)."""

    def __init__(self, pts_voxel_layer=None, **kwargs):
        if int(dict(pts_voxel_layer or {}).get("max_num_points", 32)) > 0:
            raise ValueError("DynamicCenterPoint voxelizes dynamically: set "
                             "pts_voxel_layer.max_num_points to -1 (or use "
                             "CenterPoint for hard voxels)")
        super().__init__(pts_voxel_layer=pts_voxel_layer, **kwargs)
