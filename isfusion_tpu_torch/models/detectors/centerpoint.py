"""CenterPoint (counterpart of ``isfusion_tpu/models/detectors/
centerpoint.py``): the MVX LiDAR branch with hard voxelization ->
HardSimpleVFE -> SparseEncoder -> SECOND -> SECONDFPN -> CenterHead.
``DynamicCenterPoint`` (the dynamic-voxel branch) is not ported yet and
raises."""
from __future__ import annotations

from ...registry import DETECTORS
from .mvx_two_stage import MVXTwoStageDetector


@DETECTORS.register_module()
class CenterPoint(MVXTwoStageDetector):
    """Hard-voxelization CenterPoint."""


@DETECTORS.register_module()
class DynamicCenterPoint(MVXTwoStageDetector):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("DynamicCenterPoint is not ported yet (the "
                                  "MVX dynamic-voxel branch)")
