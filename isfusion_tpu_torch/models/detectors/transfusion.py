"""TransFusionDetector, TransFusion-L (counterpart of
``isfusion_tpu/models/detectors/transfusion.py``; reference
``mmdet3d/models/detectors/transfusion.py``): the MVX LiDAR branch
(voxelization -> VFE -> SparseEncoder (K12) -> SECOND -> SECONDFPN) under
``TransFusionHeadV2`` on the BEV map alone: heatmap proposals, the
decoder, the Hungarian assignment with K10 in its IoU cost, and the
NMS-free decode. Weights carry from a reference checkpoint through the
JAX package's ``convert_detector_torch_to_flax`` (its
``convert_lidar_torch_to_flax`` numbers SECONDFPN's deconvs wrongly)."""
from __future__ import annotations

from ...registry import DETECTORS
from .mvx_two_stage import MVXTwoStageDetector


@DETECTORS.register_module()
class TransFusionDetector(MVXTwoStageDetector):
    """TransFusion-L; an image branch in the config is built and run for
    a PointFusion inside the voxel encoder, as in ``MVXTwoStageDetector``
    (the head takes the BEV map only)."""
