"""Builders for the model types of the IS-Fusion, PointPillars,
CenterPoint, MVX-Net, FCOS3D, VoxelNet, TransFusion-L, PartA2, SSN,
FreeAnchor, ImVoxelNet, VoteNet, H3DNet, SSD3DNet, GroupFree3DNet and
ImVoteNet paths, the PointNet++ and PAConv segmentors and SST's blocks
(counterpart of
``isfusion_tpu/models/builder.py``): config dicts with a ``type`` key
become modules through the port's registries."""
from __future__ import annotations

from ..registry import (BACKBONES, DETECTORS, FUSION_LAYERS, HEADS,
                        MIDDLE_ENCODERS, NECKS, SEGMENTORS, VOXEL_ENCODERS,
                        build_from_cfg)
from .backbones.multi_backbone import MultiBackbone
from .backbones.pointnet2 import PAConvSASSG, PointNet2SASSG
from .backbones.regnet import NoStemRegNet, RegNet
from .backbones.resnet import ResNet
from .backbones.second import SECOND, SECONDV2
from .backbones.swin import SwinTransformer
from .decode_heads.pointnet2_head import PAConvHead, PointNet2Head
from .dense_heads.anchor3d_head import Anchor3DHead
from .dense_heads.centerpoint_head import CenterHead
from .dense_heads.fcos_mono3d_head import FCOSMono3DHead
from .dense_heads.free_anchor3d_head import FreeAnchor3DHead
from .dense_heads.groupfree3d_head import GroupFree3DHead
from .dense_heads.shape_aware_head import ShapeAwareHead
from .dense_heads.ssd_3d_head import SSD3DHead
from .dense_heads.transfusion_head import TransFusionHeadV2
from .dense_heads.vote_head import VoteHead
from .fusion_layers.point_fusion import PointFusion
from .middle_encoders.isfusion_encoder import ISFusionEncoder
from .middle_encoders.pillar_scatter import PointPillarsScatter
from .middle_encoders.sparse_encoder import SparseEncoder
from .middle_encoders.sparse_unet import SparseUNet
from .necks.fpn import FPN
from .necks.generalized_lss import GeneralizedLSSFPN
from .necks.second_fpn import SECONDFPN
from .necks.yolox_pafpn import YOLOXPAFPN
from .roi_heads.part_aggregation_roi_head import PartAggregationROIHead
from .sst.sst import SRABlock, SSTv2
from .sst.sst_sparse import SSTInputLayerV2, SSTv2Sparse
from .voxel_encoders import (DynamicFusionVFE, DynamicPillarFeatureNet,
                             DynamicSimpleVFE, DynamicVFE, HardSimpleVFE,
                             HardVFE, PillarFeatureNet)

for _reg, _cls in ((BACKBONES, SwinTransformer), (BACKBONES, SECONDV2),
                   (BACKBONES, SECOND), (BACKBONES, ResNet),
                   (BACKBONES, RegNet), (BACKBONES, NoStemRegNet),
                   (BACKBONES, PointNet2SASSG), (BACKBONES, PAConvSASSG),
                   (BACKBONES, MultiBackbone), (BACKBONES, SSTv2),
                   (BACKBONES, SRABlock), (BACKBONES, SSTv2Sparse),
                   (MIDDLE_ENCODERS, SSTInputLayerV2),
                   (NECKS, GeneralizedLSSFPN), (NECKS, SECONDFPN),
                   (NECKS, FPN), (NECKS, YOLOXPAFPN),
                   (FUSION_LAYERS, PointFusion),
                   (VOXEL_ENCODERS, DynamicVFE), (VOXEL_ENCODERS, HardVFE),
                   (VOXEL_ENCODERS, PillarFeatureNet),
                   (VOXEL_ENCODERS, HardSimpleVFE),
                   (VOXEL_ENCODERS, DynamicSimpleVFE),
                   (VOXEL_ENCODERS, DynamicPillarFeatureNet),
                   (VOXEL_ENCODERS, DynamicFusionVFE),
                   (MIDDLE_ENCODERS, SparseEncoder),
                   (MIDDLE_ENCODERS, SparseUNet),
                   (MIDDLE_ENCODERS, PointPillarsScatter),
                   (FUSION_LAYERS, ISFusionEncoder),
                   (HEADS, TransFusionHeadV2), (HEADS, Anchor3DHead),
                   (HEADS, CenterHead), (HEADS, FCOSMono3DHead),
                   (HEADS, ShapeAwareHead), (HEADS, FreeAnchor3DHead),
                   (HEADS, PartAggregationROIHead), (HEADS, VoteHead),
                   (HEADS, SSD3DHead), (HEADS, GroupFree3DHead),
                   (HEADS, PointNet2Head), (HEADS, PAConvHead)):
    _reg.register_module(module=_cls)


def build_backbone(cfg, **kwargs):
    return build_from_cfg(cfg, BACKBONES, kwargs or None)


def build_neck(cfg, **kwargs):
    return build_from_cfg(cfg, NECKS, kwargs or None)


def build_head(cfg, **kwargs):
    return build_from_cfg(cfg, HEADS, kwargs or None)


def build_voxel_encoder(cfg, **kwargs):
    return build_from_cfg(cfg, VOXEL_ENCODERS, kwargs or None)


def build_middle_encoder(cfg, **kwargs):
    return build_from_cfg(cfg, MIDDLE_ENCODERS, kwargs or None)


def build_fusion_layer(cfg, **kwargs):
    return build_from_cfg(cfg, FUSION_LAYERS, kwargs or None)


def build_detector(cfg):
    """Build a detector from its config dict (on the CPU, uninitialised:
    the factories of ``flagship.py`` initialise and place it)."""
    from .detectors import (centerpoint, h3dnet,  # noqa: F401
                            imvoxelnet, indoor_variants, isfusion,
                            mvx_two_stage, parta2, single_stage_mono3d,
                            transfusion, voxelnet, votenet)
    return build_from_cfg(dict(cfg), DETECTORS)


def build_segmentor(cfg):
    """Build a segmentor from its config dict (on the CPU, uninitialised,
    as ``build_detector``)."""
    from .segmentors import encoder_decoder  # noqa: F401
    return build_from_cfg(dict(cfg), SEGMENTORS)
