"""Builders for the model types of the IS-Fusion predict path (counterpart
of ``isfusion_tpu/models/builder.py``): config dicts with a ``type`` key
become modules through the port's registries."""
from __future__ import annotations

from ..registry import (BACKBONES, DETECTORS, FUSION_LAYERS, HEADS,
                        MIDDLE_ENCODERS, NECKS, VOXEL_ENCODERS, build_from_cfg)
from .backbones.second import SECONDV2
from .backbones.swin import SwinTransformer
from .dense_heads.transfusion_head import TransFusionHeadV2
from .middle_encoders.isfusion_encoder import ISFusionEncoder
from .middle_encoders.sparse_encoder import SparseEncoder
from .necks.generalized_lss import GeneralizedLSSFPN
from .necks.second_fpn import SECONDFPN
from .voxel_encoders import DynamicVFE

for _reg, _cls in ((BACKBONES, SwinTransformer), (BACKBONES, SECONDV2),
                   (NECKS, GeneralizedLSSFPN), (NECKS, SECONDFPN),
                   (VOXEL_ENCODERS, DynamicVFE),
                   (MIDDLE_ENCODERS, SparseEncoder),
                   (FUSION_LAYERS, ISFusionEncoder),
                   (HEADS, TransFusionHeadV2)):
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
    ``flagship.build_isfusion_flagship`` initialises and places it)."""
    from .detectors import isfusion  # noqa: F401  (registers the detector)
    return build_from_cfg(dict(cfg), DETECTORS)
