"""Carry the JAX package's IS-Fusion, PointPillars, CenterPoint, MVX-Net,
FCOS3D, VoxelNet, TransFusion-L, PartA2, SSN, FreeAnchor, ImVoxelNet,
VoteNet, H3DNet, MultiBackbone, SSD3DNet, GroupFree3DNet and ImVoteNet
variables, and SST backbones' (SSTv2, SSTv2Sparse, SRABlock; dot-product or
scaled-cosine attention, the latter's ``tau`` as it is), into the port's
state_dict.

``state_dict_from_jax(variables)`` takes ``{'params': ..., 'batch_stats':
...}`` as nested dicts of numpy arrays (what ``jax.device_get`` gives) and
returns a ``state_dict`` in the reference mmdet3d layout, which the port's
modules use. It inverts the JAX package's converter
(``isfusion_tpu/runner/full_ckpt_convert.py:convert_isfusion_torch_to_flax``)
layout by layout: Linear/Conv1d kernels transposed back, HWIO -> OIHW,
spconv (kz, ky, kx, in, out) -> (out, kz, ky, kx, in), per-head q/k/v/out
kernels -> ``in_proj_weight`` / ``out_proj``, BN scale/bias/mean/var ->
weight/bias/running_mean/running_var.

Two tensors are carried by what the JAX forward computes rather than by
that converter's arithmetic, because the two differ there:

- SECONDFPN deconvs: flax ``ConvTranspose`` applies its kernel spatially
  flipped relative to torch's ``conv_transpose2d``, so the kernel is
  flipped back;
- ``fusion_encoder.conv_fusion``: the LiDAR block of its input channels is
  reordered from the JAX BEV's z*C + c to the reference's c*D + z with the
  true image width and depth D (the JAX converter assumes 256 image
  channels and D = 2).

Single-stage trees name their modules without the ``pts_`` / ``img_``
prefixes: a camera detector (FCOS3D: ``backbone_m``, ``neck_m``,
``bbox_head_m``) and a VoxelNet (``voxel_encoder_m`` ...). They are read
with the prefixed rules and their keys given the reference's names
(``backbone.``, ``voxel_encoder.`` ...); the JAX FPN names its laterals by
input level (``lateral_{start_level + i}``), the reference from 0.
ImVoxelNet's tree is a camera detector's with an Anchor3DHead, read as
the reference's ``bbox_head.``, and a 3D neck that the JAX package's
converter leaves out: its ``neck_3d_m`` takes the port's own names
(``neck_3d.conv{i}a`` (OIDHW), ``bn{i}a``, ``out_conv.conv`` / ``.bn``).
PartA2's tree is read the same way, its ``rpn_head_m`` as the
reference's ``rpn_head.``; its SparseUNet's encoder takes the reference's
names (``middle_encoder.conv_input``, ``encoder_layers.encoder_layer{i}.
{j}``, ``conv_out``), while its decoder (``decoder_conv{i}``,
``decoder_up{i}``, ``decoder_same{i}``, ``decoder_merge{i}``), RoI head
(``roi_head.shared_{i}``, ``conv_cls``, ``conv_reg``), ``seg_head`` and
``part_head`` keep the JAX module's own names: they are not the
reference's lateral / merge / upsample layers or its sparse-conv bbox
head. The inverse convs' kernels take the spconv layout of the other
sparse convs.

The point detectors (VoteNet, H3DNet; a PointNet2SASSG or MultiBackbone
``backbone_m``) take the reference's names (``_POINT_RULES``): an SA or FP
level's ``mlp{scale}/fc{j}`` and ``bn{j}`` are ``backbone.SA_modules.{i}.
mlps.{scale}.layer{j}.conv`` (a (out, in, 1, 1) Conv2d weight) and
``.bn``; a MultiBackbone's streams are ``backbone.backbone_list.{i}.`` and
its ``agg_{i}`` / ``Norm_{i}`` ``backbone.aggregation_layers.layer{i}.conv``
(Conv1d) / ``.bn``; the VoteHead's ``vote_mlp`` is ``vote_module.
vote_conv.{j}``, ``vote_out`` ``vote_module.conv_out``, ``pred_mlp``
``conv_pred.shared_convs.layer{j}``. Its one ``conv_pred`` dense layer
goes to ``bbox_head.conv_pred.conv_out`` in the JAX column order, which
the port's ``ConvPred`` splits into the reference's ``conv_cls`` and
``conv_reg`` on load (only the head knows its widths). H3DNet's
``face_vote`` / ``edge_vote`` (VoteModules) and ``prim_proj`` (a Linear)
are the JAX package's own modules and keep its names.

The VoteNet family's variants are point trees too. Where the reference
module has a layer, its name is the reference's: 3DSSD's candidate
shift (``shift_mlp``, ``shift_out``) is ``bbox_head.vote_module.
vote_conv.{j}`` / ``conv_out`` and its ``aggregation`` ``bbox_head.
vote_aggregation``; Group-Free 3D's ``points_obj_cls`` is ``bbox_head.
points_obj_cls.mlp.layer{j}`` (its last dense layer ``layer{n}.conv``),
``conv_pred`` and ``prediction_head_{i}`` are ``conv_pred`` and
``prediction_heads.{i}`` (``shared_convs.layer{j}``, ``conv_cls``,
``conv_reg``), ``decoder_query_proj`` / ``decoder_key_proj`` keep their
names, and each ``decoder_{i}``'s position embeddings are
``decoder_self_posembeds.{i}`` / ``decoder_cross_posembeds.{i}``
(``position_embedding_head.{0,1,3}``). Where it has none, the port's own
names stand: 3DSSD's one prediction dense layer is ``bbox_head.
conv_pred.conv_out`` (the JAX column order), the decoder layers'
attention, FFN and norms are the port's ``TransformerDecoderLayer``'s
under ``decoder_layers.{i}`` (``self_attn``, ``multihead_attn``,
``linear1`` / ``2``, ``norm1``-``3``; mmcv names them otherwise), and
ImVoteNet's ``img_fuse`` keeps its name; its ``img_backbone_m`` is a
ResNet read by the camera rules (``img_backbone.``).

The segmentors (``EncoderDecoder3D``'s ``backbone_m`` and
``decode_head_m``) are point trees too: a PAConv SA layer ``sa{i}/
paconv{scale}_{j}`` is ``backbone.SA_modules.{i}.mlps.{scale}.layer{j}``
(its ``weight_bank`` as it is, in the reference's (C, M O) layout, its
``bn``, ScoreNet's ``fc{k}`` / ``bn{k}`` as ``scorenet.mlps.layer{k}.
conv`` / ``.bn`` and ``fc_out`` as the last ``layer{n}.conv``); the
head's ``fp{i}`` is ``decode_head.FP_modules.{i}.mlps``, ``pre_seg``
``decode_head.pre_seg_conv`` (Conv1d, BN) and ``cls_seg``
``decode_head.conv_seg``.

The port keeps its own copy of this mapping (it imports nothing of the
JAX package).
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_YOLOX = dict(reduce="reduce_layers", downsample="downsamples",
              out="out_convs")


def _sst_layer(m) -> str:
    """An SST layer's reference name from a ``block{b}_layer{l}`` or
    ``encoder_{i}`` match."""
    if m[1] is None:
        return f"pts_backbone.encoder_list.{m[2]}"
    return f"pts_backbone.block_list.{m[1]}.encoder_list.{m[2]}"


def _csp(name: str) -> str:
    """A JAX CSP layer's ConvModule name -> mmdet's (``block{j}/conv{k}``
    -> ``blocks.{j}.conv{k}``)."""
    return re.sub(r"block(\d+)/", r"blocks.\1.", name)


# (module path regex over the JAX tree, reference key template, kind)
_ATTN = "mha"
_RULES = [
    # ------------------------------------------------------ image branch
    (r"img_backbone_m/patch_embed", "img_backbone.patch_embed.projection",
     "conv2d"),
    (r"img_backbone_m/patch_norm", "img_backbone.patch_embed.norm", "norm"),
    (r"img_backbone_m/out_norm(\d+)", r"img_backbone.norm\1", "norm"),
    (r"img_backbone_m/downsample(\d+)/norm",
     r"img_backbone.stages.\1.downsample.norm", "norm"),
    (r"img_backbone_m/downsample(\d+)/reduction",
     r"img_backbone.stages.\1.downsample.reduction", "dense"),
    (r"img_backbone_m/stage(\d+)_block(\d+)/(norm[12])",
     r"img_backbone.stages.\1.blocks.\2.\3", "norm"),
    (r"img_backbone_m/stage(\d+)_block(\d+)/ffn_fc1",
     r"img_backbone.stages.\1.blocks.\2.ffn.layers.0.0", "dense"),
    (r"img_backbone_m/stage(\d+)_block(\d+)/ffn_fc2",
     r"img_backbone.stages.\1.blocks.\2.ffn.layers.1", "dense"),
    (r"img_backbone_m/stage(\d+)_block(\d+)/attn/w_msa/(qkv|proj)",
     r"img_backbone.stages.\1.blocks.\2.attn.w_msa.\3", "dense"),
    (r"img_backbone_m/stage(\d+)_block(\d+)/attn/w_msa",
     r"img_backbone.stages.\1.blocks.\2.attn.w_msa", "same"),
    (r"img_neck_m/lateral_(\d+)/Conv_0", r"img_neck.lateral_convs.\1.conv",
     "conv2d"),
    (r"img_neck_m/lateral_(\d+)/bn", r"img_neck.lateral_convs.\1.bn", "norm"),
    (r"img_neck_m/fpn_(\d+)/Conv_0", r"img_neck.fpn_convs.\1.conv", "conv2d"),
    # YOLOXPAFPN: the JAX module's names -> mmdet's (a CSP layer's
    # ConvModules, its bottlenecks under ``blocks``)
    (r"img_neck_m/(reduce|downsample|out)_(\d+)/Conv_0",
     lambda m: f"img_neck.{_YOLOX[m[1]]}.{m[2]}.conv", "conv2d"),
    (r"img_neck_m/(reduce|downsample|out)_(\d+)/bn",
     lambda m: f"img_neck.{_YOLOX[m[1]]}.{m[2]}.bn", "norm"),
    (r"img_neck_m/(top_down|bottom_up)_(\d+)/(main_conv|short_conv|"
     r"final_conv|block\d+/conv[12])/Conv_0",
     lambda m: f"img_neck.{m[1]}_blocks.{m[2]}.{_csp(m[3])}.conv", "conv2d"),
    (r"img_neck_m/(top_down|bottom_up)_(\d+)/(main_conv|short_conv|"
     r"final_conv|block\d+/conv[12])/bn",
     lambda m: f"img_neck.{m[1]}_blocks.{m[2]}.{_csp(m[3])}.bn", "norm"),
    (r"img_neck_m/fpn_(\d+)/bn", r"img_neck.fpn_convs.\1.bn", "norm"),
    # ResNet (mmdet names) and FPN (its extra convs numbered after the
    # output convs, below)
    (r"img_backbone_m/conv1", "img_backbone.conv1", "conv2d"),
    (r"img_backbone_m/bn1/BatchNorm_0", "img_backbone.bn1", "norm"),
    (r"img_backbone_m/layer(\d+)_(\d+)/(conv[123])",
     r"img_backbone.layer\1.\2.\3", "conv2d"),
    (r"img_backbone_m/layer(\d+)_(\d+)/(bn[123])/BatchNorm_0",
     r"img_backbone.layer\1.\2.\3", "norm"),
    (r"img_backbone_m/layer(\d+)_(\d+)/downsample",
     r"img_backbone.layer\1.\2.downsample.0", "conv2d"),
    (r"img_backbone_m/layer(\d+)_(\d+)/downsample_bn/BatchNorm_0",
     r"img_backbone.layer\1.\2.downsample.1", "norm"),
    (r"img_neck_m/(fpn_conv|extra_conv)_(\d+)/Conv_0",
     r"img_neck.\1s.\2.conv", "conv2d"),
    (r"img_neck_m/(fpn_conv|extra_conv)_(\d+)/bn", r"img_neck.\1s.\2.bn",
     "norm"),
    # ------------------------------------------------------------- LiDAR
    (r"pts_voxel_encoder_m/LinearNormAct_(\d+)/Dense_0",
     r"pts_voxel_encoder.vfe_layers.\1.linear", "dense"),
    (r"pts_voxel_encoder_m/LinearNormAct_(\d+)/bn",
     r"pts_voxel_encoder.vfe_layers.\1.norm", "norm"),
    # MVX-Net's PointFusion inside DynamicVFE: its MaskedBatchNorms are
    # numbered img_transform's, pts_transform's, fuse's
    (r"pts_voxel_encoder_m/PointFusion_0/lateral_(\d+)/Conv_0",
     r"pts_voxel_encoder.fusion_layer.lateral_convs.\1.conv", "conv2d"),
    (r"pts_voxel_encoder_m/PointFusion_0/lateral_(\d+)/bn",
     r"pts_voxel_encoder.fusion_layer.lateral_convs.\1.bn", "norm"),
    (r"pts_voxel_encoder_m/PointFusion_0/(img_transform|pts_transform)",
     r"pts_voxel_encoder.fusion_layer.\1.0", "dense"),
    (r"pts_voxel_encoder_m/PointFusion_0/fuse",
     "pts_voxel_encoder.fusion_layer.fuse_conv.0", "dense"),
    (r"pts_voxel_encoder_m/PointFusion_0/bn",
     "pts_voxel_encoder.fusion_layer.img_transform.1", "norm"),
    (r"pts_voxel_encoder_m/PointFusion_0/MaskedBatchNorm_1",
     "pts_voxel_encoder.fusion_layer.pts_transform.1", "norm"),
    (r"pts_voxel_encoder_m/PointFusion_0/MaskedBatchNorm_2",
     "pts_voxel_encoder.fusion_layer.fuse_conv.1", "norm"),
    (r"pts_middle_encoder_m/(conv_input|conv_out)",
     r"pts_middle_encoder.\1.0", "sparse"),
    (r"pts_middle_encoder_m/(conv_input|conv_out)/bn",
     r"pts_middle_encoder.\1.1", "norm"),
    (r"pts_middle_encoder_m/encoder_layer(\d+)_(\d+)(?:_proj)?",
     r"pts_middle_encoder.encoder_layers.encoder_layer\1.\2.0", "sparse"),
    (r"pts_middle_encoder_m/encoder_layer(\d+)_(\d+)(?:_proj)?/bn",
     r"pts_middle_encoder.encoder_layers.encoder_layer\1.\2.1", "norm"),
    # SparseUNet's decoder (PartA2): the JAX module's own names
    (r"pts_middle_encoder_m/(decoder_(?:conv|up|same|merge)\d+)",
     r"pts_middle_encoder.\1.0", "sparse"),
    (r"pts_middle_encoder_m/(decoder_(?:conv|up|same|merge)\d+)/bn",
     r"pts_middle_encoder.\1.1", "norm"),
    (r"pts_middle_encoder_m/encoder_layer(\d+)_(\d+)/_SparseConvModule_0",
     r"pts_middle_encoder.encoder_layers.encoder_layer\1.\2.conv1", "sparse"),
    (r"pts_middle_encoder_m/encoder_layer(\d+)_(\d+)/_SparseConvModule_0/bn",
     r"pts_middle_encoder.encoder_layers.encoder_layer\1.\2.bn1", "norm"),
    (r"pts_middle_encoder_m/encoder_layer(\d+)_(\d+)/_SparseConvModule_1",
     r"pts_middle_encoder.encoder_layers.encoder_layer\1.\2.conv2", "sparse"),
    (r"pts_middle_encoder_m/encoder_layer(\d+)_(\d+)/_SparseConvModule_1/bn",
     r"pts_middle_encoder.encoder_layers.encoder_layer\1.\2.bn2", "norm"),
    # ------------------------------------------------------------ fusion
    (r"fusion_encoder_m/(conv_fusion|conv_ins|conv_scene|conv_heatmap|"
     r"heatmap_head_[12])/Conv_0", r"fusion_encoder.\1.conv", "conv2d"),
    (r"fusion_encoder_m/(conv_fusion|conv_ins|conv_scene|conv_heatmap|"
     r"heatmap_head_[12])/bn", r"fusion_encoder.\1.bn", "norm"),
    (r"fusion_encoder_m/heatmap_head_3", "fusion_encoder.heatmap_head_3",
     "conv2d"),
    (r"fusion_encoder_m/grid2region_(\d+)/linear0",
     r"fusion_encoder.grid2region_att.\1.linear0", "dense"),
    (r"fusion_encoder_m/grid2region_(\d+)/block(\d+)_layer(\d+)/win_attn",
     r"fusion_encoder.grid2region_att.\1.block_list.\2.encoder_list.\3"
     r".win_attn.self_attn", _ATTN),
    (r"fusion_encoder_m/grid2region_(\d+)/block(\d+)_layer(\d+)/"
     r"(linear[12])",
     r"fusion_encoder.grid2region_att.\1.block_list.\2.encoder_list.\3.\4",
     "dense"),
    (r"fusion_encoder_m/grid2region_(\d+)/block(\d+)_layer(\d+)/(norm[12])",
     r"fusion_encoder.grid2region_att.\1.block_list.\2.encoder_list.\3.\4",
     "norm"),
    (r"fusion_encoder_m/instance_att/(key_pos_embed|query_pos_embed)/fc1",
     r"fusion_encoder.instance_att.\1.position_embedding_head.0", "conv1d"),
    (r"fusion_encoder_m/instance_att/(key_pos_embed|query_pos_embed)/bn",
     r"fusion_encoder.instance_att.\1.position_embedding_head.1", "norm"),
    (r"fusion_encoder_m/instance_att/(key_pos_embed|query_pos_embed)/fc2",
     r"fusion_encoder.instance_att.\1.position_embedding_head.3", "conv1d"),
    (r"fusion_encoder_m/instance_att/layer_(\d+)/cross_attn/(\w+)",
     r"fusion_encoder.instance_att.layers.\1.cross_attn.\2", "dense"),
    (r"fusion_encoder_m/instance_att/layer_(\d+)/self_attn",
     r"fusion_encoder.instance_att.layers.\1.self_attn", _ATTN),
    (r"fusion_encoder_m/instance_att/layer_(\d+)/(linear[12])",
     r"fusion_encoder.instance_att.layers.\1.\2", "dense"),
    (r"fusion_encoder_m/instance_att/layer_(\d+)/(norm[123])",
     r"fusion_encoder.instance_att.layers.\1.\2", "norm"),
    (r"fusion_encoder_m/instance_to_scene_att/multihead_attn",
     "fusion_encoder.instance_to_scene_att.multihead_attn", _ATTN),
    (r"fusion_encoder_m/instance_to_scene_att/norm",
     "fusion_encoder.instance_to_scene_att.norm", "norm"),
    # SST as a backbone: SSTv2 / SSTv2Sparse layers ``block{b}_layer{l}``
    # and SRABlock's ``encoder_{i}`` take the reference BasicShiftBlockV2's
    # ``block_list.{b}.encoder_list.{l}`` / ``encoder_list.{i}``
    (r"pts_backbone_m/linear0", "pts_backbone.linear0", "dense"),
    (r"pts_backbone_m/(?:block(\d+)_layer|encoder_)(\d+)/win_attn",
     lambda m: _sst_layer(m) + ".win_attn.self_attn", _ATTN),
    (r"pts_backbone_m/(?:block(\d+)_layer|encoder_)(\d+)/(linear[12])",
     lambda m: f"{_sst_layer(m)}.{m[3]}", "dense"),
    (r"pts_backbone_m/(?:block(\d+)_layer|encoder_)(\d+)/(norm[12])",
     lambda m: f"{_sst_layer(m)}.{m[3]}", "norm"),
    # ---------------------------------------------------------- 2D BEV
    (r"pts_backbone_m/ds_layer/Conv_0", "pts_backbone.ds_layer.0", "conv2d"),
    (r"pts_backbone_m/ds_layer/bn", "pts_backbone.ds_layer.1", "norm"),
    (r"pts_backbone_m/block(\d+)/ConvModule_(\d+)/Conv_0",
     lambda m: f"pts_backbone.blocks.{m[1]}.{3 * int(m[2])}", "conv2d"),
    (r"pts_backbone_m/block(\d+)/ConvModule_(\d+)/bn",
     lambda m: f"pts_backbone.blocks.{m[1]}.{3 * int(m[2]) + 1}", "norm"),
    (r"pts_backbone_m/_SECONDBlock_(\d+)/ConvModule_(\d+)/Conv_0",
     lambda m: f"pts_backbone.blocks.{m[1]}.{3 * int(m[2])}", "conv2d"),
    (r"pts_backbone_m/_SECONDBlock_(\d+)/ConvModule_(\d+)/bn",
     lambda m: f"pts_backbone.blocks.{m[1]}.{3 * int(m[2]) + 1}", "norm"),
    # RegNet / NoStemRegNet (mmdet names: the stem is conv1 / bn1, stage
    # i is layer{i + 1}); a grouped kernel (kh, kw, in / groups, out)
    # becomes (out, in / groups, kh, kw) as any other conv's
    (r"pts_backbone_m/stem/Conv_0", "pts_backbone.conv1", "conv2d"),
    (r"pts_backbone_m/stem/bn", "pts_backbone.bn1", "norm"),
    (r"pts_backbone_m/stage(\d+)_block(\d+)/conv([123])/Conv_0",
     lambda m: f"pts_backbone.layer{int(m[1]) + 1}.{m[2]}.conv{m[3]}",
     "conv2d"),
    (r"pts_backbone_m/stage(\d+)_block(\d+)/conv([123])/bn",
     lambda m: f"pts_backbone.layer{int(m[1]) + 1}.{m[2]}.bn{m[3]}", "norm"),
    (r"pts_backbone_m/stage(\d+)_block(\d+)/downsample/Conv_0",
     lambda m: f"pts_backbone.layer{int(m[1]) + 1}.{m[2]}.downsample.0",
     "conv2d"),
    (r"pts_backbone_m/stage(\d+)_block(\d+)/downsample/bn",
     lambda m: f"pts_backbone.layer{int(m[1]) + 1}.{m[2]}.downsample.1",
     "norm"),
    # FPN as the LiDAR neck (FreeAnchor): laterals and output convs
    (r"pts_neck_m/lateral_(\d+)/Conv_0", r"pts_neck.lateral_convs.\1.conv",
     "conv2d"),
    (r"pts_neck_m/lateral_(\d+)/bn", r"pts_neck.lateral_convs.\1.bn", "norm"),
    (r"pts_neck_m/fpn_conv_(\d+)/Conv_0", r"pts_neck.fpn_convs.\1.conv",
     "conv2d"),
    (r"pts_neck_m/fpn_conv_(\d+)/bn", r"pts_neck.fpn_convs.\1.bn", "norm"),
    (r"pts_neck_m/ConvModule_(\d+)/Conv_0", r"pts_neck.deblocks.\1.0",
     "conv2d"),
    (r"pts_neck_m/ConvModule_(\d+)/bn", r"pts_neck.deblocks.\1.1", "norm"),
    # deconv blocks follow the stride-1 conv blocks (numbered after them)
    (r"pts_neck_m/ConvTransposeModule_(\d+)/ConvTranspose_0",
     r"pts_neck.deconv.\1.0", "deconv"),
    (r"pts_neck_m/ConvTransposeModule_(\d+)/bn", r"pts_neck.deconv.\1.1",
     "norm"),
    # ImVoxelNet's 3D neck (the port's own names: the JAX module's three
    # conv + BN stages and its out ConvModule)
    (r"neck3d_m/conv(\d)a", r"neck_3d.conv\1a", "conv3d"),
    (r"neck3d_m/bn(\d)a", r"neck_3d.bn\1a", "norm"),
    (r"neck3d_m/out_conv/Conv_0", "neck_3d.out_conv.conv", "conv2d"),
    (r"neck3d_m/out_conv/bn", "neck_3d.out_conv.bn", "norm"),
    # -------------------------------------------------------------- head
    # PartA2's RoI head and part-aware heads (the JAX module's layers)
    (r"roi_head_m/(shared_\d+|conv_cls|conv_reg)", r"roi_head.\1", "dense"),
    (r"(seg_head|part_head)", r"\1", "dense"),
    (r"pts_bbox_head_m/(conv_cls|conv_reg|conv_dir_cls)",
     r"pts_bbox_head.\1", "conv2d"),
    (r"pts_bbox_head_m/shared_conv", "pts_bbox_head.shared_conv", "conv2d"),
    # ShapeAwareHead (SSN): per-task shared ConvModules and 1x1 convs
    (r"pts_bbox_head_m/task(\d+)_conv(\d+)/Conv_0",
     r"pts_bbox_head.heads.\1.shared_conv.\2.conv", "conv2d"),
    (r"pts_bbox_head_m/task(\d+)_conv(\d+)/bn",
     r"pts_bbox_head.heads.\1.shared_conv.\2.bn", "norm"),
    (r"pts_bbox_head_m/task(\d+)_(conv_cls|conv_reg|conv_dir_cls)",
     r"pts_bbox_head.heads.\1.\2", "conv2d"),
    # CenterHead: a ConvModule shared conv and per-task SeparateHeads (the
    # final conv's index, num_conv - 1, is set after the walk)
    (r"pts_bbox_head_m/shared_conv/Conv_0", "pts_bbox_head.shared_conv.conv",
     "conv2d"),
    (r"pts_bbox_head_m/shared_conv/bn", "pts_bbox_head.shared_conv.bn",
     "norm"),
    (r"pts_bbox_head_m/task_heads_(\d+)/([a-z]+)_(\d+)/Conv_0",
     r"pts_bbox_head.task_heads.\1.\2.\3.conv", "conv2d"),
    (r"pts_bbox_head_m/task_heads_(\d+)/([a-z]+)_(\d+)/bn",
     r"pts_bbox_head.task_heads.\1.\2.\3.bn", "norm"),
    (r"pts_bbox_head_m/task_heads_(\d+)/([a-z]+)_final",
     r"pts_bbox_head.task_heads.\1.\2.final", "conv2d"),
    # FCOSMono3DHead: GN ConvModule towers, 1x1 branch convs, level scales
    (r"bbox_head_m/(cls_convs|reg_convs|conv_cls_prev|conv_attr_prev|"
     r"conv_centerness_prev)_(\d+)/Conv_0", r"bbox_head.\1.\2.conv", "conv2d"),
    (r"bbox_head_m/(cls_convs|reg_convs|conv_cls_prev|conv_attr_prev|"
     r"conv_centerness_prev)_(\d+)/gn", r"bbox_head.\1.\2.gn", "norm"),
    (r"bbox_head_m/conv_dir_prev_(\d+)/Conv_0",
     r"bbox_head.conv_dir_cls_prev.\1.conv", "conv2d"),
    (r"bbox_head_m/conv_dir_prev_(\d+)/gn", r"bbox_head.conv_dir_cls_prev.\1.gn",
     "norm"),
    (r"bbox_head_m/conv_reg_prev_(\d+)_(\d+)/Conv_0",
     r"bbox_head.conv_reg_prevs.\1.\2.conv", "conv2d"),
    (r"bbox_head_m/conv_reg_prev_(\d+)_(\d+)/gn",
     r"bbox_head.conv_reg_prevs.\1.\2.gn", "norm"),
    (r"bbox_head_m/conv_reg_(\d+)", r"bbox_head.conv_regs.\1", "conv2d"),
    (r"bbox_head_m/(conv_cls|conv_dir_cls|conv_attr|conv_centerness)",
     r"bbox_head.\1", "conv2d"),
    (r"bbox_head_m/scale(\d+)_offset", r"bbox_head.scales.\1.0", "leaf"),
    (r"bbox_head_m/scale(\d+)_depth", r"bbox_head.scales.\1.1", "leaf"),
    (r"bbox_head_m/scale(\d+)_size", r"bbox_head.scales.\1.2", "leaf"),
    (r"pts_bbox_head_m/heatmap_conv/Conv_0",
     "pts_bbox_head.heatmap_head.0.conv", "conv2d"),
    (r"pts_bbox_head_m/heatmap_conv/bn", "pts_bbox_head.heatmap_head.0.bn",
     "norm"),
    (r"pts_bbox_head_m/heatmap_out", "pts_bbox_head.heatmap_head.1",
     "conv2d"),
    (r"pts_bbox_head_m/class_encoding", "pts_bbox_head.class_encoding",
     "conv1d"),
    (r"pts_bbox_head_m/decoder_(\d+)/self_attn",
     r"pts_bbox_head.decoder.\1.self_attn", _ATTN),
    (r"pts_bbox_head_m/decoder_(\d+)/cross_attn",
     r"pts_bbox_head.decoder.\1.multihead_attn", _ATTN),
    (r"pts_bbox_head_m/decoder_(\d+)/(self_posembed|cross_posembed)/fc1",
     r"pts_bbox_head.decoder.\1.\2.position_embedding_head.0", "conv1d"),
    (r"pts_bbox_head_m/decoder_(\d+)/(self_posembed|cross_posembed)/bn",
     r"pts_bbox_head.decoder.\1.\2.position_embedding_head.1", "norm"),
    (r"pts_bbox_head_m/decoder_(\d+)/(self_posembed|cross_posembed)/fc2",
     r"pts_bbox_head.decoder.\1.\2.position_embedding_head.3", "conv1d"),
    (r"pts_bbox_head_m/decoder_(\d+)/(linear[12])",
     r"pts_bbox_head.decoder.\1.\2", "dense"),
    (r"pts_bbox_head_m/decoder_(\d+)/(norm[123])",
     r"pts_bbox_head.decoder.\1.\2", "norm"),
    (r"pts_bbox_head_m/pred_(\d+)/([a-z]+)_0",
     r"pts_bbox_head.prediction_heads.\1.\2.0.conv", "conv1d"),
    (r"pts_bbox_head_m/pred_(\d+)/([a-z]+)_0_bn",
     r"pts_bbox_head.prediction_heads.\1.\2.0.bn", "norm"),
    (r"pts_bbox_head_m/pred_(\d+)/([a-z]+)_final",
     r"pts_bbox_head.prediction_heads.\1.\2.1", "conv1d"),
]
_RULES = [(re.compile(p), t, k) for p, t, k in _RULES]

_NORM_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _module_path(path: Tuple[str, ...]) -> str:
    """JAX module path with flax's norm wrappers folded to ``bn``."""
    s = "/".join(path)
    s = re.sub(r"/Norm_0/GroupNorm_0$", "/gn", s)
    s = re.sub(r"/Norm_0/BatchNorm_0$", "/bn", s)
    return re.sub(r"/MaskedBatchNorm_0$", "/bn", s)


def _resolve(mod: str):
    for pat, tmpl, kind in _RULES:
        m = pat.fullmatch(mod)
        if m:
            key = tmpl(m) if callable(tmpl) else m.expand(tmpl)
            return key, kind
    raise KeyError(f"no reference key for JAX module {mod!r}")


def _rel_pos_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def fusion_lidar_perm(n_img: int, c_lidar: int, depth: int) -> np.ndarray:
    """Index map over conv_fusion's input channels: reference-layout input
    channel ``perm[i]`` feeds the port's (z*C + c ordered) channel i."""
    cc = c_lidar // depth
    lid = np.arange(c_lidar).reshape(cc, depth).T.reshape(-1)
    return np.concatenate([np.arange(n_img), n_img + lid])


# single-stage trees: JAX top-level module -> the prefixed name its rules
# read, and the reference prefix of the keys they give back
_VOXELNET_MODULES = {"voxel_encoder_m": "pts_voxel_encoder_m",
                     "middle_encoder_m": "pts_middle_encoder_m",
                     "backbone_m": "pts_backbone_m", "neck_m": "pts_neck_m",
                     "bbox_head_m": "pts_bbox_head_m"}
_CAMERA_MODULES = {"backbone_m": "img_backbone_m", "neck_m": "img_neck_m"}


def _renamed(variables: Dict, names: Dict[str, str]) -> Dict:
    return {c: {names.get(k, k): v for k, v in t.items()}
            for c, t in variables.items()}


_SA = r"(?:backbone_m/(?:PointNet2SASSG_(\d+)/)?)"
_POINT_RULES = [(re.compile(p), t, k) for p, t, k in [
    (_SA + r"sa(\d+)/mlp(\d+)/(fc|bn)(\d+)",
     lambda m: _stream(m) + f"SA_modules.{m[2]}.mlps.{m[3]}.layer{m[5]}", None),
    (_SA + r"fp(\d+)/mlp/(fc|bn)(\d+)",
     lambda m: _stream(m) + f"FP_modules.{m[2]}.mlps.layer{m[4]}", None),
    # PAConv SA layers: the bank, the layer's BN, ScoreNet's layers (its
    # last conv numbered after the walk, ``_point_state_dict``)
    (_SA + r"sa(\d+)/paconv(\d+)_(\d+)",
     lambda m: _stream(m) + f"SA_modules.{m[2]}.mlps.{m[3]}.layer{m[4]}",
     "leaf"),
    (_SA + r"sa(\d+)/paconv(\d+)_(\d+)/bn",
     lambda m: _stream(m) + f"SA_modules.{m[2]}.mlps.{m[3]}.layer{m[4]}.bn",
     "norm"),
    (_SA + r"sa(\d+)/paconv(\d+)_(\d+)/scorenet/(fc|bn)(\d+)",
     lambda m: _stream(m) + f"SA_modules.{m[2]}.mlps.{m[3]}.layer{m[4]}."
     f"scorenet.mlps.layer{m[6]}", None),
    (_SA + r"sa(\d+)/paconv(\d+)_(\d+)/scorenet/fc_out",
     lambda m: _stream(m) + f"SA_modules.{m[2]}.mlps.{m[3]}.layer{m[4]}."
     f"scorenet.mlps.out.conv", "conv2d1x1"),
    # a segmentor's decode head
    (r"decode_head_m/fp(\d+)/mlp/(fc|bn)(\d+)",
     r"decode_head.FP_modules.\1.mlps.layer\3", None),
    (r"decode_head_m/pre_seg/(fc|bn)0", "decode_head.pre_seg_conv", None),
    (r"decode_head_m/cls_seg", "decode_head.conv_seg", "conv1d"),
    (r"backbone_m/agg_(\d+)",
     r"backbone.aggregation_layers.layer\1.conv", "conv1d"),
    (r"backbone_m/Norm_(\d+)/BatchNorm_0",
     r"backbone.aggregation_layers.layer\1.bn", "norm"),
    (r"bbox_head_m/vote_module/vote_mlp/(fc|bn)(\d+)",
     r"bbox_head.vote_module.vote_conv.\2", None),
    (r"(face_vote|edge_vote)/vote_mlp/(fc|bn)(\d+)", r"\1.vote_conv.\3",
     None),
    (r"bbox_head_m/vote_module/vote_out", "bbox_head.vote_module.conv_out",
     "conv1d"),
    (r"(face_vote|edge_vote)/vote_out", r"\1.conv_out", "conv1d"),
    (r"bbox_head_m/vote_aggregation/mlp(\d+)/(fc|bn)(\d+)",
     r"bbox_head.vote_aggregation.mlps.\1.layer\3", None),
    (r"bbox_head_m/pred_mlp/(fc|bn)(\d+)",
     r"bbox_head.conv_pred.shared_convs.layer\2", None),
    (r"bbox_head_m/conv_pred", "bbox_head.conv_pred.conv_out", "conv1d"),
    (r"prim_proj", "prim_proj", "dense"),
    # SSD3DHead: the candidate shift as the reference's vote module
    (r"bbox_head_m/shift_mlp/(fc|bn)(\d+)",
     r"bbox_head.vote_module.vote_conv.\2", None),
    (r"bbox_head_m/shift_out", "bbox_head.vote_module.conv_out", "conv1d"),
    (r"bbox_head_m/aggregation/mlp(\d+)/(fc|bn)(\d+)",
     r"bbox_head.vote_aggregation.mlps.\1.layer\3", None),
    # GroupFree3DHead (the last objectness conv is numbered after the
    # walk, ``_point_state_dict``)
    (r"bbox_head_m/points_obj_cls/mlp/(fc|bn)(\d+)",
     r"bbox_head.points_obj_cls.mlp.layer\2", None),
    (r"bbox_head_m/points_obj_cls/out", "bbox_head.points_obj_cls.mlp.out",
     "conv1d"),
    (r"bbox_head_m/conv_pred/shared/(fc|bn)(\d+)",
     r"bbox_head.conv_pred.shared_convs.layer\2", None),
    (r"bbox_head_m/conv_pred/(conv_cls|conv_reg)", r"bbox_head.conv_pred.\1",
     "conv1d"),
    (r"bbox_head_m/prediction_head_(\d+)/shared/(fc|bn)(\d+)",
     r"bbox_head.prediction_heads.\1.shared_convs.layer\3", None),
    (r"bbox_head_m/prediction_head_(\d+)/(conv_cls|conv_reg)",
     r"bbox_head.prediction_heads.\1.\2", "conv1d"),
    (r"bbox_head_m/(decoder_query_proj|decoder_key_proj)", r"bbox_head.\1",
     "conv1d"),
    (r"bbox_head_m/decoder_(\d+)/(self|cross)_posembed/fc1",
     r"bbox_head.decoder_\2_posembeds.\1.position_embedding_head.0",
     "conv1d"),
    (r"bbox_head_m/decoder_(\d+)/(self|cross)_posembed/bn",
     r"bbox_head.decoder_\2_posembeds.\1.position_embedding_head.1", "norm"),
    (r"bbox_head_m/decoder_(\d+)/(self|cross)_posembed/fc2",
     r"bbox_head.decoder_\2_posembeds.\1.position_embedding_head.3",
     "conv1d"),
    (r"bbox_head_m/decoder_(\d+)/self_attn",
     r"bbox_head.decoder_layers.\1.self_attn", _ATTN),
    (r"bbox_head_m/decoder_(\d+)/cross_attn",
     r"bbox_head.decoder_layers.\1.multihead_attn", _ATTN),
    (r"bbox_head_m/decoder_(\d+)/(linear[12])",
     r"bbox_head.decoder_layers.\1.\2", "dense"),
    (r"bbox_head_m/decoder_(\d+)/(norm[123])",
     r"bbox_head.decoder_layers.\1.\2", "norm"),
    # ImVoteNet's image feature projection (the image backbone's names are
    # the camera detectors', ``_RULES``)
    (r"img_fuse", "img_fuse", "dense"),
]]


def _stream(m) -> str:
    """``backbone.`` or a MultiBackbone stream's ``backbone.backbone_list.
    {i}.``."""
    return "backbone." if m[1] is None else \
        f"backbone.backbone_list.{m[1]}."


def _attention(parts: Dict[str, np.ndarray], key: str,
               sd: Dict[str, np.ndarray]) -> None:
    """flax MHA's per-head query / key / value / out kernels and biases
    (``parts``: ``'{name}/{leaf}'``) -> ``nn.MultiheadAttention``'s
    ``in_proj_weight`` / ``in_proj_bias`` / ``out_proj`` under ``key``."""
    e = parts["query/kernel"].shape[0]
    sd[f"{key}.in_proj_weight"] = np.concatenate(
        [parts[f"{n}/kernel"].reshape(e, e).T
         for n in ("query", "key", "value")])
    sd[f"{key}.in_proj_bias"] = np.concatenate(
        [parts[f"{n}/bias"].reshape(e) for n in ("query", "key", "value")])
    sd[f"{key}.out_proj.weight"] = parts["out/kernel"].reshape(e, e).T
    sd[f"{key}.out_proj.bias"] = parts["out/bias"]


def _point_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """A point detector's or point backbone's tree (``_POINT_RULES``; an
    ImVoteNet's ``img_backbone_m`` by the camera rules)."""
    sd: Dict[str, np.ndarray] = {}
    attn: Dict[str, Dict[str, np.ndarray]] = {}
    image = {c: {"img_backbone_m": t["img_backbone_m"]}
             for c, t in variables.items() if "img_backbone_m" in t}
    for coll in ("params", "batch_stats"):
        for path, v in _flatten(variables.get(coll, {})):
            if path[0] == "img_backbone_m":
                continue
            mod, leaf = "/".join(path[:-1]), path[-1]
            if path[-2] in ("query", "key", "value", "out"):
                base = "/".join(path[:-2])
                hits = [m.expand(t) for p, t, k in _POINT_RULES if k == _ATTN
                        for m in [p.fullmatch(base)] if m]
                if hits:
                    attn.setdefault(hits[0], {})[f"{path[-2]}/{leaf}"] = v
                    continue
            for pat, tmpl, kind in _POINT_RULES:
                m = pat.fullmatch(mod)
                if m:
                    break
            else:
                raise KeyError(f"no reference key for JAX module {mod!r}")
            key = tmpl(m) if callable(tmpl) else m.expand(tmpl)
            if kind is None:       # a shared-MLP layer: conv or its BN
                is_bn = mod.rsplit("/", 1)[-1].startswith("bn")
                kind = "norm" if is_bn else (
                    "conv2d1x1" if "SA_modules" in key or "FP_modules" in key
                    or "vote_aggregation" in key else "conv1d")
                key += ".bn" if is_bn else ".conv"
            if kind == "norm":
                sd[f"{key}.{_NORM_LEAF[leaf]}"] = v
                if leaf == "mean":
                    sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)
            elif kind == "leaf":
                sd[f"{key}.{leaf}"] = v
            elif leaf == "bias":
                sd[f"{key}.bias"] = v
            else:
                sd[f"{key}.weight"] = {
                    "dense": v.T, "conv1d": v.T[:, :, None],
                    "conv2d1x1": v.T[:, :, None, None]}[kind]
    for key, parts in attn.items():
        _attention(parts, key, sd)
    # the objectness module's last conv follows its shared layers
    head = "bbox_head.points_obj_cls.mlp."
    n = len({k.split(".")[3] for k in sd if k.startswith(head + "layer")})
    for leaf in ("weight", "bias"):
        if f"{head}out.{leaf}" in sd:
            sd[f"{head}layer{n}.conv.{leaf}"] = sd.pop(f"{head}out.{leaf}")
    # ScoreNet's last conv follows its hidden layers
    outs = [k for k in sd if ".scorenet.mlps.out.conv." in k]
    depth = {base: len({x[len(base) + 1:].split(".")[0] for x in sd
                        if x.startswith(base + ".layer")})
             for base in {k.split(".out.conv.")[0] for k in outs}}
    for k in outs:
        base, leaf = k.split(".out.conv.")
        sd[f"{base}.layer{depth[base]}.conv.{leaf}"] = sd.pop(k)
    out = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if image:
        out.update(state_dict_from_jax(image))
    return out


def _is_point_tree(params: Dict) -> bool:
    head = params.get("bbox_head_m", {})
    return "prim_proj" in params or any(
        k in head for k in ("vote_module", "shift_mlp", "points_obj_cls")) \
        or any(re.fullmatch(r"(sa|fp)\d+|PointNet2SASSG_\d+", k)
               for k in params.get("backbone_m", {}))


def state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` -> the port's state_dict
    (reference layout), buffers included."""
    params = variables.get("params", {})
    if _is_point_tree(params):
        return _point_state_dict(variables)
    if "neck_3d_m" in params:
        # ImVoxelNet: the camera branch's names, the head's as a LiDAR
        # head's, the 3D neck's own
        sd = state_dict_from_jax(_renamed(
            variables, {"bbox_head_m": "pts_bbox_head_m",
                        "neck_3d_m": "neck3d_m"}))
        return {("bbox_head." + k[len("pts_bbox_head."):]
                 if k.startswith("pts_bbox_head.") else k): v
                for k, v in sd.items()}
    if "rpn_head_m" in params:
        names = dict(_VOXELNET_MODULES, rpn_head_m="pts_bbox_head_m")
        sd = state_dict_from_jax(_renamed(variables, names))
        return {("rpn_head." + k[len("pts_bbox_head."):]
                 if k.startswith("pts_bbox_head.") else
                 k[len("pts_"):] if k.startswith("pts_") else k): v
                for k, v in sd.items()}
    if "voxel_encoder_m" in params or "middle_encoder_m" in params:
        sd = state_dict_from_jax(_renamed(variables, _VOXELNET_MODULES))
        return {k[len("pts_"):] if k.startswith("pts_") else k: v
                for k, v in sd.items()}
    if any(k in params for k in _CAMERA_MODULES):
        sd = state_dict_from_jax(_renamed(variables, _CAMERA_MODULES))
        lat = sorted({int(k.split(".")[2]) for k in sd
                      if k.startswith("img_neck.lateral_convs.")})
        out = {}
        for k, v in sd.items():
            if k.startswith("img_neck.lateral_convs."):
                _, _, i, rest = k.split(".", 3)
                k = f"img_neck.lateral_convs.{int(i) - lat[0]}.{rest}"
            out[k[len("img_"):] if k.startswith(("img_backbone.",
                                                 "img_neck.")) else k] = v
        return out
    sd: Dict[str, np.ndarray] = {}
    attn: Dict[str, Dict[str, np.ndarray]] = {}
    for coll in ("params", "batch_stats"):
        for path, v in _flatten(variables.get(coll, {})):
            leaf = path[-1]
            if path[-2] in ("query", "key", "value", "out"):
                key, kind = _resolve(_module_path(path[:-2]))
                if kind == _ATTN:
                    attn.setdefault(key, {})[f"{path[-2]}/{leaf}"] = v
                    continue
            key, kind = _resolve(_module_path(path[:-1]))
            if kind == _ATTN:          # the cosine attention's ``tau``
                sd[f"{key}.{leaf}"] = v
                continue
            if kind == "norm":
                sd[f"{key}.{_NORM_LEAF[leaf]}"] = v
                if leaf == "mean":
                    sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)
                continue
            if kind == "leaf":
                sd[f"{key}.{leaf}"] = v
                continue
            if kind == "same":
                sd[f"{key}.{leaf}"] = v
                ws = (int(round(np.sqrt(v.shape[0]))) + 1) // 2
                sd[f"{key}.relative_position_index"] = _rel_pos_index(ws)
                continue
            if leaf == "bias":
                sd[f"{key}.bias"] = v
                continue
            w = {"dense": lambda a: a.T,
                 "conv1d": lambda a: a.T[:, :, None],
                 "conv2d": lambda a: a.transpose(3, 2, 0, 1),
                 "conv3d": lambda a: a.transpose(4, 3, 0, 1, 2),
                 "deconv": lambda a: a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1],
                 "sparse": lambda a: a.transpose(4, 0, 1, 2, 3)}[kind](v)
            sd[f"{key}.weight"] = w
    for key, parts in attn.items():
        _attention(parts, key, sd)

    # a SeparateHead branch's final conv follows its ConvModules
    for k in [k for k in sd if k.startswith("pts_bbox_head.task_heads.")
              and ".final." in k]:
        base, leaf = k.split(".final.")
        n = 0
        while f"{base}.{n}.conv.weight" in sd:
            n += 1
        sd[f"{base}.{n}.{leaf}"] = sd.pop(k)

    n_fpn = len({k.split(".")[2] for k in sd
                 if k.startswith("img_neck.fpn_convs.")})
    for k in [k for k in sd if k.startswith("img_neck.extra_convs.")]:
        _, _, i, rest = k.split(".", 3)
        sd[f"img_neck.fpn_convs.{int(i) + n_fpn}.{rest}"] = sd.pop(k)

    n_conv = len({k.split(".")[2] for k in sd
                  if k.startswith("pts_neck.deblocks.")})
    for k in [k for k in sd if k.startswith("pts_neck.deconv.")]:
        _, _, i, rest = k.split(".", 3)
        sd[f"pts_neck.deblocks.{int(i) + n_conv}.{rest}"] = sd.pop(k)

    # conv_fusion's LiDAR block: JAX z*C + c -> reference c*D + z (whole
    # detector trees; a tree of single modules has no conv_fusion)
    key = "fusion_encoder.conv_fusion.conv.weight"
    if key in sd:
        p = variables["params"]
        n_img = p["img_neck_m"]["fpn_0"]["Conv_0"]["kernel"].shape[-1]
        c_out = p["pts_middle_encoder_m"]["conv_out"]["kernel"].shape[-1]
        w = sd[key]
        c_lidar = w.shape[1] - n_img
        ref = np.empty_like(w)
        ref[:, fusion_lidar_perm(n_img, c_lidar, c_lidar // c_out)] = w
        sd[key] = ref
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
