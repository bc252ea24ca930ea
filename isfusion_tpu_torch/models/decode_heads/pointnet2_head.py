"""PointNet++ and PAConv semantic segmentation heads (counterpart of
``isfusion_tpu/models/decode_heads/pointnet2_head.py``; reference mmdet3d
``decode_heads/pointnet2_head.py``, ``paconv_head.py``).

``PointNet2Head(feat_dict)`` -> (B, N, num_classes) logits at the input's
resolution: FP levels walk the SA pyramid back up (``FP_modules.{i}``:
3-NN interpolation of the coarser level at the finer one's points, the
finer level's features before it, a shared MLP), then ``pre_seg_conv``
(a bias-free 1x1 conv, BN over the valid points, ReLU, padded points
zeroed), dropout and ``conv_seg`` (a 1x1 conv with a bias). The JAX
package's choices, which the port follows:
- the last FP level concatenates the raw point features ``sa_features[0]``
  (the reference's head sets them to None);
- each FP level's input width is that of the concatenation (the JAX
  package's dense layers infer it and ignore the first entry of each
  ``fp_channels`` tuple): the segmentor gives the head the backbone's
  ``sa_channels_out``;
- ``pre_seg_conv`` has no bias (the reference's ConvModule has one).
``PAConvHead`` is ``PointNet2Head`` with the PAConv config's
``fp_channels``; its ``with_pre_seg_conv`` is unused, as in the JAX
package. ``loss`` is the cross entropy of the valid points whose label is
not ``ignore_index``, labels clipped to [0, num_classes), averaged over
those points. Dropout draws from the generator that ``random_source``
installs (the segmentor's ``forward(..., generator=)``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..backbones.pointnet2 import PointConv, PointFPModule
from ..layers import Conv1x1, dropout
from ..losses import build_loss


class PointNet2Head(nn.Module):
    def __init__(self, num_classes: int = 20,
                 fp_channels=((768, 256, 256), (384, 256, 256),
                              (320, 256, 128), (128, 128, 128, 128)),
                 channels: int = 128, dropout_ratio: float = 0.5,
                 ignore_index: Optional[int] = None, loss_decode=None,
                 sa_channels: Sequence[int] = None, **unused):
        super().__init__()
        if sa_channels is None:
            raise ValueError("PointNet2Head needs the backbone's "
                             "sa_channels (the segmentor passes them)")
        self.num_classes = int(num_classes)
        self.ignore_index = ignore_index
        self.dropout_ratio = float(dropout_ratio)
        self.loss_decode = build_loss(dict(
            loss_decode or dict(type="CrossEntropyLoss", reduction="none")))
        n = len(sa_channels)
        source = int(sa_channels[-1])
        self.FP_modules = nn.ModuleList()
        for i, ch in enumerate(fp_channels):
            target = int(sa_channels[n - i - 2])
            self.FP_modules.append(PointFPModule(source + target,
                                                 list(ch)[1:]))
            source = int(ch[-1])
        self.pre_seg_conv = PointConv(source, int(channels), ndim=1)
        self.conv_seg = Conv1x1(int(channels), self.num_classes)

    def forward(self, feat_dict: dict) -> torch.Tensor:
        sa_xyz = feat_dict["sa_xyz"]
        sa_feats = feat_dict["sa_features"]
        sa_masks = feat_dict["sa_masks"]
        x_xyz, x_feats, x_mask = sa_xyz[-1], sa_feats[-1], sa_masks[-1]
        n = len(sa_xyz)
        for i, fp in enumerate(self.FP_modules):
            t = n - i - 2
            x_feats = fp(sa_xyz[t], sa_feats[t], x_xyz, x_feats, sa_masks[t],
                         x_mask)
            x_xyz, x_mask = sa_xyz[t], sa_masks[t]
        x = self.pre_seg_conv(x_feats, x_mask)
        x = torch.where(x_mask[..., None], x, torch.zeros(
            (), dtype=x.dtype, device=x.device))
        x = dropout(x, self.dropout_ratio, self.training)
        return self.conv_seg(x)

    def loss(self, logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> dict:
        """``loss_sem_seg``: logits (B, N, C), labels (B, N), points_mask
        (B, N)."""
        labels = labels.long()
        if self.ignore_index is not None:
            mask = mask & (labels != self.ignore_index)
        ce = self.loss_decode(logits.float(),
                              labels.clamp(0, self.num_classes - 1))
        w = mask.float()
        return dict(loss_sem_seg=(ce * w).sum() / w.sum().clamp_min(1.0))


class PAConvHead(PointNet2Head):
    """PAConv's head (``paconv_head.py``): ``PointNet2Head`` with the
    PAConv config's ``fp_channels``; a config's ``with_pre_seg_conv`` is
    ignored (the JAX package's forward is PointNet2Head's)."""

    def __init__(self, fp_channels=((768, 256, 256), (384, 256, 256),
                                    (320, 256, 128), (128 + 6, 128, 128, 128)),
                 **kwargs):
        super().__init__(fp_channels=fp_channels, **kwargs)
