"""MultiBackbone (counterpart of ``isfusion_tpu/models/backbones/
multi_backbone.py``; reference mmdet3d ``backbones/multi_backbone.py``):
``num_streams`` point backbones over the same cloud, their result dicts
re-keyed with ``suffixes``, the last FP features of every stream
concatenated and passed through ``aggregation_layers.layer{i}`` (Conv1d
with a bias + BN1d (eps 1e-5, momentum 0.01) + ReLU by default) into
``hd_feature``. The streams are ``backbone_list.{i}`` (the reference's
names); their input widths come from their configs, the aggregation's
from the streams' last FP widths.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..layers import BatchNorm, bn_args, build_activation


class _AggLayer(nn.Module):
    def __init__(self, cin: int, cout: int, norm_cfg: dict, act_cfg: dict):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, 1)
        self.bn = BatchNorm(cout, **bn_args(norm_cfg))
        self.act = build_activation(act_cfg)

    def forward(self, x):
        x = torch.nn.functional.linear(x, self.conv.weight[..., 0],
                                       self.conv.bias)
        return self.act(self.bn(x))


class MultiBackbone(nn.Module):
    def __init__(self, num_streams: int = 2, backbones: Any = None,
                 aggregation_mlp_channels: Optional[Sequence[int]] = None,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 suffixes: Sequence[str] = ("net0", "net1"), **unused):
        super().__init__()
        from ..builder import build_backbone

        cfgs = backbones
        if isinstance(cfgs, dict):
            cfgs = [dict(cfgs) for _ in range(num_streams)]
        if len(cfgs) != num_streams or len(suffixes) != num_streams:
            raise ValueError("MultiBackbone: one config and one suffix a "
                             "stream")
        self.suffixes = list(suffixes)
        self.backbone_list = nn.ModuleList(build_backbone(dict(c))
                                           for c in cfgs)
        out = sum(b.out_channels for b in self.backbone_list)
        mlp = list(aggregation_mlp_channels) if aggregation_mlp_channels \
            is not None else [out // 2, out // num_streams]
        norm_cfg = dict(norm_cfg or dict(type="BN1d", eps=1e-5,
                                         momentum=0.01))
        act_cfg = dict(act_cfg or dict(type="relu"))
        self.aggregation_layers = nn.Sequential()
        for i, c in enumerate(mlp):
            self.aggregation_layers.add_module(
                f"layer{i}", _AggLayer(out, int(c), norm_cfg, act_cfg))
            out = int(c)

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor
                ) -> dict:
        ret, feats = {}, []
        for net, suffix in zip(self.backbone_list, self.suffixes):
            cur = net(points, points_mask)
            feats.append(cur["fp_features"][-1])
            for k, v in cur.items():
                ret[f"{k}_{suffix}" if suffix else k] = v
        ret["hd_feature"] = self.aggregation_layers(torch.cat(feats, -1))
        return ret
