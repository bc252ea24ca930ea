"""Carrying weights between the packages (isfusion_tpu_torch/runner/
convert.py:state_dict_from_jax against isfusion_tpu/runner/
full_ckpt_convert.py:convert_isfusion_torch_to_flax), on the tiny
IS-Fusion detector of tests/test_models/test_isfusion.py.

Exact: a weight transform is a permutation of values.

Two reference tensors come back transformed, by design (see convert.py):
the SECONDFPN deconv kernels spatially flipped (flax ConvTranspose applies
its kernel flipped against torch's conv_transpose2d, and the JAX converter
does not flip), and conv_fusion's input channels, which the JAX converter
reorders assuming 256 image channels and LiDAR depth 2 -- right for the
flagship, wrong for a conv_fusion of <= 512 input channels, where it also
reorders the image block. The "wide" variant widens the tiny detector's
image neck and LiDAR output so that the JAX assumption holds; there
conv_fusion round-trips exactly.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from isfusion_tpu.models import build_detector
from isfusion_tpu.runner.full_ckpt_convert import \
    convert_isfusion_torch_to_flax
from isfusion_tpu_torch.models.builder import build_detector as port_build
from isfusion_tpu_torch.runner.convert import (fusion_lidar_perm,
                                               state_dict_from_jax)
from test_models.test_isfusion import tiny_batch, tiny_isfusion_cfg
from torch_parity import random_variables

FUSION = "fusion_encoder.conv_fusion.conv.weight"


def _cfg(variant):
    cfg = copy.deepcopy(tiny_isfusion_cfg())
    if variant == "wide":       # conv_fusion input 256 image + 2 x 256 LiDAR
        cfg["img_neck"]["out_channels"] = 256
        cfg["pts_middle_encoder"]["output_channels"] = 256
    return cfg


def _jax_template(cfg):
    m = build_detector(cfg)
    shapes = jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), tiny_batch(), train=False, mode="feats"))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)


def _jax_converter_fusion_perm(cin):
    """The input-channel reorder convert_isfusion_torch_to_flax applies to
    conv_fusion (its image width 256 if cin > 512, else the whole input,
    and depth 2): JAX input channel i reads reference channel perm[i]."""
    n_img = 256 if cin > 512 else 0
    c_l = cin - n_img
    lid = np.arange(c_l).reshape(c_l // 2, 2).T.reshape(-1)
    return np.concatenate([np.arange(n_img), n_img + lid])


@pytest.mark.parametrize("variant", ["tiny", "wide"])
def test_round_trip_through_the_jax_converter(variant):
    cfg = _cfg(variant)
    port_sd = port_build(cfg).state_dict()
    rng = np.random.default_rng(0)
    ref = {k: (np.zeros(v.shape, np.int64) if k.endswith(
        "num_batches_tracked") else v.numpy() if k.endswith(
        "relative_position_index") else rng.normal(size=tuple(v.shape))
        .astype(np.float32)) for k, v in port_sd.items()}
    jax_vars, missing = convert_isfusion_torch_to_flax(ref, _jax_template(cfg))
    assert missing == []          # the port's keys cover the JAX tree
    back = state_dict_from_jax(jax_vars)
    assert set(back) == set(ref)
    for k, want in ref.items():
        got = back[k].numpy()
        if k.startswith("pts_neck.deblocks.") and want.ndim == 4 and \
                want.shape[-1] > 1:                  # stride > 1: deconv
            want = want[:, :, ::-1, ::-1]
        elif k == FUSION:
            cin = want.shape[1]
            n_img = cfg["img_neck"]["out_channels"]
            c_out = cfg["pts_middle_encoder"]["output_channels"]
            jax_k = want[:, _jax_converter_fusion_perm(cin)]
            want = np.empty_like(jax_k)
            want[:, fusion_lidar_perm(n_img, cin - n_img,
                                      (cin - n_img) // c_out)] = jax_k
            if variant == "wide":                    # JAX rule holds here
                np.testing.assert_array_equal(want, ref[k])
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_every_port_parameter_and_buffer_is_filled():
    cfg = _cfg("tiny")
    m = build_detector(cfg)
    variables = random_variables(m, tiny_batch(), train=False, mode="feats")
    sd = state_dict_from_jax(variables)
    port = port_build(cfg)
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
        assert sd[k].dtype == v.dtype, k
    port.load_state_dict(sd, strict=True)
