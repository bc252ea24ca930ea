"""The port's RegNet and NoStemRegNet against the JAX package: the width
rule (``generate_regnet`` + ``adjust_width_group``: regnetx_400mf's
stages and the reference docstring arch's), each backbone's forward in
eval and train mode on carried JAX variables (grouped 3x3 convs, stride-2
downsample convs, the stem), its running statistics after the train
forward, and the grouped kernels' round trip through the converter.

Variables are drawn with numpy (``tests/torch_parity.py``) and carried
with ``state_dict_from_jax``. Tolerances (float32, CPU): widths and
depths exact; forward 1e-3 of the max; running statistics 1e-5 relative
(flax keeps the biased batch variance, the port the unbiased one: the
JAX value is rescaled by n / (n - 1) before the comparison); kernels
bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models.backbones import regnet as jregnet
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.models.backbones import regnet as tregnet
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from torch_parity import assert_close_to_max, load_from_jax, random_variables

TINY = dict(w0=24, wa=24.48, wm=2.54, group_w=8, depth=8, bot_mul=1.0)
BN = dict(type="naiveSyncBN2d", eps=1e-3, momentum=0.01)


@pytest.mark.parametrize("arch,group_w,widths", [
    ((24, 24.48, 2.54, 22), 16, [32, 64, 160, 384]),     # regnetx_400mf
    ((88, 26.31, 2.25, 25), 48, [96, 192, 432, 1008]),   # the docstring's
    ((24, 24.48, 2.54, 8), 8, [24, 64, 152]),            # the tiny arch
])
def test_width_rule_matches(arch, group_w, widths):
    jw, jd = jregnet.generate_regnet(*arch)
    tw, td = tregnet.generate_regnet(*arch)
    assert (tw, td) == (jw, jd)
    got = tregnet.adjust_width_group(tw, 1.0, group_w)
    assert tuple(got) == tuple(jregnet.adjust_width_group(jw, 1.0, group_w))
    assert got[0] == widths
    assert sum(td) == arch[3]


def test_full_width_config_stages():
    cfg = tflagship.free_anchor_model_cfg()["pts_backbone"]
    m = tregnet.NoStemRegNet(**{k: v for k, v in cfg.items()
                                if k != "type"})
    assert m.stage_widths == [32, 64, 160, 384]
    assert m.stage_depths == [1, 2, 7, 12]
    # group_w groups on every grouped conv, as the JAX package builds them
    assert {b.conv2.groups for i in range(4)
            for b in getattr(m, f"layer{i + 1}")} == {16}


def _pair(stem: bool):
    if stem:
        kw = dict(arch=TINY, stem_channels=8, out_indices=(0, 1, 2),
                  strides=(2, 2, 2), norm_cfg=BN)
        jmod, port = jregnet.RegNet(**kw), tregnet.RegNet(in_channels=3, **kw)
        x = np.random.default_rng(1).normal(size=(2, 32, 32, 3))
    else:
        kw = dict(arch=TINY, base_channels=16, out_indices=(0, 1, 2),
                  strides=(1, 2, 2))
        jmod, port = jregnet.NoStemRegNet(**kw), tregnet.NoStemRegNet(**kw)
        x = np.random.default_rng(2).normal(size=(2, 16, 16, 16))
    x = x.astype(np.float32)
    variables = random_variables(jmod, jnp.asarray(x), seed=3)
    return jmod, load_from_jax(port, variables, "pts_backbone_m",
                               "pts_backbone"), variables, x


@pytest.mark.parametrize("stem", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_regnet_forward_matches(stem, train):
    jmod, port, variables, x = _pair(stem)
    if train:
        want, mut = jmod.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        port.train()
    else:
        want = jmod.apply(variables, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close_to_max(g.detach().numpy(), np.asarray(w), 1e-3)
    if train:
        stats = state_dict_from_jax({"batch_stats": {
            "pts_backbone_m": jax.device_get(mut["batch_stats"])}})
        sd = port.state_dict()
        checked = 0
        for k, v in stats.items():
            if k.endswith("running_mean"):
                want_v = v.numpy()
            elif k.endswith("running_var"):
                # flax's running variance takes the biased batch variance
                bn = port.get_submodule(k[len("pts_backbone."):-len(
                    ".running_var")])
                n = _rows_into(port, bn, x)
                old = state_dict_from_jax({"batch_stats": {
                    "pts_backbone_m": variables["batch_stats"]}})[k].numpy()
                mom = bn.momentum
                batch_var = (v.numpy() - (1 - mom) * old) / mom
                want_v = (1 - mom) * old + mom * batch_var * n / (n - 1)
            else:
                continue
            np.testing.assert_allclose(sd[k[len("pts_backbone."):]].numpy(),
                                       want_v, rtol=1e-5, atol=1e-6)
            checked += 1
        assert checked == 2 * sum(1 for m in port.modules()
                                  if type(m).__name__ == "BatchNorm")


def _rows_into(port, bn, x):
    """The rows (N H W) a BatchNorm normalised in one forward of ``x``."""
    seen = []
    h = bn.register_forward_pre_hook(
        lambda m, a: seen.append(a[0].numel() // a[0].shape[-1]))
    with torch.no_grad():
        port.eval()(torch.from_numpy(x))
    h.remove()
    return seen[0]


def test_grouped_kernels_round_trip():
    jmod, port, variables, _ = _pair(stem=False)
    params = variables["params"]
    block = params["stage1_block0"]
    kernel = np.asarray(block["conv2"]["Conv_0"]["kernel"])
    conv = port.layer2[0].conv2
    # flax (kh, kw, in / groups, out); the port's (out, in / groups, kh, kw)
    assert kernel.shape == (3, 3, 64 // 8, 64)
    assert conv.groups == 8 and tuple(conv.weight.shape) == (64, 8, 3, 3)
    np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    # every JAX leaf lands on one port tensor, and back
    sd = state_dict_from_jax({"params": {"pts_backbone_m": params}})
    assert {k[len("pts_backbone."):] for k in sd} <= \
        set(port.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves
