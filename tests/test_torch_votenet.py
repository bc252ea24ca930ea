"""The port's VoteNet, H3DNet and MultiBackbone against the JAX package's
on carried weights: PointSAModule (max and avg pool, with and without
``normalize_xyz``), PointFPModule, PointNet2SASSG, VoteModule and VoteHead
alone (train and eval mode: outputs and gradients), the
PartialBinBasedBBoxCoder (encode and decode, with and without rotation),
H3DNet's face and edge centres and primitive losses, MultiBackbone's
``hd_feature``, and the tiny detectors (the JAX test's
``tiny_votenet_cfg``; H3DNet on it with 16 primitive channels) in head
outputs, predict, loss terms, every top module's gradients and one AdamW
+ clip step of the VoteNet recipe (lr 0.008, clip 10).

The JAX variables are drawn with numpy (``tests/torch_parity.py``) and
carried with ``state_dict_from_jax``; each JAX detector is two jitted
calls at XLA:CPU backend level 1 (``torch_parity.indoor_variant_case``):
head outputs, predict and losses in float32, then the gradients and the
optimizer update in float64 (``torch_parity.float64_jax``: a ReLU input
of the tiny VoteNet's head lies within float32 rounding of 0, and the
side XLA:CPU's float32 sums put it on depends on the host). The port's
ops run their plain versions (the CPU).

Tolerances (float32, CPU): outputs and gradients 1e-3 of their max (the
modules alone 1e-4), losses 1e-4 relative, the sampled, grouped and
predicted indices and labels equal, updates within 1e-2 of the lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.core.bbox.coders import PartialBinBasedBBoxCoder as JCoder
from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.models import layers as jlayers
from isfusion_tpu.models.backbones.multi_backbone import \
    MultiBackbone as JMulti
from isfusion_tpu.models.backbones.pointnet2 import (
    PointFPModule as JFP, PointNet2SASSG as JSASSG, PointSAModule as JSA,
    _SharedMLP as JMLP)
from isfusion_tpu.models.dense_heads import vote_head as jvote_head
from isfusion_tpu.models.dense_heads.vote_head import (VoteHead as JHead,
                                                       VoteModule as JVote)
from isfusion_tpu.models.detectors import h3dnet as jh3d
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.core.bbox.coders import PartialBinBasedBBoxCoder
from isfusion_tpu_torch.models.backbones.multi_backbone import MultiBackbone
from isfusion_tpu_torch.models.backbones.pointnet2 import (PointFPModule,
                                                           PointNet2SASSG,
                                                           PointSAModule,
                                                           SharedMLP)
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.models.dense_heads.vote_head import (VoteHead,
                                                             VoteModule)
from isfusion_tpu_torch.models.detectors import h3dnet as tvote
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from test_models.test_votenet import tiny_batch, tiny_votenet_cfg
from torch_parity import (OPTIMIZED_XLA, assert_close_to_max, check_step,
                          indoor_variant_case, jax_cfg, load_from_jax,
                          random_variables)

VOTENET_LOSSES = {"vote_loss", "objectness_loss", "center_loss",
                  "dir_class_loss", "dir_res_loss", "size_class_loss",
                  "size_res_loss", "semantic_loss"}
INDEX_KEYS = ("seed_indices",)
MASK_KEYS = ("seed_mask", "aggregated_mask")


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def _cloud(b=2, n=160, c=2, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.5, 1.5, (b, n, 3)).astype(np.float32)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.1
    return xyz, feats, mask


def _compiled(fn, *args):
    """``fn(*args)`` jitted at XLA:CPU backend level 1. At the suite's
    level 0 a max pool's gradient misses its maximum in some rows
    (``test_max_pool_gradient_reaches_the_maximum``)."""
    return jax.jit(fn).lower(*args).compile(OPTIMIZED_XLA)(*args)


def _probe_grads(jfn, variables, args, port, targs, probes, train):
    """The JAX module's outputs and the gradients of sum(out * probe)
    w.r.t. its params, and the port's (train or eval mode)."""
    def loss(params, *a):
        outs = jfn({"params": params, **{k: v for k, v in variables.items()
                                         if k != "params"}}, *a)
        return sum(jnp.sum(o * p) for o, p in zip(outs, probes)), outs

    (_, want), grads = _compiled(jax.value_and_grad(loss, has_aux=True),
                                 variables["params"], *args)
    port.train(train)
    outs = port(*targs)
    outs = (outs,) if torch.is_tensor(outs) else outs
    sum((o * torch.from_numpy(p)).sum() for o, p in zip(outs, probes)
        ).backward()
    return want, jax.device_get(grads), outs


# ------------------------------------------------------------- modules
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("pool,normalize", [("max", True), ("avg", False)])
def test_sa_module_matches(train, pool, normalize):
    xyz, feats, mask = _cloud()
    kw = dict(num_point=24, radii=[0.6], sample_nums=[8],
              mlp_channels=[8, 12], use_xyz=True, pool_mod=pool,
              normalize_xyz=normalize)
    jsa = JSA(**kw)
    args = tuple(map(jnp.asarray, (xyz, feats, mask)))
    variables = random_variables(jsa, *args, seed=1)
    probes = [np.random.default_rng(5).normal(size=s).astype(np.float32)
              for s in ((2, 24, 3), (2, 24, 12))]

    def fn(v, *a):
        return jsa.apply(v, *a, train=train, mutable=["batch_stats"])[0][:2]

    port = load_from_jax(PointSAModule(in_channels=2, **kw),
                         {"params": {"sa0": variables["params"]},
                          "batch_stats": {"sa0": variables["batch_stats"]}},
                         "backbone_m", "backbone.SA_modules.0")
    want, grads, got = _probe_grads(fn, variables, args, port,
                                    [torch.from_numpy(a) for a in (
                                        xyz, feats, mask)], probes, train)
    idx, nm = _compiled(lambda v, *a: jsa.apply(v, *a, train=False)[2:],
                        variables, *args)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(nm))
    for g, w in zip(got[:2], want):
        assert_close_to_max(g.detach().numpy(), np.asarray(w), 1e-4)
    jg = state_dict_from_jax({"params": {"backbone_m": {"sa0": grads}}})
    for name, p in port.named_parameters():
        assert_close_to_max(p.grad.numpy(), jg[
            f"backbone.SA_modules.0.{name}"].numpy(), 1e-4)


def test_max_pool_gradient_reaches_the_maximum():
    """A ball's max pool over a shared MLP layer (eval BN + ReLU): the
    port's gradients and the JAX package's, compiled as ``_compiled``
    does (XLA:CPU level 1), within 1e-5 of the max of a float64 oracle
    that sends each maximum's gradient to its slot (the ReLU's zeros
    excluded). At the suite's level 0 XLA:CPU recomputes the BN's affine
    for the backward's ``operand == max`` test in another fusion, there
    contracted to an FMA, so the test misses the maximum in some rows and
    their gradient is lost (ROADMAP queue 3, Settled): levels 1 and 2
    and JAX eager agree with the oracle."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(2, 24, 8, 5)).astype(np.float32)
    w = rng.normal(size=(5, 12)).astype(np.float32)
    scale, bias, mean = (rng.normal(size=12).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    probe = rng.normal(size=(2, 24, 12)).astype(np.float32)
    valid = jnp.ones((2, 24, 8), bool)
    variables = {"params": {"fc0": {"kernel": w}, "bn0": {
        "scale": scale, "bias": bias}}, "batch_stats": {"bn0": {
            "mean": mean, "var": var}}}

    def loss(params, x):
        y = JMLP((12,)).apply({"params": params, "batch_stats": variables[
            "batch_stats"]}, x, valid)
        return jnp.sum(jnp.max(y, 2) * probe)

    jg = jax.device_get(_compiled(jax.grad(loss), variables["params"],
                                  jnp.asarray(g)))
    port = SharedMLP(5, [12]).eval()
    layer = port.layer0
    with torch.no_grad():
        layer.conv.weight.copy_(torch.from_numpy(w.T)[..., None, None])
        layer.bn.weight.copy_(torch.from_numpy(scale))
        layer.bn.bias.copy_(torch.from_numpy(bias))
        layer.bn.running_mean.copy_(torch.from_numpy(mean))
        layer.bn.running_var.copy_(torch.from_numpy(var))
    (port(torch.from_numpy(g), torch.ones(2, 24, 8, dtype=torch.bool))
     .amax(2) * torch.from_numpy(probe)).sum().backward()
    # the oracle: float64, the gradient of each maximum to its slot(s)
    x = g.astype(np.float64) @ w
    inv = scale / np.sqrt(var.astype(np.float64) + 1e-5)
    pre = (x - mean) * inv + bias
    y = np.maximum(pre, 0)
    top = y == y.max(2, keepdims=True)
    up = top / top.sum(2, keepdims=True) * (pre > 0) * probe[:, :, None]
    want = {"kernel": np.einsum("bski,bskc->ic", g, up * inv),
            "scale": (up * (x - mean) / np.sqrt(var + 1e-5)).sum((0, 1, 2)),
            "bias": up.sum((0, 1, 2))}
    got = {"kernel": (jg["fc0"]["kernel"],
                      layer.conv.weight.grad[..., 0, 0].T.numpy()),
           "scale": (jg["bn0"]["scale"], layer.bn.weight.grad.numpy()),
           "bias": (jg["bn0"]["bias"], layer.bn.bias.grad.numpy())}
    for name, sides in got.items():
        for side in sides:
            assert_close_to_max(side, want[name], 1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_fp_module_matches(train):
    rng = np.random.default_rng(2)
    txyz, tf, tm = _cloud(2, 40, 4, seed=3)
    sxyz, sf, sm = _cloud(2, 16, 6, seed=4)
    jfp = JFP(mlp_channels=[10, 8])
    args = tuple(map(jnp.asarray, (txyz, tf, sxyz, sf, tm, sm)))
    variables = random_variables(jfp, *args, seed=2)
    probes = [rng.normal(size=(2, 40, 8)).astype(np.float32)]

    def fn(v, *a):
        return (jfp.apply(v, *a, train=train, mutable=["batch_stats"])[0],)

    port = load_from_jax(PointFPModule(10, [10, 8]),
                         {c: {"fp0": variables[c]} for c in variables},
                         "backbone_m", "backbone.FP_modules.0")
    want, grads, got = _probe_grads(
        fn, variables, args, port, [torch.from_numpy(a) for a in (
            txyz, tf, sxyz, sf, tm, sm)], probes, train)
    assert_close_to_max(got[0].detach().numpy(), np.asarray(want[0]), 1e-4)
    jg = state_dict_from_jax({"params": {"backbone_m": {"fp0": grads}}})
    for name, p in port.named_parameters():
        assert_close_to_max(p.grad.numpy(), jg[
            f"backbone.FP_modules.0.{name}"].numpy(), 1e-4)


BACKBONE = dict(num_points=(64, 32, 16), radius=(0.5, 1.0, 1.5),
                num_samples=(8, 8, 8),
                sa_channels=((8, 16), (16, 16), (16, 24)),
                fp_channels=((16, 16), (16, 16)),
                sa_cfg=dict(normalize_xyz=True))


@pytest.mark.parametrize("train", [False, True])
def test_backbone_matches(train):
    xyz, feats, mask = _cloud(2, 256, 1, seed=6)
    points = np.concatenate([xyz, feats], -1)
    jbb = JSASSG(in_channels=4, **BACKBONE)
    args = (jnp.asarray(points), jnp.asarray(mask))
    variables = random_variables(jbb, *args, seed=3)
    out = _compiled(lambda v, *a: jbb.apply(v, *a, train=train,
                                            mutable=["batch_stats"])[0],
                    variables, *args)
    port = load_from_jax(PointNet2SASSG(in_channels=4, **BACKBONE),
                         variables, "backbone_m", "backbone").train(train)
    got = port(torch.from_numpy(points), torch.from_numpy(mask))
    for key in ("sa_xyz", "sa_features", "sa_masks", "fp_xyz",
                "fp_features", "fp_masks"):
        for g, w in zip(got[key][1:], out[key][1:]):
            if g.dtype == torch.bool:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                assert_close_to_max(g.detach().numpy(), np.asarray(w), 1e-4)
    np.testing.assert_array_equal(got["fp_indices"].numpy(),
                                  np.asarray(out["fp_indices"]))


def _seeds(b=2, s=48, c=16, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, (b, s, 3)).astype(np.float32),
            rng.normal(size=(b, s, c)).astype(np.float32),
            rng.uniform(size=(b, s)) > 0.1)


@pytest.mark.parametrize("train", [False, True])
def test_vote_module_matches(train):
    xyz, feats, mask = _seeds()
    jvm = JVote(in_channels=16, conv_channels=(12, 12))
    args = tuple(map(jnp.asarray, (xyz, feats, mask)))
    variables = random_variables(jvm, *args, seed=4)
    rng = np.random.default_rng(8)
    probes = [rng.normal(size=s).astype(np.float32)
              for s in ((2, 48, 3), (2, 48, 16), (2, 48, 3))]

    def fn(v, *a):
        return jvm.apply(v, *a, train=train, mutable=["batch_stats"])[0]

    port = load_from_jax(VoteModule(in_channels=16, conv_channels=(12, 12)),
                         variables, "bbox_head_m/vote_module",
                         "bbox_head.vote_module")
    want, grads, got = _probe_grads(fn, variables, args, port, [
        torch.from_numpy(a) for a in (xyz, feats, mask)], probes, train)
    for g, w in zip(got, want):
        assert_close_to_max(g.detach().numpy(), np.asarray(w), 1e-4)
    jg = state_dict_from_jax({"params": {"bbox_head_m": {
        "vote_module": grads}}})
    for name, p in port.named_parameters():
        assert_close_to_max(p.grad.numpy(), jg[
            f"bbox_head.vote_module.{name}"].numpy(), 1e-4)


HEAD = tiny_votenet_cfg()["bbox_head"]


def _feat_dict(seed=9):
    xyz, feats, mask = _seeds(2, 64, 32, seed)
    return dict(fp_xyz=[xyz], fp_features=[feats], fp_masks=[mask],
                fp_indices=np.tile(np.arange(64), (2, 1)).astype(np.int32))


@pytest.mark.parametrize("train", [False, True])
def test_vote_head_matches(train):
    fd = _feat_dict()
    jhead = JHead(**{k: v for k, v in HEAD.items() if k != "type"})
    jfd = jax.tree_util.tree_map(jnp.asarray, fd)
    variables = random_variables(jhead, jfd, seed=5)
    out = _compiled(lambda v, f: jhead.apply(v, f, train=train,
                                             mutable=["batch_stats"])[0],
                    variables, jfd)
    port = load_from_jax(VoteHead(**{k: v for k, v in HEAD.items()
                                     if k != "type"}),
                         variables, "bbox_head_m", "bbox_head").train(train)
    got = port(jax.tree_util.tree_map(torch.from_numpy, fd))
    assert set(got) == set(out)
    for key, w in out.items():
        g = got[key]
        if g.dtype in (torch.bool, torch.int32, torch.int64):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert_close_to_max(g.detach().numpy(), np.asarray(w), 1e-4)


@pytest.mark.parametrize("with_rot,bins", [(True, 6), (False, 1),
                                           (True, 12)])
def test_bbox_coder_matches(with_rot, bins):
    rng = np.random.default_rng(bins)
    sizes = rng.uniform(0.2, 2.0, (5, 3)).astype(np.float32).tolist()
    jc, tc = (cls(bins, 5, sizes, with_rot) for cls in (
        JCoder, PartialBinBasedBBoxCoder))
    ctr = rng.normal(size=(2, 40, 3)).astype(np.float32)
    dims = rng.uniform(0.1, 3.0, (2, 40, 3)).astype(np.float32)
    # yaws across the circle, on bin edges and on both sides of +-pi
    edges = (np.arange(-bins, bins + 1) * np.pi / bins).astype(np.float32)
    yaw = np.concatenate([rng.uniform(-7, 7, (2, 40 - len(edges))),
                          np.broadcast_to(edges, (2, len(edges)))],
                         -1).astype(np.float32)
    labels = rng.integers(0, 5, (2, 40))
    want = jc.encode(*map(jnp.asarray, (ctr, dims, yaw, labels)))
    got = tc.encode(*map(torch.from_numpy, (ctr, dims, yaw, labels)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    logits = [rng.normal(size=(2, 40, n)).astype(np.float32)
              for n in (bins, bins, 5)]
    sres = rng.normal(size=(2, 40, 5, 3)).astype(np.float32)
    args = (ctr, logits[0], logits[1], logits[2], sres)
    want = jc.decode(*map(jnp.asarray, args))
    got = tc.decode(*map(torch.from_numpy, args))
    assert_close_to_max(got.numpy(), np.asarray(want), 1e-7)


def test_box_primitives_and_primitive_losses_match():
    rng = np.random.default_rng(11)
    boxes = np.concatenate([rng.normal(size=(2, 5, 3)),
                            rng.uniform(0.2, 2.0, (2, 5, 3)),
                            rng.uniform(-np.pi, np.pi, (2, 5, 1))],
                           -1).astype(np.float32)
    for jf, tf in ((jh3d.box_face_centers, tvote.box_face_centers),
                   (jh3d.box_edge_centers, tvote.box_edge_centers)):
        assert_close_to_max(tf(torch.from_numpy(boxes)).numpy(),
                            np.asarray(jf(jnp.asarray(boxes))), 1e-7)
    face, edge = (rng.normal(size=(2, 30, 3)).astype(np.float32)
                  for _ in range(2))
    seed_mask = rng.uniform(size=(2, 30)) > 0.2
    gt_mask = np.array([[True] * 4 + [False], [True] * 2 + [False] * 3])
    batch = dict(gt_bboxes_3d=jnp.asarray(boxes), gt_mask=jnp.asarray(
        gt_mask))
    want = jh3d.H3DNet._primitive_losses(None, jnp.asarray(face),
                                         jnp.asarray(edge),
                                         jnp.asarray(seed_mask), batch)
    got = tvote.H3DNet.primitive_losses(*map(torch.from_numpy, (
        face, edge, seed_mask, boxes, gt_mask)))
    assert set(got) == set(want) == {"loss_face_vote", "loss_edge_vote"}
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-6, k


MULTI = dict(type="PointNet2SASSG", in_channels=4, num_points=(32, 16),
             radius=(0.4, 0.8), num_samples=(8, 8),
             sa_channels=((8, 8), (8, 16)), fp_channels=((16, 16),))


@pytest.mark.parametrize("train", [False, True])
def test_multi_backbone_matches(train):
    """The JAX test's MultiBackbone (two streams, the default aggregation
    32 -> 16 -> 16): every stream's suffixed keys and ``hd_feature``."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(2, 64, 4)).astype(np.float32)
    mask = np.ones((2, 64), bool)
    mask[1, 50:] = False
    jm = JMulti(num_streams=2, backbones=MULTI, suffixes=("net0", "net1"))
    variables = random_variables(jm, jnp.asarray(pts), jnp.asarray(mask),
                                 seed=6)
    out = _compiled(lambda v, p, m: jm.apply(v, p, m, train=train,
                                             mutable=["batch_stats"])[0],
                    variables, jnp.asarray(pts), jnp.asarray(mask))
    port = load_from_jax(MultiBackbone(num_streams=2, backbones=MULTI),
                         variables, "backbone_m", "backbone").train(train)
    got = port(torch.from_numpy(pts), torch.from_numpy(mask))
    assert set(got) == set(out)
    assert got["hd_feature"].shape == (2, 32, 16)
    assert_close_to_max(got["hd_feature"].detach().numpy(),
                        np.asarray(out["hd_feature"]), 1e-4)
    for s in ("net0", "net1"):
        assert_close_to_max(got[f"fp_features_{s}"][-1].detach().numpy(),
                            np.asarray(out[f"fp_features_{s}"][-1]), 1e-4)


# ------------------------------------------------------- tiny detectors
@pytest.fixture(scope="module", params=["VoteNet", "H3DNet"])
def case(request):
    batch = {k: np.asarray(v) for k, v in tiny_batch().items()}
    cfg = tflagship.votenet_model_cfg(tiny=True)
    if request.param == "H3DNet":
        cfg = tflagship.h3dnet_model_cfg(tiny=True)
    # the JAX gradients and step in float64: in float32 one ReLU input of
    # the head's second shared conv (conv_pred.shared_convs.layer1) lies
    # 3.6e-6 of its tensor's max from 0, and XLA:CPU's sums put it on the
    # side the host's vector code gives: on one kind of machine the other
    # side from the exact function's, which moves the head's gradients by
    # 1.2e-3 of their max. The port's float32 run takes the float64 run's
    # side there.
    out = indoor_variant_case(cfg, batch, tflagship.votenet_optim_cfg(),
                              widen=(jlayers, jvote_head, jh3d),
                              positives=True)
    out["name"] = request.param
    return out


def test_tiny_configs_are_the_jax_test_models():
    """The port's tiny VoteNet is the JAX test's model, ``in_channels``
    set to its points' width (which the JAX package ignores)."""
    want = tiny_votenet_cfg()
    want["backbone"]["in_channels"] = 4
    assert jax_cfg(tflagship.votenet_model_cfg(tiny=True)) == jax_cfg(want)
    assert tflagship.h3dnet_model_cfg(tiny=True)["primitive_channels"] == 16


def test_head_outputs_match(case):
    got, want = case["got_feats"], case["feats"]
    assert set(got) == set(want)
    if case["name"] == "H3DNet":
        assert {"face_xyz", "edge_xyz"} <= set(got)
    for key, w in want.items():
        g = got[key]
        if key in INDEX_KEYS or key in MASK_KEYS:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert_close_to_max(g.numpy(), np.asarray(w), 1e-3)


def test_predict_matches(case):
    got, want = case["got_pred"], case["decoded"]
    assert got["bboxes"].shape == (2, 16, 7)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(
        want["mask"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(
        want["labels"]))
    for key in ("bboxes", "scores"):
        assert_close_to_max(got[key].numpy(), np.asarray(want[key]), 1e-3)


def test_loss_terms_match(case):
    jl, tl = case["jl"], case["tl"]
    extra = {"loss_face_vote", "loss_edge_vote"} \
        if case["name"] == "H3DNet" else set()
    assert set(tl) == set(jl) == VOTENET_LOSSES | extra
    for k in jl:
        assert jl[k] > 0, k
        assert _rel(tl[k], jl[k]) <= 1e-4, (k, tl[k], jl[k])


def test_module_gradients_match(case):
    """Each top module's gradients (H3DNet's primitive branches too)."""
    jg, params = case["jg"], dict(case["trained"].named_parameters())
    tops = sorted({n.split(".")[0] for n in params})
    assert tops == (["backbone", "bbox_head"] if case["name"] == "VoteNet"
                    else ["backbone", "bbox_head", "edge_vote", "face_vote",
                          "prim_proj"])
    for top in tops:
        names = [n for n in params if n.split(".")[0] == top]
        want = np.concatenate([jg[n].numpy().ravel() for n in names])
        got = np.concatenate([params[n].grad.numpy().ravel()
                              for n in names])
        assert np.abs(want).max() > 0, top
        assert_close_to_max(got, want, 1e-3)


def test_train_step_matches_jax(case):
    assert check_step(case, 0.008, 10.0) > 5000


def test_synthetic_indoor_batch_contract():
    """The synthetic room: exactly N points drawn with replacement (exact
    duplicates), xyz + height above the 0.99th percentile of z, every
    point valid, 8-16 boxes standing on the floor inside the room, padded
    to 64 GT rows with a mask; the same seed gives the same bytes."""
    b = tflagship.synthetic_indoor_batch(2, num_points=40000, seed=4)
    pts = b["points"]
    assert pts.shape == (2, 40000, 4) and pts.dtype == np.float32
    assert b["points_mask"].all()
    for s in range(2):
        xyz = pts[s, :, :3]
        assert len(np.unique(xyz, axis=0)) < len(xyz)
        np.testing.assert_array_equal(
            pts[s, :, 3], xyz[:, 2] - np.percentile(xyz[:, 2], 0.99))
        g = int(b["gt_mask"][s].sum())
        assert 8 <= g <= 16 and not b["gt_mask"][s, g:].any()
        boxes = b["gt_bboxes_3d"][s, :g]
        assert (boxes[:, 2] == 0).all() and (boxes[:, 6] == 0).all()
        assert (np.abs(boxes[:, :2]) + boxes[:, 3:5] / 2 <= 4.0 + 1e-5).all()
    assert b["gt_bboxes_3d"].shape == (2, 64, 7)
    again = tflagship.synthetic_indoor_batch(2, num_points=40000, seed=4)
    for k in b:
        np.testing.assert_array_equal(b[k], again[k])


@pytest.mark.parametrize("name", ["votenet", "h3dnet"])
def test_full_width_configs_carry_the_jax_trees(name):
    """The full-width VoteNet and H3DNet (mmdet3d's votenet_8x8 config)
    take every variable of the JAX package's detector built from the same
    config, strictly, and their shapes (the input widths that the port
    computes and JAX infers)."""
    cfg = getattr(tflagship, f"{name}_model_cfg")()
    jmodel = jbuild_detector(jax_cfg(cfg))
    batch = {k: jnp.asarray(v) for k, v in tflagship.synthetic_indoor_batch(
        1, num_points=4096, seed=0).items()}
    variables = random_variables(jmodel, batch, train=False, mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    widths = [port.backbone.SA_modules[i].mlps[0].layer0.conv.in_channels
              for i in range(4)]
    assert widths == [4, 131, 259, 259]
    assert port.bbox_head.conv_pred.conv_reg.out_channels == 3 + 2 + 18 * 4
    assert port.bbox_head.conv_pred.conv_cls.out_channels == 2 + 18


def test_forward_on_a_synthetic_room_matches_jax():
    """The tiny VoteNet's head outputs on the port's tiny synthetic room
    (``build_votenet(tiny=True)``'s batch: 256 points, 4 x 4 x 2.5 m)."""
    cfg = tflagship.votenet_model_cfg(tiny=True)
    _, batch_fn = tflagship.build_votenet(tiny=True, device="cpu")
    batch = batch_fn(2, seed=5)
    jmodel = jbuild_detector(jax_cfg(cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(jmodel, jbatch, train=False, mode="feats")
    want = _compiled(lambda v: jmodel.apply(v, jbatch, train=False,
                                            mode="feats"), variables)
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    got = port.eval()(batch, mode="feats", device="cpu")
    for key, w in want.items():
        if key in INDEX_KEYS or key in MASK_KEYS:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(w))
        else:
            assert_close_to_max(got[key].numpy(), np.asarray(w), 1e-3)
