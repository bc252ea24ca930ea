"""The port's Group-Free 3D (``GroupFree3DNet``, ``GroupFree3DHead``,
``GroupFree3DBBoxCoder``, the decoder layer's options) against the JAX
package's on carried weights: the coder's encode and decode (sizes by
class and class-agnostic, with and without rotation), the transformer
decoder layer with 6- and 3-wide position embeddings and masked keys and
queries (a sample whose keys are all masked among them; train and eval
mode, outputs and gradients), the JAX test's tiny detector
(``tests/test_models/test_indoor_variants.py``) with class-agnostic sizes
and ``prediction_stages`` 'last', and with sizes by class and 'all', in
head outputs, predict, loss terms, every module's gradients and one AdamW
+ clip step, the dropout's generator, and the full-width config's tree.

Dropout is off on both sides in the parity cases (the JAX draws are not
the port's); the JAX detector is compiled at XLA:CPU level 1, its
gradients and step in float64 (``torch_parity.indoor_variant_case``). The
step takes the Group-Free 3D recipe's AdamW, lr and clip without its
decoder ``lr_mult`` (its keys name the reference's modules, which the JAX
tree does not).

Tolerances (float32, CPU): outputs 1e-4 of their max (the decoder layer
alone 1e-5, its gradients 1e-4 of the layer's max), gradients 1e-3 of
their max, losses 1e-4 relative (1e-7 absolute), KPS indices, masks and
labels equal, updates within 1e-2 of the lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.core.bbox.coders import GroupFree3DBBoxCoder as JCoder
from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.models import layers as jlayers
from isfusion_tpu.models.dense_heads import groupfree3d_head as jgf
from isfusion_tpu.models.transformer import TransformerDecoderLayer as JLayer
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.core.bbox.coders import GroupFree3DBBoxCoder
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.models.transformer import (PositionEmbeddingLearned,
                                                   TransformerDecoderLayer)
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from test_models.test_indoor_variants import (backbone_cfg,
                                              groupfree_head_cfg, tiny_batch)
from torch_parity import (OPTIMIZED_XLA, assert_close_to_max,
                          check_indoor_gradients, check_indoor_losses,
                          check_indoor_outputs, check_indoor_predict,
                          check_indoor_step, indoor_variant_case, jax_cfg,
                          random_variables)

STAGE_TERMS = ("objectness_loss", "center_loss", "dir_class_loss",
               "dir_res_loss", "semantic_loss")
GF3D_TOPS = ("backbone.SA_modules", "backbone.FP_modules",
             "bbox_head.points_obj_cls", "bbox_head.conv_pred",
             "bbox_head.decoder_query_proj", "bbox_head.decoder_key_proj",
             "bbox_head.decoder_self_posembeds",
             "bbox_head.decoder_cross_posembeds", "bbox_head.decoder_layers",
             "bbox_head.prediction_heads")


@pytest.mark.parametrize("agnostic,with_rot", [(True, True), (False, True),
                                               (False, False)])
def test_groupfree3d_coder_matches(agnostic, with_rot):
    """Encode (centre, size, size class and residual, bin, normalised
    residual) equal; decode of a stage's predictions under its prefix
    within 1e-7 of the max."""
    rng = np.random.default_rng(7)
    sizes = rng.uniform(0.2, 2.0, (4, 3)).astype(np.float32).tolist()
    jc, tc = (cls(6, 4, sizes, with_rot, agnostic)
              for cls in (JCoder, GroupFree3DBBoxCoder))
    edges = (np.arange(-6, 7) * np.pi / 6).astype(np.float32)
    yaw = np.concatenate([rng.uniform(-7, 7, (2, 17)),
                          np.broadcast_to(edges, (2, 13))], -1).astype(
                              np.float32)
    ctr = rng.normal(size=(2, 30, 3)).astype(np.float32)
    dims = rng.uniform(0.1, 3.0, (2, 30, 3)).astype(np.float32)
    labels = rng.integers(0, 4, (2, 30))
    want = jc.encode(*map(jnp.asarray, (ctr, dims, yaw, labels)))
    got = tc.encode(*map(torch.from_numpy, (ctr, dims, yaw, labels)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out = {"s1.center": ctr,
           "s1.dir_class": rng.normal(size=(2, 30, 6)),
           "s1.dir_res": rng.normal(size=(2, 30, 6)),
           "s1.size": rng.uniform(0.1, 2, (2, 30, 3)),
           "s1.size_class": rng.normal(size=(2, 30, 4)),
           "s1.size_res": rng.normal(size=(2, 30, 4, 3))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    assert_close_to_max(
        tc.decode({k: torch.from_numpy(v) for k, v in out.items()},
                  "s1.").numpy(),
        np.asarray(jc.decode({k: jnp.asarray(v) for k, v in out.items()},
                             "s1.")), 1e-7)


@pytest.mark.parametrize("train", [False, True])
def test_decoder_layer_with_masks_matches(train):
    """The decoder layer with Group-Free 3D's options: query positions 6
    wide (a box), key positions 3 wide (a point), masked keys and queries
    (flax's lowest logit; the second sample's keys all masked: uniform
    weights, finite outputs), in eval and train mode (the embeddings'
    batch statistics): outputs within 1e-5 of the max and the gradients
    of a probe within 1e-4 of the max over the layer's parameters and
    its embeddings'. The port's layer takes the embeddings ready-made
    from two standalone ``PositionEmbeddingLearned``, as its Group-Free
    3D head gives them; TransFusion's layer holds its own."""
    rng = np.random.default_rng(8)
    q, k = (rng.normal(size=(2, n, 32)).astype(np.float32) for n in (12, 40))
    qp = rng.normal(size=(2, 12, 6)).astype(np.float32)
    kp = rng.normal(size=(2, 40, 3)).astype(np.float32)
    kmask = rng.uniform(size=(2, 40)) > 0.3
    kmask[1] = False
    qmask = rng.uniform(size=(2, 12)) > 0.2
    probe = rng.normal(size=(2, 12, 32)).astype(np.float32)
    jl = JLayer(32, 4, 64, dropout=0.0)
    args = tuple(map(jnp.asarray, (q, k, qp, kp)))
    masks = dict(key_mask=jnp.asarray(kmask), query_mask=jnp.asarray(qmask))
    variables = random_variables(jl, *args, seed=3, **masks)

    def loss(params, *a):
        out, _ = jl.apply({"params": params, "batch_stats": variables[
            "batch_stats"]}, *a, train=train, mutable=["batch_stats"],
            **masks)
        return jnp.sum(out * probe), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(
        variables["params"], *args).compile(OPTIMIZED_XLA)(
            variables["params"], *args)
    # the JAX layer owns its embeddings; the port's Group-Free 3D head
    # holds them beside a layer that takes them ready-made
    sd = state_dict_from_jax({c: {"pts_bbox_head_m": {"decoder_0": v}}
                              for c, v in variables.items()})
    pre = "pts_bbox_head.decoder.0."
    port = {"": TransformerDecoderLayer(32, 4, 64, dropout=0.0,
                                        with_posembed=False),
            "self_posembed.": PositionEmbeddingLearned(6, 32),
            "cross_posembed.": PositionEmbeddingLearned(3, 32)}
    for name, m in port.items():
        n = len(pre + name)
        m.load_state_dict({k[n:]: v for k, v in sd.items()
                           if k.startswith(pre + name) and (name or all(
                               e not in k for e in ("self_posembed.",
                                                    "cross_posembed.")))})
        m.train(train)
    qpt, kpt = map(torch.from_numpy, (qp, kp))
    got = port[""](*map(torch.from_numpy, (q, k)),
                   port["self_posembed."](qpt), port["cross_posembed."](kpt),
                   key_mask=torch.from_numpy(kmask),
                   query_mask=torch.from_numpy(qmask))
    assert torch.isfinite(got).all()
    assert_close_to_max(got.detach().numpy(), np.asarray(want), 1e-5)
    (got * torch.from_numpy(probe)).sum().backward()
    jg = state_dict_from_jax({"params": {"pts_bbox_head_m": {
        "decoder_0": jax.device_get(grads)}}})
    # one scale for the layer and its embeddings: in train mode the first
    # embedding conv's bias has a gradient of 0 up to rounding (the BN
    # after it)
    named = [(pre + name + n, p) for name, m in port.items()
             for n, p in m.named_parameters()]
    assert len(named) == len(jg)
    want = np.concatenate([jg[n].numpy().ravel() for n, _ in named])
    got = np.concatenate([p.grad.numpy().ravel() for _, p in named])
    assert_close_to_max(got, want, 1e-4)


def _tiny_cfg(agnostic: bool, stages: str) -> dict:
    cfg = tflagship.groupfree3d_model_cfg(tiny=True)
    cfg["bbox_head"]["bbox_coder"]["size_cls_agnostic"] = agnostic
    cfg["bbox_head"]["dropout"] = 0.0
    cfg["test_cfg"]["prediction_stages"] = stages
    return cfg


def _optim() -> dict:
    cfg = tflagship.groupfree3d_optim_cfg()
    cfg["optimizer"] = {k: v for k, v in cfg["optimizer"].items()
                        if k != "paramwise_cfg"}
    return cfg


@pytest.fixture(scope="module", params=[(True, "last"), (False, "all")],
                ids=["agnostic-last", "by_class-all"])
def case(request):
    agnostic, stages = request.param
    batch = {k: np.asarray(v) for k, v in tiny_batch().items()}
    out = indoor_variant_case(_tiny_cfg(agnostic, stages), batch, _optim(),
                              widen=(jlayers, jgf))
    out["agnostic"] = agnostic
    return out


def test_tiny_config_is_the_jax_test_model():
    """The port's tiny Group-Free 3D is the JAX test's model
    (``groupfree_head_cfg()``, 'last' stage), ``in_channels`` set to its
    points' width (which the JAX package ignores)."""
    want = dict(type="GroupFree3DNet", backbone=dict(backbone_cfg(),
                                                     in_channels=4),
                bbox_head=groupfree_head_cfg(),
                test_cfg=dict(max_output_num=8, prediction_stages="last"))
    assert jax_cfg(tflagship.groupfree3d_model_cfg(tiny=True)) == want


def test_head_outputs_match(case):
    check_indoor_outputs(case, index_keys=("query_points_sample_inds",))


def test_predict_matches(case):
    assert case["got_pred"]["bboxes"].shape == (2, 8, 7)
    check_indoor_predict(case)


def test_loss_terms_match(case):
    sizes = ("size_reg_loss",) if case["agnostic"] else \
        ("size_class_loss", "size_res_loss")
    check_indoor_losses(case, {"sampling_objectness_loss"} | {
        f"{p}{t}" for p in ("proposal.", "s0.", "s1.")
        for t in STAGE_TERMS + sizes})


def test_module_gradients_match(case):
    check_indoor_gradients(case, GF3D_TOPS)


def test_train_step_matches_jax(case):
    check_indoor_step(case, 0.006, 0.1)


def test_dropout_draws_from_the_train_steps_generator():
    """With the decoder's dropout on, a train-mode forward raises without
    a generator, repeats its losses from the same seed and moves them
    with another; eval mode draws nothing."""
    model, batch_fn = tflagship.build_groupfree3d(tiny=True, device="cpu")
    batch = batch_fn(2, seed=1)
    with torch.no_grad():
        model.eval()(batch, device="cpu")
        model.train()
        with pytest.raises(RuntimeError, match="torch.Generator"):
            model(batch, mode="loss", device="cpu")
        runs = [model(batch, mode="loss", device="cpu",
                      generator=torch.Generator().manual_seed(s))
                for s in (1, 1, 2)]
    a, b, c = ({k: float(v) for k, v in r.items()} for r in runs)
    assert a == b and a != c


def test_full_width_config_carries_the_jax_tree():
    """The full-width Group-Free 3D (``groupfree3d_8x4_scannet-3d-18class-
    L6-O256.py``) takes every variable of the JAX package's detector built
    from the same config, strictly (the JAX tree from ``jax.eval_shape``,
    no init): 6 decoder layers, 18 size classes, the reference's names."""
    cfg = tflagship.groupfree3d_model_cfg()
    jmodel = jbuild_detector(jax_cfg(cfg))
    batch = {k: jnp.asarray(v) for k, v in
             tflagship.synthetic_scannet_batch(1, num_points=4096).items()}
    variables = random_variables(jmodel, batch, train=False, mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    head = port.bbox_head
    assert port.backbone.SA_modules[0].mlps[0].layer0.conv.in_channels == 3
    assert len(head.decoder_layers) == 6
    assert head.conv_pred.conv_reg.out_channels == 3 + 2 + 18 * 4
    assert head.prediction_heads[5].conv_cls.out_channels == 19
    assert head.decoder_self_posembeds[0].position_embedding_head[
        0].in_channels == 6
    assert head.points_obj_cls.mlp.layer2.conv.out_channels == 1
