"""The port's ImVoxelNet (``flagship.imvoxelnet_model_cfg``) against the
JAX package's on carried weights: ``OutdoorImVoxelNeck`` alone (train and
eval mode, outputs and gradients), and the tiny detector (the JAX test's
``tiny_cfg``) in the lift's volume, the head outputs, predict (K10-NMS's
plain version), the loss terms, every top module's gradients and one
AdamW + clip step of the config's recipe (the backbone at ``lr_mult``
0.1); with ``lidar2img``, with ``cam2img`` alone, and a ``KeyError`` with
neither; the converter's whole ImVoxelNet tree, ``neck_3d`` included.

The JAX variables are drawn with numpy (``tests/torch_parity.py``) and
carried with ``state_dict_from_jax``; the JAX detector is one jitted call
at XLA:CPU backend level 1 (volume, head outputs, decode, losses,
gradients, the optimizer update; the volume taken from the 3D neck's
input by ``flax.linen.intercept_methods``).

Tolerances (float32, CPU): the volume, head outputs and gradients 1e-3 of
their max (the lift's samples 1e-5); losses 1e-4 relative; kept boxes as
``assert_same_kept_boxes``; updates within 1e-2 of the lr.
"""
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models import build_detector as jbuild_detector
from isfusion_tpu.models.detectors.imvoxelnet import \
    OutdoorImVoxelNeck as JaxNeck
from isfusion_tpu.parallel.train_step import total_loss
from isfusion_tpu.runner import optim as joptim
from isfusion_tpu_torch import flagship as tflagship
from isfusion_tpu_torch.models.builder import build_detector
from isfusion_tpu_torch.models.detectors.imvoxelnet import (
    OutdoorImVoxelNeck, lift)
from isfusion_tpu_torch.parallel.train_step import make_train_step
from isfusion_tpu_torch.runner import optim as toptim
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from test_models.test_imvoxelnet import tiny_cfg
from torch_parity import (OPTIMIZED_XLA, assert_close_to_max,
                          assert_same_kept_boxes, check_step, jax_cfg,
                          load_from_jax, random_variables)

LOSSES = {"loss_cls", "loss_bbox", "loss_dir"}
MODULES = ("backbone", "neck", "neck_3d", "bbox_head")


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def test_tiny_config_is_the_jax_test_model():
    cfg = tflagship.imvoxelnet_model_cfg(tiny=True)
    want = tiny_cfg()
    # the port's tiny config names the Car anchors' direction loss and
    # code size as the JAX test does; nothing else differs
    assert _plain(jax_cfg(cfg)) == _plain(want)


@pytest.mark.parametrize("train", [False, True])
def test_outdoor_neck_matches(train):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 6, 5, 8)).astype(np.float32)  # B nz ny nx C
    jneck = JaxNeck(in_channels=8, out_channels=12)
    variables = random_variables(jneck, jnp.asarray(x), seed=1)
    probe = rng.normal(size=(2, 6, 5, 12)).astype(np.float32)

    def fn(params, xx):
        out = jneck.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xx,
                          train=train, mutable=["batch_stats"])[0]
        return jnp.sum(out * probe), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True))(variables["params"],
                                           jnp.asarray(x))
    port = load_from_jax(OutdoorImVoxelNeck(in_channels=8, out_channels=12),
                         variables, "neck_3d_m", "neck_3d").train(train)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous() \
        .requires_grad_(True)
    got = port(xt)
    (got * torch.from_numpy(probe)).sum().backward()
    assert got.shape == (2, 6, 5, 12)
    assert_close_to_max(got.detach().numpy(), np.asarray(want), 1e-4)
    assert_close_to_max(xt.grad.permute(0, 2, 3, 4, 1).numpy(),
                        np.asarray(gx), 1e-4)
    jg = state_dict_from_jax({"params": {"neck_3d_m": jax.device_get(gp)}})
    for name, p in port.named_parameters():
        assert_close_to_max(p.grad.numpy(), jg[f"neck_3d.{name}"].numpy(),
                            1e-4)


def _intercepted_volume(store):
    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxNeck) and \
                context.method_name == "__call__":
            store.append(args[0])
        return next_fun(*args, **kwargs)
    return fnn.intercept_methods(interceptor)


@pytest.fixture(scope="module")
def case():
    cfg = tflagship.imvoxelnet_model_cfg(tiny=True)
    ocfg = tflagship.imvoxelnet_optim_cfg()
    _, batch_fn = tflagship.build_imvoxelnet(tiny=True, device="cpu")
    batch = batch_fn(2, seed=1)
    jmodel = jbuild_detector(jax_cfg(cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(jmodel, jbatch, train=False, mode="feats")
    port = build_detector(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    tx = joptim.build_optimizer(variables["params"], ocfg["optimizer"],
                                ocfg["optimizer_config"], ocfg["lr_config"],
                                None, total_steps=100)

    def loss_fn(params, bs):
        losses, _ = jmodel.apply({"params": params, "batch_stats": bs},
                                 jbatch, train=True, mode="loss",
                                 mutable=["batch_stats"])
        return total_loss(losses), losses

    def run(v):
        store = []
        with _intercepted_volume(store):
            feats = jmodel.apply(v, jbatch, train=False, mode="feats")
        decoded = jmodel.apply(v, feats, method=lambda m, p:
                               m.bbox_head_m.get_bboxes(p))
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"], v["batch_stats"])
        updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
        import optax
        return store[0], feats, decoded, losses, grads, \
            optax.apply_updates(v["params"], updates)

    out = jax.device_get(jax.jit(run).lower(variables).compile(
        OPTIMIZED_XLA)(variables))
    volume, feats, decoded, jl, jg, jafter = out
    port.eval()
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        got_volume = lift(port.extract_feat(t["img"]), t["lidar2img"],
                          port.centers, batch["img"].shape[1:3])
    got_feats = port(batch, mode="feats", device="cpu")
    got_pred = port(batch, device="cpu")
    trained = copy.deepcopy(port).train()
    tl = trained(batch, mode="loss", device="cpu")
    sum(tl.values()).backward()
    stepped = copy.deepcopy(port).train()
    before = {k: v.clone() for k, v in stepped.state_dict().items()}
    opt = toptim.build_optimizer(stepped, ocfg["optimizer"])
    tm = make_train_step(stepped, opt, toptim.build_schedule(
        opt, ocfg["lr_config"], None, 100), toptim.grad_clip_norm(
            ocfg["optimizer_config"]))(batch, torch.Generator())
    return dict(cfg=cfg, batch=batch, variables=variables, jmodel=jmodel,
                port=port, volume=volume, feats=feats, decoded=decoded,
                jl={k: float(v) for k, v in jl.items()},
                jg=state_dict_from_jax({"params": jg}),
                jafter=state_dict_from_jax({"params": jafter}),
                before=before, stepped=stepped, tm=tm,
                got_volume=got_volume, got_feats=got_feats,
                got_pred=got_pred, trained=trained,
                tl={k: float(v.detach()) for k, v in tl.items()})


def test_volume_matches(case):
    got = case["got_volume"].permute(0, 2, 3, 4, 1).numpy()
    want = np.asarray(case["volume"])
    assert got.shape == want.shape
    # some voxels sample the image and some lie outside it
    filled = np.abs(want).max(-1) > 0
    assert 0.1 < filled.mean() < 0.9
    np.testing.assert_array_equal(np.abs(got).max(-1) > 0, filled)
    assert_close_to_max(got, want, 1e-5)


def _check_feats(got, want):
    assert len(got) == len(want) == 1
    for g, w in zip(got[0], want[0]):
        assert_close_to_max(g.numpy(), np.asarray(w), 1e-3)


def test_head_outputs_match(case):
    _check_feats(case["got_feats"], case["feats"])


def test_predict_matches(case):
    got = {k: v.numpy() for k, v in case["got_pred"].items()}
    assert np.asarray(case["decoded"]["mask"]).sum() >= 8
    assert_same_kept_boxes(got, case["decoded"])


def test_loss_terms_match(case):
    jl, tl = case["jl"], case["tl"]
    assert set(tl) == set(jl) == LOSSES
    for k in jl:
        assert jl[k] > 0, k
        assert _rel(tl[k], jl[k]) <= 1e-4, (k, tl[k], jl[k])


@pytest.mark.parametrize("top", MODULES)
def test_module_gradients_match(case, top):
    jg = case["jg"]
    got, want = [], []
    for name, p in case["trained"].named_parameters():
        if name.split(".")[0] == top:
            # the tiny ResNet's fourth stage feeds nothing: no gradient
            # here, zeros there
            want.append(jg[name].numpy().ravel())
            got.append((p.grad if p.grad is not None else
                        torch.zeros_like(p)).numpy().ravel())
    want = np.concatenate(want)
    assert np.abs(want).max() > 0, top
    assert_close_to_max(np.concatenate(got), want, 1e-3)


def test_train_step_matches_jax(case):
    """AdamW + clip 35, the backbone at 0.1 of the lr (on both sides: its
    parameters move by at most 0.1 of the others' first update)."""
    assert check_step(case, 1e-4, 35.0) > 2000
    moved = [float((p.detach() - case["before"][n]).abs().max())
             for n, p in case["stepped"].named_parameters()
             if n.startswith("backbone.")]
    assert 0 < max(moved) <= 1.01e-5


def test_cam2img_alone_and_the_preference(case):
    """Without lidar2img both packages project with cam2img; with both,
    lidar2img wins; with neither both raise ``KeyError``."""
    batch, jmodel, variables = case["batch"], case["jmodel"], \
        case["variables"]
    cam = {k: v for k, v in batch.items() if k != "lidar2img"}
    cam["cam2img"] = batch["lidar2img"]
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False,
                                             mode="feats"))(
        variables, {k: jnp.asarray(v) for k, v in cam.items()})
    _check_feats(case["port"](cam, mode="feats", device="cpu"), want)
    both = dict(batch, cam2img=np.broadcast_to(
        np.eye(4, dtype=np.float32), batch["lidar2img"].shape).copy())
    got = case["port"](both, mode="feats", device="cpu")
    for g, w in zip(got[0], case["got_feats"][0]):
        assert torch.equal(g, w)
    neither = {k: v for k, v in batch.items() if k != "lidar2img"}
    with pytest.raises(KeyError):
        case["port"](neither, mode="feats", device="cpu")
    with pytest.raises(KeyError):
        jmodel.apply(variables, {k: jnp.asarray(v)
                                 for k, v in neither.items()},
                     train=False, mode="feats")


def test_converter_round_trip_with_neck_3d(case):
    """JAX variables -> the port's state_dict -> the JAX package's camera
    converter gives every leaf back but ``neck_3d_m``'s, which it leaves
    out; the port's own names carry those (OIDHW kernels)."""
    from isfusion_tpu.runner.full_ckpt_convert import \
        convert_camera_torch_to_flax

    variables = jax.device_get(case["variables"])
    sd = {k: v.numpy() for k, v in case["port"].state_dict().items()}
    out, missing = convert_camera_torch_to_flax(
        {k: v for k, v in sd.items() if not k.startswith("neck_3d.")},
        variables)
    assert missing and all(m.split("/")[1] == "neck_3d_m" for m in missing)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(out)[0])
    checked = 0
    for path, leaf in flat:
        if str(path[1].key) == "neck_3d_m":
            continue
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)
        checked += 1
    assert checked > 50
    neck = variables["params"]["neck_3d_m"]
    for i in range(3):
        np.testing.assert_array_equal(
            sd[f"neck_3d.conv{i}a.weight"],
            np.asarray(neck[f"conv{i}a"]["kernel"]).transpose(4, 3, 0, 1, 2))
        np.testing.assert_array_equal(sd[f"neck_3d.bn{i}a.running_var"],
                                      variables["batch_stats"]["neck_3d_m"][
                                          f"bn{i}a"]["var"])
    assert sum(k.startswith("neck_3d.") for k in sd) == 3 * 6 + 6
