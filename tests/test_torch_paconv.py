"""The port's PAConv (``isfusion_tpu_torch/ops/paconv.py``, K15's plain
versions; the PAConv branch of ``models/backbones/pointnet2.py``) against
the JAX package's (``isfusion_tpu/ops/paconv.py``) on the JAX tests'
tiny shapes (``tests/test_ops/test_paconv.py``), JAX variables drawn with
numpy and carried by ``state_dict_from_jax``.

Tolerances: ``assign_score_withk`` (sum and avg) and
``assign_kernel_withoutk`` (even and odd Cin) forward within 1e-6 of their
max, their gradients (scores, point and centre features) within 1e-6 of
the max of ``jax.grad``'s; ``paconv_bank_ref`` (K15-bank's plain
version) against the JAX layer's ``feats @ bank`` and einsum, forward and
gradients 1e-6; ScoreNet, the PAConv layer and a PAConv SA module in eval
mode 1e-5 of the max, in train mode (batch statistics) 1e-5, their
running statistics after one train-mode call 1e-6 (flax keeps the biased
batch variance of ScoreNet's BatchNorm, the port the unbiased one: the
JAX term is rescaled by n / (n - 1); the masked BN's is biased on both
sides), and every parameter's and input's gradient within 1e-4 of the max
of JAX's float64 gradient (the float32 ReLU inputs of the port against
exact ones).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu.models.backbones.pointnet2 import \
    PointSAModule as JPointSAModule
from isfusion_tpu.ops import paconv as J
from isfusion_tpu_torch.models.backbones.pointnet2 import PointSAModule
from isfusion_tpu_torch.ops import paconv as P
from isfusion_tpu_torch.runner.convert import state_dict_from_jax
from torch_parity import (assert_close_to_max, float64_jax, load_from_jax,
                          random_variables)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


def _score_inputs(seed=0, b=2, n=30, s=8, k=5, m=4, o=6):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(b, s, k, m)).astype(np.float32)
    pf = rng.normal(size=(b, n, m, o)).astype(np.float32)
    cf = rng.normal(size=(b, n, m, o)).astype(np.float32)
    knn = rng.integers(0, n, (b, s, k)).astype(np.int32)
    knn[:, :2, 1:] = knn[:, :2, :1]          # repeated indices
    probe = rng.normal(size=(b, s, k, o)).astype(np.float32)
    return scores, pf, cf, knn, probe


@pytest.mark.parametrize("aggregate", ["sum", "avg"])
def test_assign_score_withk_matches_jax(aggregate):
    """K15-score's plain version: forward and the three gradients."""
    scores, pf, cf, knn, probe = _score_inputs()

    def f(sc, p, c):
        return jnp.sum(J.assign_score_withk(sc, p, c, jnp.asarray(knn),
                                            aggregate) * probe)

    want = J.assign_score_withk(*map(jnp.asarray, (scores, pf, cf, knn)),
                                aggregate)
    wg = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (scores, pf, cf)))
    ts = [_t(a, True) for a in (scores, pf, cf)]
    got = P.assign_score_withk(*ts, _t(knn), aggregate)
    assert_close_to_max(got.detach().numpy(), np.asarray(want), 1e-6)
    (got * _t(probe)).sum().backward()
    for t, w in zip(ts, wg):
        assert_close_to_max(t.grad.numpy(), np.asarray(w), 1e-6)


@pytest.mark.parametrize("cin", [8, 7])
def test_assign_kernel_withoutk_matches_jax(cin):
    """Even Cin and odd Cin (the coordinate half)."""
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(1, 20, cin)).astype(np.float32)
    bank = rng.normal(size=(2 * cin, 3 * 5)).astype(np.float32)
    wp, wc = J.assign_kernel_withoutk(jnp.asarray(feats), jnp.asarray(bank),
                                      3)
    gp, gc = P.assign_kernel_withoutk(_t(feats), _t(bank), 3)
    assert gp.shape == (1, 20, 3, 5)
    assert_close_to_max(gp.numpy(), np.asarray(wp), 1e-6)
    assert_close_to_max(gc.numpy(), np.asarray(wc), 1e-6)


def test_paconv_bank_plain_version_matches_jax():
    """K15-bank's plain version against the JAX layer's contraction
    (``feats @ bank`` viewed (R, M, O), the einsum with the scores),
    forward and gradients."""
    rng = np.random.default_rng(2)
    r, c, m, o = 40, 12, 4, 6
    x, s, w = (rng.normal(size=shape).astype(np.float32)
               for shape in ((r, c), (r, m), (c, m * o)))
    probe = rng.normal(size=(r, o)).astype(np.float32)

    def f(x_, s_, w_):
        nf = jnp.matmul(x_, w_).reshape(r, m, o)
        return jnp.einsum("rm,rmo->ro", s_, nf)

    want = f(*map(jnp.asarray, (x, s, w)))
    wg = jax.grad(lambda *a: jnp.sum(f(*a) * probe), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, s, w)))
    ts = [_t(a, True) for a in (x, s, w)]
    got = P.paconv_bank(*ts)
    assert_close_to_max(got.detach().numpy(), np.asarray(want), 1e-6)
    (got * _t(probe)).sum().backward()
    for t, g in zip(ts, wg):
        assert_close_to_max(t.grad.numpy(), np.asarray(g), 1e-6)


def _layer_case(seed=2, b=1, s=6, k=4, c=8, out=16, m=4):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, s, k, c)).astype(np.float32)
    rel = rng.normal(size=(b, s, k, 3)).astype(np.float32)
    valid = rng.uniform(size=(b, s, k)) > 0.2
    mod = J.PAConv(out_channels=out, num_kernels=m, name="paconv0_0")
    args = tuple(map(jnp.asarray, (feats, rel, valid)))
    variables = random_variables(mod, *args)
    port = load_from_jax(P.PAConv(c, out, num_kernels=m), variables,
                         "backbone_m/sa0/paconv0_0",
                         "backbone.SA_modules.0.mlps.0.layer0")
    return mod, variables, port, (feats, rel, valid), args


def test_scorenet_matches_jax_eval_and_train():
    """ScoreNet alone: eval, then a train-mode call (batch statistics)
    and the running statistics it leaves."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 6, 7)).astype(np.float32)
    mod = J.ScoreNet([16, 16, 16, 4], name="scorenet")
    variables = random_variables(mod, jnp.asarray(x))
    port = load_from_jax(P.ScoreNet([7, 16, 16, 16, 4]), variables,
                         "backbone_m/sa0/paconv0_0/scorenet",
                         "backbone.SA_modules.0.mlps.0.layer0.scorenet")
    want = mod.apply(variables, jnp.asarray(x))
    assert_close_to_max(port(_t(x)).detach().numpy(), np.asarray(want), 1e-5)
    want, upd = mod.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    port.train()
    got = port(_t(x))
    assert_close_to_max(got.detach().numpy(), np.asarray(want), 1e-5)
    n = x.size // x.shape[-1]
    mom = 0.1
    for i in range(3):
        bn = getattr(port.mlps, f"layer{i}").bn
        jold = variables["batch_stats"][f"bn{i}"]
        jnew = upd["batch_stats"][f"bn{i}"]
        assert_close_to_max(bn.running_mean.numpy(), np.asarray(jnew["mean"]),
                            1e-6)
        batch_var = (np.asarray(jnew["var"], np.float64)
                     - (1 - mom) * np.asarray(jold["var"])) / mom
        want_v = (1 - mom) * np.asarray(jold["var"]) + \
            mom * batch_var * n / (n - 1)
        assert_close_to_max(bn.running_var.numpy(), want_v, 1e-5)
    assert port.mlps.layer3.bn is None and port.mlps.layer3.conv.bias \
        is not None


def test_paconv_layer_matches_jax():
    """The PAConv layer: eval forward (padded rows zero), train forward
    and the masked BN's running statistics, then every parameter's and
    input's gradient against JAX's float64 ones."""
    mod, variables, port, (feats, rel, valid), args = _layer_case()
    want = mod.apply(variables, *args)
    got = port(*(_t(a) for a in (feats, rel, valid)))
    assert_close_to_max(got.detach().numpy(), np.asarray(want), 1e-5)
    assert not got.detach().numpy()[~valid].any()
    want, upd = mod.apply(variables, *args, train=True,
                          mutable=["batch_stats"])
    port.train()
    got = port(*(_t(a) for a in (feats, rel, valid)))
    assert_close_to_max(got.detach().numpy(), np.asarray(want), 1e-5)
    jbn, jold = upd["batch_stats"]["bn"], variables["batch_stats"]["bn"]
    assert_close_to_max(port.bn.running_mean.numpy(), np.asarray(jbn["mean"]),
                        1e-6)
    assert_close_to_max(port.bn.running_var.numpy(), np.asarray(jbn["var"]),
                        1e-6)
    assert not np.allclose(np.asarray(jbn["mean"]), np.asarray(jold["mean"]))
    # gradients: JAX in float64 (the layer's masked BN widened too)
    probe = np.random.default_rng(9).normal(size=got.shape).astype(
        np.float32)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        from isfusion_tpu.models import layers as jlayers
        with float64_jax(jlayers):
            def loss(p, f, r):
                out, _ = mod.apply({"params": p,
                                    "batch_stats": v64["batch_stats"]}, f, r,
                                   jnp.asarray(valid), train=True,
                                   mutable=["batch_stats"])
                return jnp.sum(out * probe)
            gp, gf, gr = jax.grad(loss, argnums=(0, 1, 2))(
                v64["params"], jnp.asarray(feats, jnp.float64),
                jnp.asarray(rel, jnp.float64))
    tf, tr = _t(feats, True), _t(rel, True)
    port.zero_grad()
    (port(tf, tr, _t(valid)) * _t(probe)).sum().backward()
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a), {"backbone_m": {"sa0": {
            "paconv0_0": gp}}})})
    prefix = "backbone.SA_modules.0.mlps.0.layer0."
    for name, p in port.named_parameters():
        assert_close_to_max(p.grad.numpy(), want[prefix + name].numpy(), 1e-4)
    assert_close_to_max(tf.grad.numpy(), np.asarray(gf), 1e-4)
    assert_close_to_max(tr.grad.numpy(), np.asarray(gr), 1e-4)


def test_paconv_sa_module_matches_jax():
    """A PAConv set-abstraction level (FPS, ball query, two PAConv layers
    over the grouped features and grouped_xyz, max pool) on 64 points of 6
    channels: eval and train forward, the running statistics of every
    layer."""
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 64, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 64)) > 0.1
    mod = JPointSAModule(num_point=16, radii=[0.5], sample_nums=[8],
                         mlp_channels=[16, 32], sa_type="paconv",
                         num_kernels=4, name="sa0")
    args = tuple(map(jnp.asarray, (xyz, feats, mask)))
    variables = random_variables(mod, *args)
    port = load_from_jax(PointSAModule(16, [0.5], [8], [16, 32], 3,
                                       sa_type="paconv", num_kernels=4),
                         variables, "backbone_m/sa0",
                         "backbone.SA_modules.0")
    targs = tuple(_t(a) for a in (xyz, feats, mask))
    for train in (False, True):
        if train:
            want, upd = mod.apply(variables, *args, train=True,
                                  mutable=["batch_stats"])
            port.train()
        else:
            want = mod.apply(variables, *args)
        got = port(*targs)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        for g, w in zip(got[:2], want[:2]):
            assert_close_to_max(g.detach().numpy(), np.asarray(w), 1e-5)
    sd = port.state_dict()
    want = state_dict_from_jax({coll: {"backbone_m": {
        "sa0": jax.tree_util.tree_map(np.asarray, tree[coll])}}
        for coll, tree in (("params", variables), ("batch_stats", upd))})
    checked = 0
    for key, w in want.items():
        if key.endswith("running_mean") or (key.endswith("running_var")
                                            and ".scorenet." not in key):
            got = sd[key[len("backbone.SA_modules.0."):]]
            assert_close_to_max(got.numpy(), w.numpy(), 1e-6)
            checked += 1
    assert checked == 2 * 5     # a layer: 4 means, the masked variance
