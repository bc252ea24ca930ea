"""Helpers shared by the port's parity tests (tests/test_torch_*.py):
random JAX variables drawn with numpy, and carrying a JAX module's
variables into the matching port module."""
import jax
import numpy as np
import torch

from isfusion_tpu_torch.runner.convert import state_dict_from_jax


def random_variables(module, *args, seed=0, **kwargs):
    """Variables of a flax ``module`` with the shapes ``module.init`` gives,
    drawn with numpy: kernels N(0, 1/fan_in), norm scales U(0.5, 1.5),
    biases N(0, 0.1), BN means N(0, 0.5), BN variances U(0.5, 2) -- so no
    norm is the identity. Only traces the module (no init compile)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name == "scale":
            x = rng.uniform(0.5, 1.5, s.shape)
        elif name == "var":
            x = rng.uniform(0.5, 2.0, s.shape)
        elif name == "mean":
            x = rng.normal(0, 0.5, s.shape)
        elif name == "kernel":
            fan_in = max(int(np.prod(s.shape[:-1])), 1)
            x = rng.normal(0, 1.0 / np.sqrt(fan_in), s.shape)
        else:
            x = rng.normal(0, 0.1, s.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def load_from_jax(port_module: torch.nn.Module, variables, jax_path: str,
                  ref_prefix: str) -> torch.nn.Module:
    """Carry a JAX module's ``variables`` (at ``jax_path``, e.g.
    'fusion_encoder_m/instance_att', inside the JAX detector) into
    ``port_module`` (named ``ref_prefix`` in the reference state_dict);
    eval mode."""
    def nest(tree):
        for name in reversed(jax_path.split("/")):
            tree = {name: tree}
        return tree

    sd = state_dict_from_jax({c: nest(variables[c]) for c in variables})
    n = len(ref_prefix) + 1
    port_module.load_state_dict({k[n:]: v for k, v in sd.items()
                                 if k.startswith(ref_prefix + ".")})
    return port_module.eval()


def assert_close_to_max(got, want, tol):
    """|got - want| <= tol * max|want| elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"max error {err:.3g} of the max exceeds {tol}"
