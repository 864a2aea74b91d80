"""Shared helpers of the diamond_tpu_torch parity tests (tests/test_torch_*.py): the same
weights and inputs, made with numpy from a seed, go through the JAX package and the
port on the CPU in float32."""

from __future__ import annotations

import functools
import math
import os

import jax
import numpy as np
import torch

from diamond_tpu_torch.interop.jax_vars import load_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_variables(init, *args, seed: int, **kwargs):
    """Variables with the tree of ``init(key, *args)`` (traced, not run) and random values
    at the scale of the JAX package's initialisers: U(+-1/sqrt(fan_in)) for kernels and
    tables, 1 + N(0, 0.1) for norm scales, N(0, 0.1) for biases. Nothing is zero, so no
    parity check passes vacuously (zero-init output convs, attention out_proj, actor and
    critic heads all get weights)."""
    shapes = jax.eval_shape(functools.partial(init, **kwargs), jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if leaf.ndim > 1:
            bound = 1 / math.sqrt(math.prod(leaf.shape[:-1]))
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        base = 1.0 if getattr(path[-1], "key", None) == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_and_port(jax_module, port_module, seed: int, *init_args):
    """Random variables for the flax module, loaded into the port module too.
    Returns (numpy variables, port module)."""
    v = random_variables(jax_module.init, *init_args, seed=seed)
    return v, load_variables(port_module, v)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(port_out, jax_out, rtol: float, atol: float) -> None:
    np.testing.assert_allclose(port_out.detach().numpy() if isinstance(port_out, torch.Tensor)
                               else np.asarray(port_out),
                               np.asarray(jax_out), rtol=rtol, atol=atol)
