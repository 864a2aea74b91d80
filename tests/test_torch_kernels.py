"""diamond_tpu_torch kernels: the plain PyTorch version of each Hopper kernel against the
JAX package's Pallas kernel (interpret mode, as tests/test_ops.py runs them) and the CPU
dispatch. The CUDA kernels themselves are tested on a card (tests/test_torch_cuda.py).

Tolerances: f32 on the CPU; the two sides sum in different orders, which moves results
by a few f32 ulps of values of order 1-10, so rtol = atol = 1e-4 (2e-4 for the conv,
whose 9*C-term sums are longer)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.ops import conv3x3_im2col, fused_adagn_silu, fused_groupnorm_silu
from diamond_tpu_torch.ops import (adagn_silu, adagn_silu_plain, conv3x3, conv3x3_plain,
                                   groupnorm_silu, groupnorm_silu_plain)

from torch_port_util import close, t

B, H, W = 2, 8, 8


def _x(rng, c, h=H):
    return (rng.normal(size=(B, h, h, c)) * 2 + 0.5).astype(np.float32)


@pytest.mark.parametrize("c", [64, 128])
def test_adagn_silu_plain_matches_pallas(c):
    rng = np.random.default_rng(0)
    x, ss = _x(rng, c), rng.normal(size=(B, 2 * c)).astype(np.float32)
    g = c // 32
    ref = fused_adagn_silu(jnp.asarray(x), jnp.asarray(ss), g, interpret=True)
    close(adagn_silu_plain(t(x), t(ss), g), ref, 1e-4, 1e-4)


@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_silu_plain_matches_pallas(silu):
    rng = np.random.default_rng(1)
    c = 64
    x = _x(rng, c)
    scale = (1 + 0.3 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.3 * rng.normal(size=(c,))).astype(np.float32)
    ref = fused_groupnorm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 2,
                               silu=silu, interpret=True)
    close(groupnorm_silu_plain(t(x), t(scale), t(bias), 2, silu), ref, 1e-4, 1e-4)


def test_conv3x3_plain_matches_pallas():
    rng = np.random.default_rng(2)
    x = _x(rng, 64)
    k = (rng.uniform(-1, 1, (3, 3, 64, 32)) / 24).astype(np.float32)
    ref = conv3x3_im2col(jnp.asarray(x), jnp.asarray(k), interpret=True)
    close(conv3x3_plain(t(x), t(k)), ref, 2e-4, 2e-4)


@pytest.mark.parametrize("stride,cin,h", [(1, 3, 8), (1, 12, 8), (2, 64, 8), (2, 32, 9)])
def test_conv3x3_plain_stride_and_bias_match_lax(stride, cin, h):
    """Stride 2 (Downsample) and the bias epilogue against lax.conv_general_dilated with
    the JAX package's padding ((1, 1), (1, 1)), odd sizes included."""
    rng = np.random.default_rng(3)
    x = _x(rng, cin, h)
    k = (rng.uniform(-1, 1, (3, 3, cin, 64)) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(k), (stride, stride),
                                       ((1, 1), (1, 1)),
                                       dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    close(conv3x3_plain(t(x), t(k), t(b), stride), ref, 2e-4, 2e-4)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(4)
    x, ss = t(_x(rng, 64)), t(rng.normal(size=(B, 128)).astype(np.float32))
    k = t(rng.normal(size=(3, 3, 64, 64)).astype(np.float32))
    one, zero = torch.ones(64), torch.zeros(64)
    counts = (adagn_silu.launches, groupnorm_silu.launches, conv3x3.launches)
    assert torch.equal(adagn_silu(x, ss, 2), adagn_silu_plain(x, ss, 2))
    assert torch.equal(groupnorm_silu(x, one, zero, 2, False),
                       groupnorm_silu_plain(x, one, zero, 2, False))
    assert torch.equal(conv3x3(x, k, zero, 2), conv3x3_plain(x, k, zero, 2))
    assert (adagn_silu.launches, groupnorm_silu.launches, conv3x3.launches) == counts
    if not torch.cuda.is_available():
        assert counts == (0, 0, 0)


def test_kernel_modules_import_and_run_on_cpu_without_nvcc(tmp_path):
    """Importing the kernel modules builds nothing; CPU calls need no CUDA toolkit."""
    code = ("import torch, diamond_tpu_torch.kernels as k, diamond_tpu_torch.ops as o\n"
            "x = torch.randn(1, 4, 4, 32)\n"
            "o.conv3x3(x, torch.randn(3, 3, 32, 8)); o.groupnorm_silu(x, torch.ones(32), "
            "torch.zeros(32), 1)\n"
            "assert k._lib is None\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
