"""The two-stage (csgo) world model's training of diamond_tpu_torch against the JAX
package, on the CPU in float32 at tests/test_torch_two_stage.py's tiny size (factor 2,
16x16 frames, 8x8 low-res; the same weights through the weight bridge, the JAX draws
rebuilt from its key splits and injected):
  * ``loss_upsampler`` with every gradient, with and without padded frames;
  * the upsampler step and the two-stage denoiser step (frames downsampled by 2 inside
    the step), two updates at k = 1 and k = 2; the upsampler's eval step.

The JAX upsampler's loss and step run op by op (``jax.disable_jit()``), as the JAX env's
own resolution change runs: under jit XLA fuses the area mean's sum in another order and
the floor onto the uint8 grid lands one level off in most pixels of the conditioning
(tests/test_torch_two_stage.py). The two-stage denoiser step is held to the jitted JAX
denoiser step fed the JAX package's own op-by-op ``_two_stage_obs`` of the same
segments, which the port's step computes inside itself.

Tolerances, each with its reason: losses 1e-5 relative, metrics 1e-4 (f32 through the
U-Net in other orders); gradients within 1e-4 of max(1, the JAX leaf's largest |value|);
parameters after the updates within 2e-2 of lr where the gradients are firm
(tests/test_torch_denoiser_training.py's rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diamond_tpu.data.segment import DeviceBatch as JDeviceBatch
from diamond_tpu.models.agent import configure_opt as j_configure_opt
from diamond_tpu.training import TrainState as JTrainState
from diamond_tpu.training import _two_stage_obs as j_two_stage_obs
from diamond_tpu.training import make_denoiser_train_step as j_make_denoiser_step
from diamond_tpu.training import make_upsampler_train_step as j_make_upsampler_step
from diamond_tpu_torch.data.episode import obs_to_float
from diamond_tpu_torch.data.segment import DeviceBatch
from diamond_tpu_torch.models import DenoiserDraws
from diamond_tpu_torch.models.agent import configure_opt
from diamond_tpu_torch.training import (TrainState, make_denoiser_train_step,
                                        make_upsampler_eval_step, make_upsampler_train_step)

from test_torch_denoiser_training import LR, _grads_close, _params_close
from test_torch_two_stage import (C, F_UP, HIGH, J_SIGMA, LOW, NA, NC, SIGMA,  # noqa: F401
                                  fresh, models)
from torch_port_util import t


def upsampler_draws(key, n, hw=HIGH):
    """The port's draws for the JAX ``loss_upsampler`` with ``key`` (denoiser.py
    ``loss_upsampler``, ``sample_sigma_training``, ``apply_noise``): one window of n."""
    k_sigma, k_noise = jax.random.split(key)
    k_off, k_iid = jax.random.split(k_noise)
    return DenoiserDraws(t(np.asarray(jax.random.normal(k_sigma, (n,))))[None],
                         t(np.asarray(jax.random.normal(k_off, (n, 1, 1, C))))[None],
                         t(np.asarray(jax.random.normal(k_iid, (n, hw, hw, C))))[None])


def low_draws(key, windows, b, hw=LOW):
    """The port's draws for the JAX ``Denoiser.loss`` with ``key``."""
    sig, off, iid = [], [], []
    for _ in range(windows):
        key, k_sigma, k_noise = jax.random.split(key, 3)
        k_off, k_iid = jax.random.split(k_noise)
        sig.append(np.asarray(jax.random.normal(k_sigma, (b,))))
        off.append(np.asarray(jax.random.normal(k_off, (b, 1, 1, C))))
        iid.append(np.asarray(jax.random.normal(k_iid, (b, hw, hw, C))))
    return DenoiserDraws(*(t(np.stack(a)) for a in (sig, off, iid)))


def segments(seed, b, t_total, padded=()):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (b, t_total, HIGH, HIGH, C), dtype=np.uint8)
    act = rng.integers(0, NA, (b, t_total)).astype(np.int32)
    mask = np.ones((b, t_total), bool)
    for bi, ti in padded:
        mask[bi, ti] = False
    return obs, act, mask


def port_batch(obs, act, mask):
    b, t_total = act.shape
    z = dict(dtype=torch.int32)
    return DeviceBatch(obs=t(obs), act=t(act), rew=torch.zeros((b, t_total)),
                       end=torch.zeros((b, t_total), **z), trunc=torch.zeros((b, t_total), **z),
                       mask_padding=t(mask), final_obs=torch.zeros((b, HIGH, HIGH, C),
                                                                   dtype=torch.uint8),
                       has_final_obs=torch.zeros((b,), dtype=torch.bool))


def jax_batch(obs, act, mask):
    b, t_total = act.shape
    return JDeviceBatch(obs=jnp.asarray(obs), act=jnp.asarray(act),
                        rew=jnp.zeros((b, t_total)), end=jnp.zeros((b, t_total), jnp.int32),
                        trunc=jnp.zeros((b, t_total), jnp.int32), mask_padding=jnp.asarray(mask),
                        final_obs=jnp.zeros((b,) + obs.shape[2:], jnp.uint8),
                        has_final_obs=jnp.zeros((b,), bool))


@pytest.mark.parametrize("padded", [(), [(0, 1), (2, 0)]], ids=["full", "padded"])
def test_loss_upsampler_and_gradients_match_jax(fresh, padded):
    m = fresh
    ju, u_vars, pu = m["ju"], m["u_vars"], m["pu"]
    obs_u8, _, mask = segments(8, 3, 2, padded)
    obs = np.asarray(obs_u8, np.float32) / 255.0 * 2.0 - 1.0
    key = jax.random.PRNGKey(9)

    def j_loss(params):
        return ju.loss_upsampler({"params": params, "constants": u_vars["constants"]},
                                 jnp.asarray(obs), mask, key, J_SIGMA)

    with jax.disable_jit():  # op by op (see above)
        (loss_j, _), grads_j = jax.value_and_grad(j_loss, has_aux=True)(u_vars["params"])
    pu.inner_model.zero_grad(set_to_none=True)
    loss, metrics = pu.loss_upsampler(obs_to_float(t(obs_u8)), t(mask), SIGMA,
                                      draws=upsampler_draws(key, 6))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert not metrics["loss_denoising"].requires_grad
    _grads_close(pu.inner_model, grads_j, 1e-4)
    with pytest.raises(ValueError, match="upsampling_factor"):
        m["pd"].loss_upsampler(obs_to_float(t(obs_u8)), t(mask), SIGMA)



def j_build_tx(warmup, k):
    tx = j_configure_opt(LR, 1e-2, 1e-8, 0.5, warmup)
    return tx if k == 1 else optax.MultiSteps(tx, every_k_schedule=k)


def low_u8(obs_u8):
    """The JAX package's ``_two_stage_obs`` of uint8 segments, run op by op, as uint8
    (exact: its values lie on the grid)."""
    with jax.disable_jit():
        low = np.asarray(j_two_stage_obs(jnp.asarray(obs_u8), F_UP))
    return np.round((low + 1.0) * 127.5).astype(np.uint8)


J_GRADS = {}


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("which", ["upsampler", "denoiser"])
def test_two_stage_train_steps_match_jax(fresh, which, k):
    """Two updates (2k micro-steps) of the upsampler step and of the two-stage denoiser
    step (frames downsampled by 2 inside the step) against the JAX steps from the same
    weights, batches and keys (see above for how each JAX step runs): the metrics of
    each micro-step, and the parameters after each update. Decay 1e-2, clipping at 0.5,
    warmup 2."""
    m = fresh
    b = 3
    tx = configure_opt(LR, 1e-2, 1e-8, 0.5, 2, grad_acc_steps=k)
    if which == "upsampler":
        jm, v, pm = m["ju"], m["u_vars"], m["pu"]
        t_total = 2
        j_step = j_make_upsampler_step(jm, j_build_tx(2, k), J_SIGMA)
        step = make_upsampler_train_step(pm, tx, SIGMA)
        draws = lambda key: upsampler_draws(key, b * t_total)  # noqa: E731

        def j_inputs(obs_u8):  # the full-resolution frames, downsampled in the loss
            return obs_u8

        def j_loss(params, obs_u8, act, mask, key):
            obs = jnp.asarray(obs_u8, jnp.float32) / 255.0 * 2.0 - 1.0
            return jm.loss_upsampler({"params": params, "constants": v["constants"]},
                                     obs, mask, key, J_SIGMA)[0]
    else:
        jm, v, pm = m["jd"], m["d_vars"], m["pd"]
        t_total = NC + 2
        j_step = j_make_denoiser_step(jm, j_build_tx(2, k), J_SIGMA)
        step = make_denoiser_train_step(pm, tx, SIGMA, downsample_factor=F_UP)
        draws = lambda key: low_draws(key, 2, b)  # noqa: E731
        j_inputs = low_u8

        def j_loss(params, obs_u8, act, mask, key):
            obs = jnp.asarray(obs_u8, jnp.float32) / 255.0 * 2.0 - 1.0
            return jm.loss({"params": params, "constants": v["constants"]}, obs, act, mask,
                           key, J_SIGMA)[0]

    state = TrainState.create(pm.inner_model, tx)
    state_j = JTrainState.create(jax.tree_util.tree_map(jnp.array, v["params"]),
                                 j_build_tx(2, k))
    old = {n: q.detach().clone() for n, q in pm.inner_model.named_parameters()}
    # the firmness mask of the parameter check, compiled once for both k
    j_grad = J_GRADS.setdefault(which, jax.jit(jax.grad(j_loss)))
    grads = []
    for i in range(2 * k):
        obs_u8, act, mask = segments(20 + i, b, t_total, [(1, t_total - 1)])
        key = jax.random.PRNGKey(30 + i)
        obs_j = j_inputs(obs_u8)
        grads.append(j_grad(state_j.params, obs_j, act, mask, key))
        batch_j = jax_batch(obs_j, act, mask)
        if which == "upsampler":
            with jax.disable_jit():  # op by op (see above)
                state_j, m_j = j_step(state_j, v["constants"], batch_j, key)
        else:
            state_j, m_j = j_step(state_j, v["constants"], batch_j, key)
        state, mp = step(state, port_batch(obs_u8, act, mask), draws=draws(key))
        assert state.step == i + 1
        for name in ("loss_denoising", "grad_norm_before_clip"):
            assert not mp[name].requires_grad
            np.testing.assert_allclose(mp[name].item(), float(m_j[name]), rtol=1e-4,
                                       err_msg=name)
        if (i + 1) % k == 0:
            _params_close(pm.inner_model, state_j.params, grads[i + 1 - k:i + 1], 2e-2)
    for n, q in pm.inner_model.named_parameters():
        assert not torch.equal(q.detach(), old[n]), f"{n} did not move"


def test_upsampler_eval_step_is_the_loss(fresh):
    pu = fresh["pu"]
    obs_u8, act, mask = segments(40, 2, 2)
    d = upsampler_draws(jax.random.PRNGKey(4), 4)
    got = make_upsampler_eval_step(pu, SIGMA)(port_batch(obs_u8, act, mask), draws=d)
    loss, _ = pu.loss_upsampler(obs_to_float(t(obs_u8)), t(mask), SIGMA, draws=d)
    assert not got["loss_denoising"].requires_grad
    assert got["loss_denoising"].item() == loss.item()
