"""The denoiser train step of diamond_tpu_torch against the JAX package, on the CPU in
float32 at a tiny size (channels [8, 8], depths [1, 1], cond 16, attention at the second
level and in the mid blocks, 16x16 frames, 4 conditioning frames, B = 3): the same
weights through the weight bridge and the same draws, which the test rebuilds from the
JAX key splits of ``Denoiser.loss`` and injects into the port.

Tolerances, each with its reason:
  * the loss: 1e-5 relative (f32 convs, norms and matmuls summed in other orders);
  * the fed-back frame of the 2-window loss, in grid levels: at most one level apart in
    at most 0.1 % of the values (the floor onto the uint8 grid can flip on a last ulp);
  * every parameter's gradient within 1e-4 of max(1, the JAX leaf's largest |value|)
    (f32 sums through the U-Net in other orders), and no parameter without one;
  * the parameters after Adam steps: Adam's steps move a weight by about lr times a
    ratio of gradients, so where the gradients are firm (above 1e-2 of their leaf's
    largest |value|) the new weights agree within 2e-2 of lr, and every leaf moves.
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.data.segment import DeviceBatch as JDeviceBatch
from diamond_tpu.models import (Denoiser as JDenoiser, DenoiserConfig as JDenoiserConfig,
                                InnerModelConfig as JInnerConfig,
                                SigmaDistributionConfig as JSigmaConfig)
from diamond_tpu.models.agent import _decay_mask
from diamond_tpu.models.agent import configure_opt as j_configure_opt
from diamond_tpu.training import TrainState as JTrainState
from diamond_tpu.training import make_denoiser_train_step as j_make_step
from diamond_tpu_torch import config as tc
from diamond_tpu_torch.data.episode import obs_to_float
from diamond_tpu_torch.data.segment import DeviceBatch
from diamond_tpu_torch.interop.jax_vars import load_variables, variables_to_state_dict
from diamond_tpu_torch.models import (Denoiser, DenoiserDraws, DiffusionSampler, downsample_avg,
                                      quantize_to_uint8_grid)
from diamond_tpu_torch.models.agent import configure_opt, decay_mask
from diamond_tpu_torch.ops import quant
from diamond_tpu_torch.training import (TrainState, make_denoiser_eval_step,
                                        make_denoiser_train_step)

from torch_port_util import random_variables, t

IMG, C, NC, NA, B = 16, 3, 4, 3, 3
INNER = dict(img_channels=C, num_steps_conditioning=NC, cond_channels=16, depths=[1, 1],
             channels=[8, 8], attn_depths=[0, 1], num_actions=NA)
SIGMA = tc.SigmaDistributionConfig()
J_SIGMA = JSigmaConfig(**asdict(SIGMA))
LR = 1e-3


@pytest.fixture(scope="module")
def models():
    j = JDenoiser(JDenoiserConfig(inner_model=JInnerConfig(**INNER), sigma_data=0.5,
                                  sigma_offset_noise=0.3))
    v = random_variables(j.init, img_size=IMG, seed=31)
    p = Denoiser(tc.DenoiserConfig(inner_model=tc.InnerModelConfig(**INNER), sigma_data=0.5,
                                   sigma_offset_noise=0.3))
    load_variables(p.inner_model, v)
    return j, v, p


@pytest.fixture
def fresh(models):
    """The models with the port's starting weights restored (a step updates them)."""
    j, v, p = models
    load_variables(p.inner_model, v)
    return models


def _segments(seed, t_total, mask_rows=()):
    """uint8 segments (B, T, H, W, C), actions, and a padding mask with the (sample,
    frame) pairs of ``mask_rows`` padded."""
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (B, t_total, IMG, IMG, C), dtype=np.uint8)
    act = rng.integers(0, NA, (B, t_total)).astype(np.int32)
    mask = np.ones((B, t_total), bool)
    for bi, ti in mask_rows:
        mask[bi, ti] = False
    return obs, act, mask


def _device_batch(obs_u8, act, mask):
    """The port's DeviceBatch of the segments; the fields the denoiser does not read are
    zeros."""
    b, t_total = act.shape
    return DeviceBatch(obs=t(obs_u8), act=t(act), rew=torch.zeros((b, t_total)),
                       end=torch.zeros((b, t_total), dtype=torch.int32),
                       trunc=torch.zeros((b, t_total), dtype=torch.int32), mask_padding=t(mask),
                       final_obs=torch.zeros((b, IMG, IMG, C), dtype=torch.uint8),
                       has_final_obs=torch.zeros((b,), dtype=torch.bool))


def jax_draws(key, windows, b=B):
    """The port's DenoiserDraws for the JAX ``Denoiser.loss`` with ``key``: its splits,
    window by window (denoiser.py ``loss``, ``sample_sigma_training``, ``apply_noise``)."""
    sig, off, iid = [], [], []
    for _ in range(windows):
        key, k_sigma, k_noise = jax.random.split(key, 3)
        k_off, k_iid = jax.random.split(k_noise)
        sig.append(np.asarray(jax.random.normal(k_sigma, (b,))))
        off.append(np.asarray(jax.random.normal(k_off, (b, 1, 1, C))))
        iid.append(np.asarray(jax.random.normal(k_iid, (b, IMG, IMG, C))))
    return DenoiserDraws(*(t(np.stack(a)) for a in (sig, off, iid)))


def _grads_close(net, grads_j, share):
    ref = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads_j)})
    names = {n for n, _ in net.named_parameters()}
    assert names == set(ref)
    for n, p in net.named_parameters():
        assert p.grad is not None, f"{n} got no gradient"
        r = ref[n].numpy()
        err = np.abs(p.grad.numpy() - r).max()
        assert err <= share * max(1.0, np.abs(r).max()), (n, err, np.abs(r).max())


def _grid_levels(x):
    return np.round((np.asarray(x, np.float64) + 1) / 2 * 255)


@pytest.mark.parametrize("t_total,mask_rows", [
    (NC + 1, ()), (NC + 1, [(0, NC)]), (NC + 2, ()), (NC + 2, [(0, NC), (1, NC + 1), (2, NC),
                                                                 (2, NC + 1)])],
    ids=["1-window", "1-window-padded", "2-windows", "2-windows-padded"])
def test_loss_and_gradients_match_jax(fresh, t_total, mask_rows):
    j, v, p = fresh
    obs_u8, act, mask = _segments(40 + t_total, t_total, mask_rows)
    obs = np.asarray(obs_u8, np.float32) / 255.0 * 2.0 - 1.0
    key = jax.random.PRNGKey(7 + t_total)
    windows = t_total - NC

    def j_loss(params):
        return j.loss({"params": params, "constants": v["constants"]}, jnp.asarray(obs), act,
                      mask, key, J_SIGMA)

    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        v["params"])
    draws = jax_draws(key, windows)
    obs_p = obs_to_float(t(obs_u8))
    assert torch.equal(obs_p, t(obs))
    p.inner_model.zero_grad(set_to_none=True)
    loss, metrics = p.loss(obs_p, t(act), t(mask), SIGMA, draws=draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(metrics["loss_denoising"].item(),
                               float(metrics_j["loss_denoising"]), rtol=1e-5)
    assert not metrics["loss_denoising"].requires_grad
    _grads_close(p.inner_model, grads_j, 1e-4)
    assert p.inner_model.noise_emb.weight.grad is None  # the frequencies are constants

    if windows == 2:  # the frame fed back into the second window, in grid levels
        cs_sigma = p.sample_sigma_training(draws.sigma[0], SIGMA)
        noisy = p.apply_noise(obs_p[:, NC], cs_sigma, draws.offset[0], draws.noise[0])
        cond = obs_p[:, :NC].movedim(1, 3).reshape(B, IMG, IMG, NC * C)
        cs = p.compute_conditioners(cs_sigma)
        with torch.no_grad():
            fed = p.wrap_model_output(noisy, p.compute_model_output(
                noisy, cond, t(act[:, :NC]), cs), cs)
        jcs = j.compute_conditioners(jnp.asarray(cs_sigma.numpy()))
        jnoisy = jnp.asarray(noisy.numpy())
        jcond = np.moveaxis(obs[:, :NC], 1, 3).reshape(B, IMG, IMG, NC * C)
        fed_j = j.wrap_model_output(jnoisy, j.compute_model_output(v, jnoisy, jcond,
                                                                     act[:, :NC], jcs), jcs)
        d = np.abs(_grid_levels(fed.numpy()) - _grid_levels(fed_j))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _params_close(net, params_j, grads_list, share):
    """The port's parameters against the JAX step's, where every step's JAX gradient is
    firm (above 1e-2 of its leaf's largest |value|)."""
    new_j = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, params_j)})
    refs = [variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, g)})
            for g in grads_list]
    for n, q in net.named_parameters():
        firm = np.ones(q.shape, bool)
        for ref in refs:
            g = ref[n].numpy()
            firm &= np.abs(g) > 1e-2 * np.abs(g).max()
        d = np.abs(q.detach().numpy() - new_j[n].numpy())[firm]
        assert d.size == 0 or d.max() <= share * LR, (n, d.max())


@pytest.mark.parametrize("warmup,steps", [(0, 1), (3, 2)])
def test_train_steps_match_jax(fresh, warmup, steps):
    """``steps`` updates of make_denoiser_train_step against the JAX step from the same
    weights, batch and keys: the metrics and the parameters after each step (with warmup
    3 the first update has lr 0 and the second lr / 3). Decay 1e-2 as trainer.yaml's
    denoiser section, clipping at 0.5, where it clips."""
    j, v, p = fresh
    obs_u8, act, mask = _segments(50, NC + 2, [(1, NC + 1)])
    spec = tc.OptimizerConfig(lr=LR, weight_decay=1e-2)
    tx_j = j_configure_opt(spec.lr, spec.weight_decay, spec.eps, 0.5, warmup)
    step_j = j_make_step(j, tx_j, J_SIGMA)
    jb = JDeviceBatch(obs=jnp.asarray(obs_u8), act=jnp.asarray(act),
                      rew=jnp.zeros((B, NC + 2)), end=jnp.zeros((B, NC + 2), jnp.int32),
                      trunc=jnp.zeros((B, NC + 2), jnp.int32), mask_padding=jnp.asarray(mask),
                      final_obs=jnp.zeros((B, IMG, IMG, C), jnp.uint8),
                      has_final_obs=jnp.zeros((B,), bool))
    tx = configure_opt(spec.lr, spec.weight_decay, spec.eps, 0.5, warmup)
    state = TrainState.create(p.inner_model, tx)
    step = make_denoiser_train_step(p, tx, SIGMA)
    batch = _device_batch(obs_u8, act, mask)
    state_j = JTrainState.create(jax.tree_util.tree_map(jnp.array, v["params"]), tx_j)
    old = {n: q.detach().clone() for n, q in p.inner_model.named_parameters()}
    obs_j = jnp.asarray(obs_u8, jnp.float32) / 255.0 * 2.0 - 1.0
    j_grad = jax.jit(jax.grad(lambda params, key: j.loss(
        {"params": params, "constants": v["constants"]}, obs_j, act, mask, key, J_SIGMA)[0]))
    grads = []
    for i in range(steps):
        key = jax.random.PRNGKey(60 + i)
        grads.append(j_grad(state_j.params, key))
        state_j, m_j = step_j(state_j, v["constants"], jb, key)
        state, m = step(state, batch, draws=jax_draws(key, 2))
        assert state.step == i + 1
        for k in ("loss_denoising", "grad_norm_before_clip"):
            assert not m[k].requires_grad
            np.testing.assert_allclose(m[k].item(), float(m_j[k]), rtol=1e-4, err_msg=k)
        assert float(m_j["grad_norm_before_clip"]) > 0.5  # clipping is active
        _params_close(p.inner_model, state_j.params, grads, 2e-2)
    assert all(q.grad is None for q in p.inner_model.parameters())  # cleared by the update
    for n, q in p.inner_model.named_parameters():
        assert not torch.equal(q.detach(), old[n]), f"{n} did not move"


def test_eval_step_is_the_loss_without_a_graph(fresh):
    j, v, p = fresh
    obs_u8, act, mask = _segments(70, NC + 2)
    draws = jax_draws(jax.random.PRNGKey(3), 2)
    batch = _device_batch(obs_u8, act, mask)
    m = make_denoiser_eval_step(p, SIGMA)(batch, draws=draws)
    loss, _ = p.loss(obs_to_float(t(obs_u8)), t(act), t(mask), SIGMA, draws=draws)
    assert not m["loss_denoising"].requires_grad
    assert m["loss_denoising"].item() == loss.item()
    # the two-stage world model's step: the loss of the frames' grid-snapped area
    # downsample, made in the step (tests/test_torch_two_stage.py holds it against JAX)
    low = quantize_to_uint8_grid(downsample_avg(obs_to_float(t(obs_u8)), 2))
    draws_low = DenoiserDraws(draws.sigma, draws.offset[..., :C],
                              draws.noise[:, :, ::2, ::2].contiguous())
    m = make_denoiser_eval_step(p, SIGMA, downsample_factor=2)(batch, draws=draws_low)
    loss, _ = p.loss(low, t(act), t(mask), SIGMA, draws=draws_low)
    assert m["loss_denoising"].item() == loss.item()


def test_generator_draws_are_reproducible(fresh):
    _, _, p = fresh
    obs_u8, act, mask = _segments(71, NC + 2)
    obs = obs_to_float(t(obs_u8))
    losses = [p.loss(obs, t(act), t(mask), SIGMA, generator=torch.Generator().manual_seed(5))[0]
              for _ in range(2)]
    assert losses[0].item() == losses[1].item()


def test_decay_mask_of_the_denoiser_equals_jax(models):
    j, v, p = models
    mask = variables_to_state_dict({"params": jax.tree_util.tree_map(
        lambda m: np.float32(m), _decay_mask(v["params"]))})
    assert {n: bool(m.item()) for n, m in mask.items()} == \
        {n: decay_mask(n) for n, _ in p.inner_model.named_parameters()}


def test_int8_calibration_stays_out_of_training(fresh):
    """On a denoiser calibrated for the int8 rollout (every site kind) the training loss
    and every gradient equal those of the uncalibrated one: training never quantizes."""
    _, _, p = fresh
    obs_u8, act, mask = _segments(72, NC + 2)
    obs = obs_to_float(t(obs_u8))
    draws = jax_draws(jax.random.PRNGKey(9), 2)

    def loss_and_grads():
        p.inner_model.zero_grad(set_to_none=True)
        loss, _ = p.loss(obs, t(act), t(mask), SIGMA, draws=draws)
        loss.backward()
        return loss.detach(), {n: q.grad.clone() for n, q in p.inner_model.named_parameters()}

    ref = loss_and_grads()
    sampler = DiffusionSampler(p, tc.DiffusionSamplerConfig(num_steps_denoising=2))
    coll = sampler.calibrate(obs[:, :NC], t(act[:, :NC]), "all",
                             generator=torch.Generator().manual_seed(0))
    assert coll and quant.has_collection(p.inner_model)
    got = loss_and_grads()
    quant.strip(p.inner_model)
    assert torch.equal(got[0], ref[0])
    assert all(torch.equal(got[1][n], ref[1][n]) for n in ref[1])
