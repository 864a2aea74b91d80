"""The rew/end train and eval steps of diamond_tpu_torch against the JAX package, on the
CPU in float32 at a tiny size (channels [8, 8], depths [1, 1], attention at the second
level and in the final blocks, cond 16, LSTM 32, 16x16 frames, B = 3 segments of T = 5
frames), with the same weights through the weight bridge. The segments hold a death
with its final frame known (the swap happens), a death without it (no swap), a segment
that ends twice (the swap takes the first end), padding after a death and padding
before a start.

Tolerances, each with its reason:
  * the loss and its metrics: 1e-5 relative (f32 convs, norms, LSTM and matmuls summed
    in other orders);
  * the confusion matrices: equal (sums of 0/1 weights of the same argmax);
  * every parameter's gradient within 1e-4 of the JAX leaf's largest |value| (f32 sums
    through the encoder and the LSTM in other orders), and no parameter without one;
  * the parameters after Adam steps: where every step's gradient is firm (above 1e-2 of
    its leaf's largest |value|), within 2e-2 of lr (Adam moves a weight by about lr
    times a ratio of gradients), and every leaf moves.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.data.segment import DeviceBatch as JDeviceBatch
from diamond_tpu.models import RewEndModel as JRewEnd, RewEndModelConfig as JRewEndConfig
from diamond_tpu.models.agent import _decay_mask
from diamond_tpu.models.agent import configure_opt as j_configure_opt
from diamond_tpu.training import TrainState as JTrainState
from diamond_tpu.training import make_rew_end_eval_step as j_make_eval
from diamond_tpu.training import make_rew_end_train_step as j_make_step
from diamond_tpu_torch import config as tc
from diamond_tpu_torch.data.segment import DeviceBatch
from diamond_tpu_torch.interop.jax_vars import load_variables, variables_to_state_dict
from diamond_tpu_torch.models import RewEndModel
from diamond_tpu_torch.models.agent import configure_opt, decay_mask
from diamond_tpu_torch.training import (TrainState, make_rew_end_eval_step,
                                        make_rew_end_train_step)

from torch_port_util import REPO, random_variables, t

IMG, C, NA, B, T = 16, 3, 3, 3, 5
REW = dict(lstm_dim=32, img_channels=C, img_size=IMG, cond_channels=16, depths=[1, 1],
           channels=[8, 8], attn_depths=[0, 1], num_actions=NA)
LR = 1e-3
CLIP = 0.2


@pytest.fixture(scope="module")
def models():
    j = JRewEnd(JRewEndConfig(**REW))
    v = random_variables(j.init, seed=21)
    p = RewEndModel(tc.RewEndModelConfig(**REW))
    load_variables(p.net, v)
    return j, v, p


@pytest.fixture
def fresh(models):
    """The models with the port's starting weights restored (a step updates them)."""
    j, v, p = models
    load_variables(p.net, v)
    return models


def segments(seed, has_final=(True, False, True)):
    """A batch of three uint8 segments as numpy arrays: segment 0 dies at step 2 and is
    padded after it, segment 1 dies at step 1 and is padded after it, segment 2 ends at
    steps 1 and 3 and is padded before its start; ``has_final``: whose final frame is
    known. Rewards of both signs and other magnitudes than 1."""
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (B, T, IMG, IMG, C), dtype=np.uint8)
    act = rng.integers(0, NA, (B, T)).astype(np.int32)
    rew = rng.choice([-2.0, -1.0, 0.0, 0.5, 1.0], (B, T)).astype(np.float32)
    end = np.zeros((B, T), np.int32)
    mask = np.ones((B, T), bool)
    end[0, 2], mask[0, 3:] = 1, False
    end[1, 1], mask[1, 2:] = 1, False
    end[2, 1], end[2, 3], mask[2, 0] = 1, 1, False
    obs[~mask] = 0
    rew[~mask] = 0
    act[~mask] = 0
    final = rng.integers(0, 256, (B, IMG, IMG, C), dtype=np.uint8)
    hf = np.asarray(has_final, bool)
    final[~hf] = 0
    return dict(obs=obs, act=act, rew=rew, end=end, trunc=np.zeros((B, T), np.int32),
                mask_padding=mask, final_obs=final, has_final_obs=hf)


def port_batch(a):
    return DeviceBatch(**{k: t(v) for k, v in a.items()})


def jax_batch(a):
    return JDeviceBatch(**{k: jnp.asarray(v) for k, v in a.items()})


def _to_float(x):
    return np.asarray(x, np.float32) / 255.0 * 2.0 - 1.0


def jax_loss(j, params, a):
    return j.loss({"params": params}, jnp.asarray(_to_float(a["obs"])), a["act"], a["rew"],
                  a["end"], a["mask_padding"], jnp.asarray(_to_float(a["final_obs"])),
                  a["has_final_obs"])


def port_loss(p, a):
    b = port_batch(a)
    return p.loss(b.obs.float() / 255.0 * 2.0 - 1.0, b.act, b.rew, b.end, b.mask_padding,
                  b.final_obs.float() / 255.0 * 2.0 - 1.0, b.has_final_obs)


def assert_metrics_equal(m, m_j):
    for k in ("loss_rew", "loss_end", "loss_total"):
        assert not m[k].requires_grad
        np.testing.assert_allclose(m[k].item(), float(m_j[k]), rtol=1e-5, err_msg=k)
    for k in ("rew", "end"):
        np.testing.assert_array_equal(m["confusion_matrix"][k].numpy(),
                                      np.asarray(m_j["confusion_matrix"][k]), err_msg=k)


@pytest.mark.parametrize("has_final", [(True, False, True), (False, False, False),
                                       (True, True, True)],
                         ids=["swap-one", "swap-none", "swap-all"])
def test_loss_metrics_and_gradients_match_jax(fresh, has_final):
    j, v, p = fresh
    a = segments(30, has_final)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda params: jax_loss(j, params, a), has_aux=True))(v["params"])
    p.net.zero_grad(set_to_none=True)
    loss, metrics = port_loss(p, a)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert_metrics_equal(metrics, metrics_j)
    assert metrics["confusion_matrix"]["end"].sum().item() == a["mask_padding"][:, :-1].sum()
    ref = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads_j)})
    assert {n for n, _ in p.net.named_parameters()} == set(ref)
    for n, q in p.net.named_parameters():
        assert q.grad is not None, f"{n} got no gradient"
        r = ref[n].numpy()
        err = np.abs(q.grad.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (n, err, np.abs(r).max())


def test_final_obs_swap_changes_the_loss(fresh):
    """The swap is there: with the final frame known the loss differs from the one
    without it, and each equals JAX's (a port that dropped the swap fails the first
    comparison)."""
    j, v, p = fresh
    with_swap, without = segments(31, (True, True, True)), segments(31, (False,) * 3)
    with torch.no_grad():
        l_with, l_without = port_loss(p, with_swap)[0].item(), port_loss(p, without)[0].item()
    np.testing.assert_allclose(l_with, float(jax_loss(j, v["params"], with_swap)[0]),
                               rtol=1e-5)
    np.testing.assert_allclose(l_without, float(jax_loss(j, v["params"], without)[0]),
                               rtol=1e-5)
    assert abs(l_with - l_without) > 1e-3 * abs(l_without)


def test_final_obs_swap_lands_on_the_first_end(fresh):
    """The frames the network sees as next_obs: the one at the first end of each dead
    segment with a known final frame is that final frame, and no other frame changes
    (segment 2 ends twice; segment 1 has no final frame)."""
    _, _, p = fresh
    a = segments(32, (True, False, True))
    obs_f = torch.from_numpy(_to_float(a["obs"]))
    final = torch.from_numpy(_to_float(a["final_obs"]))
    seen = {}
    orig = p.net.forward

    def spy(obs, act, next_obs, carry):
        seen["next_obs"] = next_obs
        return orig(obs, act, next_obs, carry)

    p.net.forward = spy
    try:
        with torch.no_grad():
            p.loss(obs_f, t(a["act"]), t(a["rew"]), t(a["end"]), t(a["mask_padding"]),
                   final, t(a["has_final_obs"]))
    finally:
        del p.net.forward
    nxt, base = seen["next_obs"], obs_f[:, 1:]
    swapped = {(b, s) for b in range(B) for s in range(T - 1)
               if not torch.equal(nxt[b, s], base[b, s])}
    assert swapped == {(0, 2), (2, 1)}
    assert torch.equal(nxt[0, 2], final[0]) and torch.equal(nxt[2, 1], final[2])


@pytest.mark.parametrize("warmup,steps", [(0, 1), (3, 2)])
def test_train_steps_match_jax(fresh, warmup, steps):
    """``steps`` updates of make_rew_end_train_step against the JAX step from the same
    weights and batch: the metrics (with the confusion matrices) and the parameters
    after each step. trainer.yaml's rew/end optimizer (decay 1e-2), clipping at CLIP
    (it clips)."""
    j, v, p = fresh
    a = segments(40)
    opt = tc.RewEndTrainerConfig().optimizer
    tx_j = j_configure_opt(LR, opt.weight_decay, opt.eps, CLIP, warmup)
    step_j = j_make_step(j, tx_j)
    tx = configure_opt(LR, opt.weight_decay, opt.eps, CLIP, warmup)
    state = TrainState.create(p.net, tx)
    step = make_rew_end_train_step(p, tx)
    state_j = JTrainState.create(jax.tree_util.tree_map(jnp.array, v["params"]), tx_j)
    j_grad = jax.jit(jax.grad(lambda params: jax_loss(j, params, a)[0]))
    old = {n: q.detach().clone() for n, q in p.net.named_parameters()}
    grads = []
    for i in range(steps):
        grads.append(variables_to_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, j_grad(state_j.params))}))
        state_j, m_j = step_j(state_j, jax_batch(a))
        state, m = step(state, port_batch(a))
        assert state.step == i + 1
        assert_metrics_equal(m, m_j)
        np.testing.assert_allclose(m["grad_norm_before_clip"].item(),
                                   float(m_j["grad_norm_before_clip"]), rtol=1e-4)
        assert float(m_j["grad_norm_before_clip"]) > CLIP  # clipping is active
        new_j = variables_to_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, state_j.params)})
        for n, q in p.net.named_parameters():
            firm = np.ones(q.shape, bool)
            for g in grads:
                firm &= np.abs(g[n].numpy()) > 1e-2 * np.abs(g[n].numpy()).max()
            d = np.abs(q.detach().numpy() - new_j[n].numpy())[firm]
            assert d.size == 0 or d.max() <= 2e-2 * LR, (n, d.max())
    assert all(q.grad is None for q in p.net.parameters())  # cleared by the update
    if warmup == 0:
        for n, q in p.net.named_parameters():
            assert not torch.equal(q.detach(), old[n]), f"{n} did not move"


def test_eval_step_matches_jax_and_the_loss(fresh):
    j, v, p = fresh
    a = segments(50)
    m = make_rew_end_eval_step(p)(port_batch(a))
    m_j = j_make_eval(j)({"params": v["params"]}, jax_batch(a))
    assert_metrics_equal(m, m_j)
    loss, _ = port_loss(p, a)
    assert m["loss_total"].item() == loss.item()
    assert all(q.grad is None for q in p.net.parameters())


def test_decay_mask_of_the_rew_end_model_equals_jax(models):
    _, v, p = models
    mask = variables_to_state_dict({"params": jax.tree_util.tree_map(
        lambda m: np.float32(m), _decay_mask(v["params"]))})
    assert {n: bool(m.item()) for n, m in mask.items()} == \
        {n: decay_mask(n) for n, _ in p.net.named_parameters()}


def test_initial_carry_follows_the_parameters(models):
    _, _, p = models
    hx, cx = p.initial_carry(2)
    assert hx.device == p.net.head_2.kernel.device and hx.shape == (2, REW["lstm_dim"])
    assert not hx.any() and not cx.any()


def test_new_modules_import_no_jax():
    modules = ["diamond_tpu_torch.utils", "diamond_tpu_torch.data.dataset",
               "diamond_tpu_torch.data.batch_sampler", "diamond_tpu_torch.data.device_store",
               "diamond_tpu_torch.data.traverser", "diamond_tpu_torch.training",
               "diamond_tpu_torch.models.rew_end_model"]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'diamond_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
