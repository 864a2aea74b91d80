"""The model-free actor-critic step of diamond_tpu_torch (``training.py``
``make_model_free_ac_train_step``) against the JAX package's
``make_model_free_ac_train_step``, on the CPU in float32 at the tiny size of
tests/test_torch_rollout.py (channels [16, 32], LSTM 32, 16x16 frames), on seeded
recorded tensors (B = 3, T = 5) with resets inside the sequence and at its start. The
JAX step's own gradients are read from a transform that keeps them
(``capture_grads``).

Tolerances, as the actor-critic step's (tests/test_torch_training.py) on the same
frames and carries:
  * the loss and its metrics: 1e-5 relative (f32 convs, norms and the LSTM summed in
    other orders);
  * every parameter's gradient within 1e-4 of the JAX leaf's largest |value|;
  * the parameters after a step: where the gradient is firm (above 1e-2 of its leaf's
    largest |value|), within 2e-2 of lr; every leaf moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diamond_tpu.models import ActorCritic as JActorCritic, ActorCriticConfig as JACConfig
from diamond_tpu.models.actor_critic import ActorCriticLossConfig as JLossConfig
from diamond_tpu.models.agent import configure_opt as j_configure_opt
from diamond_tpu.training import TrainState as JTrainState
from diamond_tpu.training import make_model_free_ac_train_step as j_make_step
from diamond_tpu_torch import config as tc
from diamond_tpu_torch.interop.jax_vars import load_variables, variables_to_state_dict
from diamond_tpu_torch.models import ActorCritic
from diamond_tpu_torch.models.agent import configure_opt
from diamond_tpu_torch.training import (TrainState, make_model_free_ac_train_step,
                                        model_free_ac_loss)

from torch_port_util import random_variables, t

IMG, C, NA, B, T, D = 16, 3, 3, 3, 5, 32
AC = dict(lstm_dim=D, img_channels=C, img_size=IMG, channels=[16, 32], down=[1, 1],
          num_actions=NA)
LOSS = tc.ActorCriticLossConfig(backup_every=T)
J_LOSS = JLossConfig(backup_every=T, gamma=LOSS.gamma, lambda_=LOSS.lambda_,
                     weight_value_loss=LOSS.weight_value_loss,
                     weight_entropy_loss=LOSS.weight_entropy_loss)
LR = 1e-3


@pytest.fixture(scope="module")
def models():
    j = JActorCritic(JACConfig(**AC))
    v = random_variables(j.init, seed=41)
    p = ActorCritic(tc.ActorCriticConfig(**AC))
    load_variables(p.net, v)
    return j, v, p


@pytest.fixture
def fresh(models):
    j, v, p = models
    load_variables(p.net, v)
    return models


def recorded(seed):
    """obs_u8, act, rew, end, trunc, reset_mask, hx0, cx0, val_bootstrap as the env loop
    records them: an end and a truncation, the reset gate after each, and a reset at the
    first step of one env."""
    rng = np.random.default_rng(seed)
    end = np.zeros((B, T), np.float32)
    trunc = np.zeros((B, T), np.float32)
    end[0, 1], trunc[1, 2], end[2, 3] = 1, 1, 1
    reset = np.zeros((B, T), np.float32)
    reset[:, 1:] = (end + trunc)[:, :-1]
    reset[2, 0] = 1
    return (rng.integers(0, 256, (B, T, IMG, IMG, C), dtype=np.uint8),
            rng.integers(0, NA, (B, T)).astype(np.int32),
            rng.choice([-1.0, 0.0, 1.0, 2.0], (B, T)).astype(np.float32), end, trunc, reset,
            (0.5 * rng.normal(size=(B, D))).astype(np.float32),
            (0.5 * rng.normal(size=(B, D))).astype(np.float32),
            rng.normal(size=(B, T)).astype(np.float32))


def capture_grads():
    """A transform that moves nothing and keeps the gradients it was given."""

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, updates), updates

    return optax.GradientTransformation(init, update)


def jax_step(j, params, tx, rec):
    state = JTrainState.create(jax.tree_util.tree_map(jnp.array, params), tx)
    return j_make_step(j, tx, J_LOSS)(state, *(jnp.asarray(x) for x in rec))


def test_loss_metrics_and_gradients_match_jax(fresh):
    j, v, p = fresh
    rec = recorded(0)
    state_j, m_j = jax_step(j, v["params"], capture_grads(), rec)
    p.net.zero_grad(set_to_none=True)
    loss, m = model_free_ac_loss(p, LOSS, *(t(x) for x in rec))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(m_j["loss_total"]), rtol=1e-5)
    for k, val in m.items():
        assert not val.requires_grad
        np.testing.assert_allclose(val.item(), float(m_j[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    ref = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                                     state_j.opt_state)})
    assert {n for n, _ in p.net.named_parameters()} == set(ref)
    for n, q in p.net.named_parameters():
        assert q.grad is not None, f"{n} got no gradient"
        r = ref[n].numpy()
        err = np.abs(q.grad.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (n, err, np.abs(r).max())


def test_resets_gate_the_carry(fresh):
    """The reset gate matters: without it (all zeros) the loss differs, with a reset at
    every step the carry never reaches the heads (the loss equals that of zero carries)."""
    _, _, p = fresh
    rec = [t(x) for x in recorded(1)]
    with torch.no_grad():
        loss = model_free_ac_loss(p, LOSS, *rec)[0].item()
        ungated = model_free_ac_loss(p, LOSS, *rec[:5], torch.zeros((B, T)), *rec[6:])[0].item()
        all_reset = model_free_ac_loss(p, LOSS, *rec[:5], torch.ones((B, T)), *rec[6:])[0]
        zero_carry = model_free_ac_loss(p, LOSS, *rec[:5], torch.ones((B, T)),
                                        torch.zeros((B, D)), torch.zeros((B, D)), rec[8])[0]
    assert abs(loss - ungated) > 1e-6 * abs(loss)
    assert all_reset.item() == zero_carry.item()


def test_train_step_matches_jax(fresh):
    """One update of make_model_free_ac_train_step against the JAX step from the same
    weights and recorded tensors: the metrics, the norm before clipping, the parameters
    (the trainer config's AC optimizer with warmup 0 and lr 1e-3, clipping at 0.5, where
    it clips)."""
    j, v, p = fresh
    rec = recorded(2)
    opt = tc.ActorCriticTrainerConfig().optimizer
    tx_j = j_configure_opt(LR, opt.weight_decay, opt.eps, 0.5, 0)
    grads_state, _ = jax_step(j, v["params"], capture_grads(), rec)
    grads = variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, grads_state.opt_state)})
    state_j, m_j = jax_step(j, v["params"], tx_j, rec)
    tx = configure_opt(LR, opt.weight_decay, opt.eps, 0.5, 0)
    state = TrainState.create(p.net, tx)
    old = {n: q.detach().clone() for n, q in p.net.named_parameters()}
    state, m = make_model_free_ac_train_step(p, tx, LOSS)(state, *(t(x) for x in rec))
    assert state.step == int(state_j.step) == 1
    for k in ("loss_total", "grad_norm_before_clip"):
        np.testing.assert_allclose(m[k].item(), float(m_j[k]), rtol=1e-4, err_msg=k)
    assert float(m_j["grad_norm_before_clip"]) > 0.5
    new_j = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                                       state_j.params)})
    for n, q in p.net.named_parameters():
        g = grads[n].numpy()
        firm = np.abs(g) > 1e-2 * np.abs(g).max()
        d = np.abs(q.detach().numpy() - new_j[n].numpy())[firm]
        assert d.size == 0 or d.max() <= 2e-2 * LR, (n, d.max())
        assert not torch.equal(q.detach(), old[n]), f"{n} did not move"
        assert q.grad is None
    with pytest.raises(ValueError, match="actor-critic"):
        make_model_free_ac_train_step(p, tx, LOSS)(TrainState.create(torch.nn.Linear(1, 1), tx),
                                                   *(t(x) for x in rec))
