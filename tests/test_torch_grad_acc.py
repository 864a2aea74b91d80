"""Gradient accumulation of diamond_tpu_torch (``AdamWClip`` with ``grad_acc_steps`` k > 1,
through ``training.apply_update``) against the JAX trainer's ``build_tx``:
``optax.MultiSteps`` of the JAX ``configure_opt`` chain, with ``optax.scale(k)`` in front
under ``grad_acc_sum``, stepped by the JAX package's ``_apply_update``. On the CPU in
float32.

Tolerances, each with its reason:
  * parameters on identical gradients: within 1e-6 of their leaf's largest |value|,
    the reported norms within 1e-6 relative: the same f32 operations (optax's running
    mean, the clip, AdamW), up to the order of the norm's sums;
  * the accumulated rew/end step (tests/test_torch_rew_end_training.py's models and
    segments): its tolerances, 1e-5 for the metrics and 2e-2 of lr for the weights
    where the gradients are firm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diamond_tpu.models.agent import configure_opt as j_configure_opt
from diamond_tpu.training import TrainState as JTrainState
from diamond_tpu.training import _apply_update as j_apply_update
from diamond_tpu.training import make_rew_end_train_step as j_make_step
from diamond_tpu_torch import config as tc
from diamond_tpu_torch.interop.jax_vars import variables_to_state_dict
from diamond_tpu_torch.models.agent import configure_opt
from diamond_tpu_torch.training import (OptimizerSpec, TrainState, apply_update,
                                        make_rew_end_train_step)

from test_torch_rew_end_training import (LR, fresh, jax_batch, jax_loss, models,  # noqa: F401
                                         port_batch, segments)
from torch_port_util import t

SHAPES = {"conv.kernel": (3, 3, 4, 5), "conv.bias": (5,), "norm.scale": (4,),
          "lstm.weight_ih": (6, 8), "lstm.bias_ih": (8,), "embed.embedding": (7, 3)}


def j_build_tx(lr, wd, eps, clip, warmup, k, grad_acc_sum):
    """The JAX trainer's build_tx (diamond_tpu/trainer.py)."""
    tx = j_configure_opt(lr, wd, eps, clip, warmup)
    if k <= 1:
        return tx
    if grad_acc_sum:
        tx = optax.chain(optax.scale(float(k)), tx)
    return optax.MultiSteps(tx, every_k_schedule=k)


def _net(rng):
    net = torch.nn.Module()
    for name, shape in SHAPES.items():
        mod, leaf = name.split(".")
        if not hasattr(net, mod):
            net.add_module(mod, torch.nn.Module())
        getattr(net, mod).register_parameter(
            leaf, torch.nn.Parameter(t(rng.normal(size=shape).astype(np.float32))))
    return net


def _params(net):
    return {n: p.detach().numpy().copy() for n, p in net.named_parameters()}


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("grad_acc_sum", [False, True], ids=["mean", "sum"])
@pytest.mark.parametrize("warmup", [0, 2])
def test_accumulation_matches_optax_multisteps(k, grad_acc_sum, warmup):
    """3k micro-steps on identical random gradients, clipping at 0.5 (active on every
    micro-gradient and on the mean or sum): the weights equal optax's after every
    micro-step, stay untouched until each k-th, the AdamW moments too; the reported
    norm is each micro-step's own; the LR warmup counts the inner updates (with warmup 2
    the first update has lr 0, so the weights first move at micro-step 2k)."""
    lr, wd, eps, clip = 1e-2, 1e-2, 1e-8, 0.5
    rng = np.random.default_rng(20 + k)
    net = _net(rng)
    params_j = {m: {leaf: jnp.asarray(p.detach().numpy()) for leaf, p in sub.named_parameters()}
                for m, sub in net.named_children()}
    tx_j = j_build_tx(lr, wd, eps, clip, warmup, k, grad_acc_sum)
    state_j = JTrainState.create(params_j, tx_j)
    spec = OptimizerSpec(lr, wd, eps, clip, warmup, grad_acc_steps=k, grad_acc_sum=grad_acc_sum)
    tx = spec.build()
    state = TrainState.create(net, tx)
    start = _params(net)
    for i in range(3 * k):
        grads = {n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()}
        g_j = {m: {leaf: jnp.asarray(grads[f"{m}.{leaf}"]) for leaf in sub}
               for m, sub in params_j.items()}
        state_j, norm_j = j_apply_update(tx_j, state_j, g_j)
        before = _params(net)
        for n, p in net.named_parameters():
            p.grad = t(grads[n])
        state, norm = apply_update(tx, state)
        assert state.step == int(state_j.step) == i + 1
        np.testing.assert_allclose(norm.item(), float(norm_j), rtol=1e-6)
        assert float(norm_j) > clip * (k if grad_acc_sum else 1)  # the clip acts
        emit = (i + 1) % k == 0
        moves = emit and not (warmup and i + 1 == k)  # the first update's lr is 0
        for n, p in net.named_parameters():
            m, leaf = n.split(".")
            ref = np.asarray(state_j.params[m][leaf])
            err = np.abs(p.detach().numpy() - ref).max()
            assert err <= 1e-6 * np.abs(ref).max(), (n, i, err)
            assert p.grad is None
            assert np.array_equal(p.detach().numpy(), before[n]) != moves, (n, i)
    assert not all(np.array_equal(v, start[n]) for n, v in _params(net).items())


def tx_step_states(state):
    return [state.opt_state.state[p] for g in state.opt_state.param_groups for p in g["params"]]


def test_moments_untouched_between_updates():
    """After the first update the AdamW moments and step count stay as they are over the
    next k - 1 micro-steps."""
    k = 3
    rng = np.random.default_rng(5)
    net = _net(rng)
    tx = configure_opt(1e-2, 0.0, 1e-8, None, 0, grad_acc_steps=k)
    state = TrainState.create(net, tx)

    def micro():
        nonlocal state
        for n, p in net.named_parameters():
            p.grad = t(rng.normal(size=SHAPES[n]).astype(np.float32))
        state, _ = apply_update(tx, state)

    for _ in range(k):
        micro()
    snap = [{key: v.clone() for key, v in s.items()} for s in tx_step_states(state)]
    assert all(int(s["step"]) == 1 for s in snap)
    for _ in range(k - 1):
        micro()
        for s, old in zip(tx_step_states(state), snap):
            assert all(torch.equal(s[key], old[key]) for key in old)
    micro()
    assert all(int(s["step"]) == 2 for s in tx_step_states(state))


def test_optimizer_spec_reads_the_config():
    train = tc.TrainingConfig(grad_acc_steps=4)
    spec = OptimizerSpec.from_cfg(tc.OptimizerConfig(), train, tc.RuntimeConfig().grad_acc_sum)
    tx = spec.build()
    assert (tx.grad_acc_steps, tx.grad_acc_sum) == (4, False)
    assert OptimizerSpec.from_cfg(tc.OptimizerConfig(), train, True).build().grad_acc_sum
    with pytest.raises(ValueError, match="grad_acc_steps"):
        configure_opt(1e-3, 0.0, 1e-8, grad_acc_steps=0)


@pytest.mark.parametrize("grad_acc_sum", [False, True], ids=["mean", "sum"])
def test_accumulated_rew_end_step_matches_jax(fresh, grad_acc_sum):
    """Four micro-steps (k = 2) of make_rew_end_train_step on two batches in turn against
    the JAX step with the trainer's MultiSteps: the metrics of each micro-step, the
    weights untouched after micro-steps 1 and 3, and after 2 and 4 equal to JAX's where
    every update's mean gradient so far is firm (above 1e-2 of its leaf's largest
    |value|)."""
    j, v, p = fresh
    opt = tc.RewEndTrainerConfig().optimizer
    k, clip = 2, 0.2
    tx_j = j_build_tx(LR, opt.weight_decay, opt.eps, clip, 0, k, grad_acc_sum)
    step_j = j_make_step(j, tx_j)
    tx = OptimizerSpec(LR, opt.weight_decay, opt.eps, clip, 0, k, grad_acc_sum).build()
    state = TrainState.create(p.net, tx)
    step = make_rew_end_train_step(p, tx)
    state_j = JTrainState.create(jax.tree_util.tree_map(jnp.array, v["params"]), tx_j)
    data = [segments(60), segments(61, (False, True, True))]
    grads = []
    for i in range(4):
        a = data[i % 2]
        before = {n: q.detach().clone() for n, q in p.net.named_parameters()}
        grads.append(variables_to_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, jax.grad(lambda q: jax_loss(j, q, a)[0])(state_j.params))}))
        state_j, m_j = step_j(state_j, jax_batch(a))
        state, m = step(state, port_batch(a))
        assert state.step == int(state_j.step) == i + 1
        for key in ("loss_total", "grad_norm_before_clip"):
            np.testing.assert_allclose(m[key].item(), float(m_j[key]), rtol=1e-4, err_msg=key)
        np.testing.assert_array_equal(m["confusion_matrix"]["rew"].numpy(),
                                      np.asarray(m_j["confusion_matrix"]["rew"]))
        same = [torch.equal(q.detach(), before[n]) for n, q in p.net.named_parameters()]
        if i % 2 == 0:
            assert all(same)
            continue
        assert not any(same)
        new_j = variables_to_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, state_j.params)})
        for n, q in p.net.named_parameters():
            firm = np.ones(q.shape, bool)
            for u in range(0, len(grads), k):  # each update's mean gradient
                g = sum(grads[u + r][n].numpy() for r in range(k)) / k
                firm &= np.abs(g) > 1e-2 * np.abs(g).max()
            d = np.abs(q.detach().numpy() - new_j[n].numpy())[firm]
            assert d.size == 0 or d.max() <= 2e-2 * LR, (n, d.max())
