"""The training slice of diamond_tpu_torch against the JAX package, on the CPU in float32:
the training config, the lambda-returns and the REINFORCE loss, the gradient of the
policy's trunk and heads, the optimizer against optax, and the whole actor-critic train
step against the JAX ``make_ac_train_step`` at a tiny size (the engines of
test_torch_rollout.py, B = 4, T = 4, draws rebuilt from the JAX key splits).

Tolerances, each with its reason:
  * lambda-returns, loss, metrics and their gradients on the same (B, T) arrays: 1e-6
    (the same f32 operations in the same order, up to the exp/log implementations);
  * policy gradients on the same frames and carries: 1e-4 of each leaf's largest |value|
    (f32 sums through convs, norms and the LSTM in other orders);
  * the optimizer on identical gradients: updates within 1e-6;
  * the whole step: actions, rewards, ends and deaths equal; loss and metrics within
    1e-3 and gradients within 2e-3 of each leaf's largest |value| (frames may differ by
    one uint8 grid level in at most 1 % of the pixels, as in test_rollout_matches_jax,
    and such a frame reaches the next step's policy features).
"""

import os
import subprocess
import sys
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diamond_tpu.config import load_config
from diamond_tpu.envs import world_model_env as jwm
from diamond_tpu.models import ActorCritic as JActorCritic, ActorCriticConfig as JACConfig
from diamond_tpu.models.actor_critic import (ActorCriticLossConfig as JLossConfig,
                                             compute_lambda_returns as j_lambda_returns)
from diamond_tpu.models.agent import _decay_mask
from diamond_tpu.models.agent import configure_opt as j_configure_opt
from diamond_tpu.training import TrainState as JTrainState
from diamond_tpu.training import make_ac_train_step as j_make_ac_train_step
from diamond_tpu_torch import config as tc
from diamond_tpu_torch.envs.world_model_env import ICPool, encode_pool_feats
from diamond_tpu_torch.interop.jax_vars import load_variables, variables_to_state_dict
from diamond_tpu_torch.models import ActorCritic
from diamond_tpu_torch.models.actor_critic import compute_lambda_returns
from diamond_tpu_torch.models.agent import configure_opt, decay_mask
from diamond_tpu_torch.training import OptimizerSpec, TrainState, make_ac_train_step

from test_torch_rollout import AC, B, IMG, NA, T, engines, jax_draws  # noqa: F401 (fixture)
from torch_port_util import random_variables, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAMMA = 0.985


def test_training_config_equals_trainer_yaml():
    cfg = load_config("trainer")
    port = tc.TrainerConfig()
    for name in ("denoiser", "rew_end_model", "actor_critic"):
        sub = getattr(port, name)
        training = {k: v for k, v in asdict(sub.training).items() if v is not None}
        assert training == dict(cfg[name].training), name
        assert asdict(sub.optimizer) == dict(cfg[name].optimizer), name
    assert asdict(port.actor_critic.actor_critic_loss) == \
        dict(cfg.actor_critic.actor_critic_loss)
    assert asdict(port.denoiser.sigma_distribution) == dict(cfg.denoiser.sigma_distribution)
    spec = OptimizerSpec.from_cfg(port.actor_critic.optimizer, port.actor_critic.training)
    assert (spec.lr, spec.weight_decay, spec.eps, spec.max_grad_norm, spec.lr_warmup_steps) == \
        (1e-4, 0.0, 1e-8, 100.0, 100)


def _rollout_arrays(seed, b=4, t=15, na=NA):
    """Rewards of both signs and magnitudes other than 1, ends and truncations (never
    both), values, bootstrap values, logits and actions."""
    rng = np.random.default_rng(seed)
    end = (rng.random((b, t)) < 0.15).astype(np.float32)
    trunc = ((rng.random((b, t)) < 0.15) * (1 - end)).astype(np.float32)
    return dict(act=rng.integers(0, na, (b, t)).astype(np.int32),
                rew=(rng.normal(size=(b, t)) * 2).astype(np.float32), end=end, trunc=trunc,
                logits=rng.normal(size=(b, t, na)).astype(np.float32),
                val=rng.normal(size=(b, t)).astype(np.float32),
                vboot=rng.normal(size=(b, t)).astype(np.float32))


@pytest.mark.parametrize("lambda_", [0.95, 0.0, 1.0])
def test_lambda_returns_match_jax(lambda_):
    a = _rollout_arrays(0)
    assert a["end"].any() and a["trunc"].any()
    ours = compute_lambda_returns(t(a["rew"]), t(a["end"]), t(a["trunc"]), t(a["vboot"]),
                                  GAMMA, lambda_)
    ref = j_lambda_returns(a["rew"], a["end"], a["trunc"], a["vboot"], GAMMA, lambda_)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lambda_", [0.95, 0.0])
def test_loss_from_rollout_matches_jax(lambda_):
    """Loss, metrics, and the gradient with respect to the logits and values."""
    a = _rollout_arrays(1)
    loss_cfg = tc.ActorCriticLossConfig(gamma=GAMMA, lambda_=lambda_)
    j_cfg = JLossConfig(**asdict(loss_cfg))
    jac = JActorCritic(JACConfig(**AC))
    pac = ActorCritic(tc.ActorCriticConfig(**AC))

    def j_loss(logits, val):
        return jac.loss_from_rollout(a["act"], a["rew"], a["end"], a["trunc"], logits, val,
                                     a["vboot"], j_cfg)

    (loss_j, metrics_j), grads_j = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        a["logits"], a["val"])
    logits, val = t(a["logits"]).requires_grad_(), t(a["val"]).requires_grad_()
    loss_p, metrics_p = pac.loss_from_rollout(t(a["act"]), t(a["rew"]), t(a["end"]),
                                              t(a["trunc"]), logits, val, t(a["vboot"]),
                                              loss_cfg)
    loss_p.backward()
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-6, atol=1e-6)
    assert set(metrics_p) == set(metrics_j)
    for k in metrics_j:
        np.testing.assert_allclose(metrics_p[k].item(), float(metrics_j[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(grads_j[0]), atol=1e-6)
    np.testing.assert_allclose(val.grad.numpy(), np.asarray(grads_j[1]), atol=1e-6)


def _leafwise_close(port_grads, jax_grads, share):
    """Each leaf of the port's gradient within ``share`` of the JAX leaf's largest |value|."""
    ref = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jax_grads)})
    assert set(port_grads) == set(ref)
    for name, g in port_grads.items():
        r = ref[name].numpy()
        scale = max(np.abs(r).max(), 1e-12)
        err = np.abs(g.numpy() - r).max()
        assert err <= share * scale, (name, err, scale)


@pytest.mark.parametrize("ties", [False, True])
def test_policy_gradient_matches_jax(ties):
    """The gradient of a probe loss of ``predict_act_value`` (trunk, LSTM, heads) with
    respect to every parameter, from the same frames and carries. ``ties``: every 2x2
    pool window of both levels holds four equal maxima whose neighbourhoods differ: the
    frames are constant over 4x4 blocks, ``conv_in`` keeps only its centre tap and the
    residual blocks' 3x3 kernels are zero, so each pool input is a function of its own
    pixel alone. flax routes a window's gradient to its first maximum, and so must the
    port; ``amax`` would split it, which moves the gradients of the taps that see the
    neighbourhoods."""
    jac = JActorCritic(JACConfig(**AC))
    pac = ActorCritic(tc.ActorCriticConfig(**AC))
    v = random_variables(jac.init, seed=11)
    rng = np.random.default_rng(12)
    b, d = 3, AC["lstm_dim"]
    if ties:
        enc = v["params"]["encoder"]
        centre = enc["conv_in"]["kernel"][1, 1].copy()
        enc["conv_in"]["kernel"][:] = 0
        enc["conv_in"]["kernel"][1, 1] = centre
        for i in range(len(AC["channels"])):
            enc[f"blocks_{i}"]["conv"]["kernel"][:] = 0
        obs = rng.uniform(-1, 1, (b, IMG // 4, IMG // 4, 3)).astype(np.float32)
        obs = obs.repeat(4, axis=1).repeat(4, axis=2)
    else:
        obs = rng.uniform(-1, 1, (b, IMG, IMG, 3)).astype(np.float32)
    load_variables(pac.net, v)
    hx, cx = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    u_l, u_v, u_h = (rng.normal(size=s).astype(np.float32) for s in ((b, NA), (b,), (b, d)))

    def probe(out, xp):
        return (out.logits_act * xp(u_l)).sum() + (out.val * xp(u_v)).sum() + \
            (out.carry[0] * xp(u_h)).sum()

    grads_j = jax.grad(lambda p: probe(jac.predict_act_value({"params": p}, obs, (hx, cx)),
                                       jnp.asarray))(v["params"])
    out = pac.head(pac.encode(t(obs)), (t(hx), t(cx)))
    probe(out, t).backward()
    _leafwise_close({n: p.grad for n, p in pac.net.named_parameters()}, grads_j, 1e-4)


def test_optimizer_matches_optax():
    """configure_opt against the JAX package's optax chain on identical gradients over
    four updates: linear warmup from 0 (the first update has lr 0), global-norm clipping
    active, weight decay 1e-2 on the masked leaves. Every parameter within 1e-6, and the
    reported norm before clipping too."""
    lr, wd, eps, max_norm, warmup = 1e-2, 1e-2, 1e-8, 0.5, 2
    rng = np.random.default_rng(13)
    net = torch.nn.Module()
    shapes = {"conv.kernel": (3, 3, 4, 5), "conv.bias": (5,), "norm.scale": (4,),
              "lstm.weight_ih": (6, 8), "lstm.bias_ih": (8,), "embed.embedding": (7, 3)}
    for name, shape in shapes.items():
        mod, leaf = name.split(".")
        if not hasattr(net, mod):
            net.add_module(mod, torch.nn.Module())
        getattr(net, mod).register_parameter(
            leaf, torch.nn.Parameter(t(rng.normal(size=shape).astype(np.float32))))
    params_j = jax.tree_util.tree_map(
        jnp.asarray, {m: {leaf: p.detach().numpy().copy() for leaf, p in sub.named_parameters()}
                      for m, sub in net.named_children()})
    assert {f"{m}.{leaf}": bool(v) for m, sub in _decay_mask(params_j).items()
            for leaf, v in sub.items()} == {n: decay_mask(n) for n in shapes}
    tx_j = j_configure_opt(lr, wd, eps, max_norm, warmup)
    opt_state = tx_j.init(params_j)
    tx = configure_opt(lr, wd, eps, max_norm, warmup)
    opt = tx.init(net)
    for step in range(4):
        grads = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
        g_j = {m: {leaf: jnp.asarray(grads[f"{m}.{leaf}"]) for leaf in sub}
               for m, sub in params_j.items()}
        norm_j = optax.global_norm(g_j)
        assert float(norm_j) > max_norm  # clipping is active
        updates, opt_state = tx_j.update(g_j, opt_state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for n, p in net.named_parameters():
            p.grad = t(grads[n])
        norm = tx.update(opt, step)
        np.testing.assert_allclose(norm.item(), float(norm_j), rtol=1e-6)
        for n, p in net.named_parameters():
            m, leaf = n.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params_j[m][leaf]),
                                       rtol=0, atol=1e-6, err_msg=f"{n} step {step}")
            assert p.grad is None
    assert tx.lr_at(0) == 0.0 and tx.lr_at(1) == lr / 2 and tx.lr_at(5) == lr


def test_decay_mask_of_the_actor_critic_equals_jax():
    jac = JActorCritic(JACConfig(**AC))
    pac = ActorCritic(tc.ActorCriticConfig(**AC))
    v = random_variables(jac.init, seed=14)
    mask = variables_to_state_dict({"params": jax.tree_util.tree_map(
        lambda m: np.float32(m), _decay_mask(v["params"]))})
    assert {n: bool(m.item()) for n, m in mask.items()} == \
        {n: decay_mask(n) for n, _ in pac.net.named_parameters()}


# ---------------------------------------------------------------------------
# The whole actor-critic step, against the JAX make_ac_train_step


LR = 1e-3


def _pools(e, pool_feats):
    ac_vars = e["vars"][0]
    j_pool = jwm.ICPool(obs=jnp.asarray(e["obs"]), act=jnp.asarray(e["act"]), hx=e["hx_j"],
                        cx=e["cx_j"], ptr=jnp.asarray(0, jnp.int32))
    p_pool = ICPool(obs=t(e["obs"]), act=t(e["act"]), hx=e["hx_p"], cx=e["cx_p"],
                    ptr=torch.tensor(0))
    if pool_feats:
        j_pool = j_pool.replace(feats=jwm.encode_pool_feats(e["j"].actor_critic, ac_vars,
                                                            j_pool.obs))
        p_pool.feats = encode_pool_feats(e["p"].actor_critic, p_pool.obs)
    st_j, j_pool = e["j"].initial_state(j_pool, B)
    st_p, p_pool = e["p"].initial_state(p_pool, B)
    return st_j, j_pool, st_p, p_pool


@pytest.fixture
def fresh_engines(engines):
    """The rollout engines with the actor-critic's starting weights restored (a step
    updates the port's module in place)."""
    load_variables(engines["p"].actor_critic.net, engines["vars"][0])
    return engines


@pytest.mark.parametrize("pool_feats", [False, True])
def test_ac_train_step_matches_jax(fresh_engines, pool_feats):
    e = fresh_engines
    ac_vars, d_vars, r_vars = e["vars"]
    loss_cfg = tc.ActorCriticLossConfig(backup_every=T, gamma=GAMMA)
    j_cfg = JLossConfig(**asdict(loss_cfg))
    spec = replace(OptimizerSpec.from_cfg(tc.OptimizerConfig(lr=LR), tc.TrainingConfig()),
                   lr_warmup_steps=0)
    key = jax.random.PRNGKey(21)

    # JAX: the gradient as training.py:185-193 takes it, and the step's new parameters
    st_j, j_pool, st_p, p_pool = _pools(e, pool_feats)
    jac = e["j"].actor_critic

    def loss_fn(params):
        traj, _, _ = e["j"].rollout({"params": params}, d_vars, r_vars, st_j, j_pool, key, T)
        loss, metrics = jac.loss_from_rollout(
            traj["act"], traj["rew"], traj["end"].astype(jnp.float32),
            traj["trunc"].astype(jnp.float32), traj["logits_act"], traj["val"],
            traj["val_bootstrap"], j_cfg)
        return loss, (metrics, traj)

    (loss_j, (metrics_j, traj_j)), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(ac_vars["params"])
    tx_j = j_configure_opt(spec.lr, spec.weight_decay, spec.eps, spec.max_grad_norm, 0)
    step_j = j_make_ac_train_step(e["j"], jac, tx_j, j_cfg)
    copy = lambda tree: jax.tree_util.tree_map(jnp.copy, tree)  # noqa: E731 (it donates)
    state_j, _, _, m_step_j = step_j(JTrainState.create(copy(ac_vars["params"]), tx_j), d_vars,
                                     r_vars, copy(st_j), copy(j_pool), key)

    # the port: the same loss and gradient, then the step
    draws = jax_draws(key, T)
    pac = e["p"].actor_critic
    traj, _, _ = e["p"].rollout(st_p, p_pool, T, draws=draws)
    loss_p, _ = pac.loss_from_rollout(traj["act"], traj["rew"], traj["end"].float(),
                                      traj["trunc"].float(), traj["logits_act"], traj["val"],
                                      traj["val_bootstrap"], loss_cfg)
    loss_p.backward()
    grads_p = {n: p.grad.clone() for n, p in pac.net.named_parameters()}
    for p in pac.net.parameters():
        p.grad = None
    tx = spec.build()
    state = TrainState.create(pac.net, tx)
    state, st2, pool2, metrics = make_ac_train_step(e["p"], pac, tx, loss_cfg)(
        state, st_p, p_pool, draws=draws)

    dead = np.asarray(traj_j["dead"])
    assert 0 < dead.sum() < dead.size, "resets and survivors must both occur"
    for k in ("act", "rew", "end", "dead"):
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(traj_j[k]), err_msg=k)
    assert metrics["imagination_deaths"].item() == int(m_step_j["imagination_deaths"])
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-3, atol=1e-3)
    for k, v in m_step_j.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-3, atol=1e-3,
                                   err_msg=k)
    _leafwise_close(grads_p, grads_j, 2e-3)
    # the update: Adam's first step moves each weight by about lr * sign(g); where the two
    # gradients agree in sign, the new weights agree to 1e-2 of lr
    new_j = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                                      state_j.params)})
    old = variables_to_state_dict(ac_vars)
    ref = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads_j)})
    for n, p in pac.net.named_parameters():
        g = ref[n].numpy()
        firm = np.abs(g) > 1e-2 * np.abs(g).max()
        d = np.abs(p.detach().numpy() - new_j[n].numpy())[firm]
        assert d.size == 0 or d.max() <= 1e-2 * LR, (n, d.max())
        assert not np.array_equal(p.detach().numpy(), old[n].numpy()), n
    assert state.step == 1 and st2.ac_hx.grad_fn is None and not st2.ac_hx.requires_grad


def test_two_ac_steps_leave_no_graph_and_no_world_model_gradient(fresh_engines):
    """Two consecutive steps from the state the first returns: the returned imagination
    state carries no graph, the metrics are detached, and no world-model parameter gets
    a gradient."""
    e = fresh_engines
    _, _, st, pool = _pools(e, True)
    pac = e["p"].actor_critic
    loss_cfg = tc.ActorCriticLossConfig(backup_every=T)
    tx = configure_opt(LR, 0.0, 1e-8, 100.0, 0)
    state = TrainState.create(pac.net, tx)
    step = make_ac_train_step(e["p"], pac, tx, loss_cfg)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, st, pool, metrics = step(state, st, pool, generator=gen)
        for k in ("ac_hx", "ac_cx", "re_hx", "re_cx"):
            assert not getattr(st, k).requires_grad, k
        assert all(not m.requires_grad and torch.isfinite(m).all() for m in metrics.values())
    assert state.step == 2 and int(pool.ptr) > B
    for net in (e["p"].denoiser.inner_model, e["p"].rew_end_model.net):
        assert all(p.grad is None for p in net.parameters())
    assert all(p.grad is None for p in pac.net.parameters())  # cleared after the update


def test_training_module_imports_no_jax_and_no_yaml():
    code = ("import sys\nimport diamond_tpu_torch.training\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'diamond_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
