"""The port's converter of published DIAMOND checkpoints (diamond_tpu_torch/interop/
reference_ckpt.py) against the JAX package's (diamond_tpu/interop/torch_ckpt.py), on the
CPU at a tiny size: 16x16 frames, channels [8, 8], LSTM 32, 4 actions. The checkpoints
are DIAMOND-format state dicts of tests/torch_twin.py's modules (``TInnerModel``,
``TRewEndModel``, ``TActorCritic``), which compute as DIAMOND's modules do in NCHW.

  * every array the port's converter gives equals the JAX converter's, bit for bit, in
    the same trees;
  * the port's models loaded from it (``Agent.load_state_dict``, what ``play
    --pretrained`` does) match the twins' outputs: the denoiser's inner model, the
    rew/end model over a sequence (the LSTM's CHW -> HWC input permutation), the
    actor-critic's logits, value and carry (its own permutation);
  * ``load_reference_checkpoint`` reads a ``.pt`` file as ``convert_reference_state_dict``
    converts the dict.

Tolerance: the twins' outputs within tests/test_interop_full.py's rtol 5e-3, atol 5e-4
(f32 through NCHW torch convs against the port's NHWC ops, sums in other orders).
"""

import jax
import numpy as np
import pytest
import torch

from diamond_tpu.interop.torch_ckpt import convert_reference_state_dict as j_convert
from diamond_tpu_torch import config as tc
from diamond_tpu_torch.interop.reference_ckpt import (convert_reference_state_dict,
                                                       load_reference_checkpoint)
from diamond_tpu_torch.models import Agent

from torch_twin import TActorCritic, TInnerModel, TRewEndModel

RTOL, ATOL = 5e-3, 5e-4
IMG, C, NC, NA, D = 16, 3, 4, 4, 32
COND, DEPTHS, CHANNELS, ATTN = 16, [1, 1], [8, 8], [0, 0]
AC_CHANNELS, AC_DOWN = [8, 8], [1, 1]


@pytest.fixture(scope="module")
def twins():
    torch.manual_seed(0)
    den = TInnerModel(C, NC, COND, DEPTHS, CHANNELS, [0, 1], NA).eval()
    rew_end = TRewEndModel(D, C, IMG, 8, DEPTHS, CHANNELS, ATTN, NA).eval()
    ac = TActorCritic(D, C, IMG, AC_CHANNELS, AC_DOWN, NA).eval()
    with torch.no_grad():  # DIAMOND zero-inits the heads: give them weights to compare
        for p in (den.conv_out.weight, ac.actor_linear.weight, ac.critic_linear.weight):
            p.normal_(0, 0.1)
    flat = {f"denoiser.inner_model.{k}": v for k, v in den.state_dict_ref_format().items()}
    flat.update({f"rew_end_model.{k}": v for k, v in rew_end.state_dict().items()})
    flat.update({f"actor_critic.{k}": v for k, v in ac.state_dict().items()})
    return den, rew_end, ac, {k: v.detach().numpy() for k, v in flat.items()}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_converter_equals_jax_bit_for_bit(twins):
    flat = twins[-1]
    got = convert_reference_state_dict(flat, img_size=IMG, ac_down=AC_DOWN)
    ref = j_convert(flat, img_size=IMG, ac_down=AC_DOWN)
    assert set(got) == set(ref) == {"denoiser", "rew_end_model", "actor_critic"}
    for name in ref:
        g, r = _leaves(got[name]), _leaves(ref[name])
        assert [p for p, _ in g] == [p for p, _ in r], name
        for (path, a), (_, b) in zip(g, r):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), \
                (name, path)


def _agent(variables):
    cfg = tc.AgentConfig(
        denoiser=tc.DenoiserConfig(inner_model=tc.InnerModelConfig(
            img_channels=C, num_steps_conditioning=NC, cond_channels=COND, depths=DEPTHS,
            channels=CHANNELS, attn_depths=[0, 1])),
        rew_end_model=tc.RewEndModelConfig(lstm_dim=D, img_channels=C, img_size=IMG,
                                           cond_channels=8, depths=DEPTHS, channels=CHANNELS,
                                           attn_depths=ATTN),
        actor_critic=tc.ActorCriticConfig(lstm_dim=D, img_channels=C, img_size=IMG,
                                          channels=AC_CHANNELS, down=AC_DOWN),
        num_actions=NA)
    agent = Agent(cfg, torch.float32, device="cpu")
    agent.load_state_dict(variables, list(variables))
    return agent


def _close(port, twin):
    np.testing.assert_allclose(port.detach().numpy(), twin.detach().numpy(), rtol=RTOL,
                               atol=ATOL)


def test_converted_models_match_the_twins(twins):
    den, rew_end, ac, flat = twins
    agent = _agent(convert_reference_state_dict(flat, img_size=IMG, ac_down=AC_DOWN))
    rng = np.random.default_rng(1)
    nhwc = lambda x: torch.from_numpy(np.moveaxis(x, -3, -1).copy())  # noqa: E731
    b, t = 2, 5
    noisy = rng.normal(size=(b, C, IMG, IMG)).astype(np.float32)
    obs = rng.uniform(-1, 1, (b, NC * C, IMG, IMG)).astype(np.float32)
    act = rng.integers(0, NA, (b, NC))
    c_noise = rng.normal(size=(b,)).astype(np.float32)
    with torch.no_grad():
        y_t = den(torch.from_numpy(noisy), torch.from_numpy(c_noise), torch.from_numpy(obs),
                  torch.from_numpy(act))
        y_p = agent.denoiser.inner_model(nhwc(noisy), torch.from_numpy(c_noise), nhwc(obs),
                                         torch.from_numpy(act))
    _close(y_p, y_t.permute(0, 2, 3, 1))

    seq = rng.uniform(-1, 1, (b, t + 1, C, IMG, IMG)).astype(np.float32)
    act = rng.integers(0, NA, (b, t))
    with torch.no_grad():
        lr_t, le_t, (h_t, c_t) = rew_end(torch.from_numpy(seq[:, :-1]), torch.from_numpy(act),
                                         torch.from_numpy(seq[:, 1:]))
        lr_p, le_p, (h_p, c_p) = agent.rew_end_model.predict_rew_end(
            nhwc(seq[:, :-1]), torch.from_numpy(act), nhwc(seq[:, 1:]))
    for p, tw in ((lr_p, lr_t), (le_p, le_t), (h_p, h_t[0]), (c_p, c_t[0])):
        _close(p, tw)

    frame = rng.uniform(-1, 1, (b, C, IMG, IMG)).astype(np.float32)
    hx, cx = (torch.from_numpy(rng.normal(size=(b, D)).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        lg_t, v_t, (h_t, c_t) = ac(torch.from_numpy(frame), (hx, cx))
        out = agent.actor_critic.head(agent.actor_critic.encode(nhwc(frame)), (hx, cx))
    for p, tw in ((out.logits_act, lg_t), (out.val, v_t), (out.carry[0], h_t),
                  (out.carry[1], c_t)):
        _close(p, tw)


def test_load_reference_checkpoint_reads_a_pt_file(twins, tmp_path):
    flat = twins[-1]
    path = tmp_path / "Game.pt"
    torch.save({k: torch.from_numpy(v) for k, v in flat.items()}, path)
    got = load_reference_checkpoint(path, img_size=IMG, ac_down=AC_DOWN)
    ref = convert_reference_state_dict(flat, img_size=IMG, ac_down=AC_DOWN)
    for name in ref:
        for (pg, a), (pr, b) in zip(_leaves(got[name]), _leaves(ref[name])):
            assert pg == pr and np.array_equal(a, b), (name, pg)
