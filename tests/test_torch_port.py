"""diamond_tpu_torch as a package: its default config against the JAX package's trainer
config, the weight bridge both ways, the full-size parameter layout, reference-format
checkpoints, and that the port imports neither jax nor yaml."""

import os
import subprocess
import sys
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from diamond_tpu.config import load_config
from diamond_tpu.models import Agent as JAgent, AgentConfig as JAgentConfig
from diamond_tpu_torch import config as tc
from diamond_tpu_torch.interop.jax_vars import (load_variables, module_to_variables,
                                                variables_to_state_dict)
from diamond_tpu_torch.models import Agent

from torch_port_util import close, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_config_equals_trainer_yaml():
    cfg = load_config("trainer")
    port = tc.AgentConfig(num_actions=4)
    for name, sub in (("rew_end_model", port.rew_end_model), ("actor_critic", port.actor_critic)):
        ours = {k: v for k, v in asdict(sub).items() if k != "num_actions"}
        assert ours == {k: cfg.agent[name][k] for k in ours}, name
    den = cfg.agent.denoiser
    assert (port.denoiser.sigma_data, port.denoiser.sigma_offset_noise) == \
        (den.sigma_data, den.sigma_offset_noise)
    # is_upsampler: the YAML leaves it to InnerModelConfig.from_cfg's default, False
    inner = {k: v for k, v in asdict(port.denoiser.inner_model).items()
             if k not in ("num_actions", "is_upsampler")}
    assert inner == {k: den.inner_model[k] for k in inner}
    assert port.denoiser.inner_model.is_upsampler is den.inner_model.get("is_upsampler", False)
    assert port.upsampler is None and cfg.agent.upsampler is None
    wm = tc.WorldModelEnvConfig()
    assert (wm.horizon, wm.num_batches_to_preload) == \
        (cfg.world_model_env.horizon, cfg.world_model_env.num_batches_to_preload)
    assert asdict(wm.diffusion_sampler) == dict(cfg.world_model_env.diffusion_sampler)
    assert tc.IMG_SIZE == cfg.env.train.size
    rt = tc.RuntimeConfig()
    assert (rt.compute_dtype, rt.pool_policy_feats, rt.int8_rollout, rt.int8_sites,
            rt.grad_acc_sum) == \
        (cfg.tpu.compute_dtype, cfg.tpu.pool_policy_feats, cfg.tpu.int8_rollout,
         cfg.tpu.int8_sites, cfg.tpu.grad_acc_sum)


SMALL = dict(
    denoiser=dict(inner_model=dict(img_channels=3, num_steps_conditioning=4, cond_channels=16,
                                   depths=[1, 1], channels=[32, 32], attn_depths=[0, 1])),
    rew_end_model=dict(lstm_dim=32, img_channels=3, img_size=16, cond_channels=8,
                       depths=[1, 1], channels=[32, 32], attn_depths=[0, 0]),
    actor_critic=dict(lstm_dim=32, img_channels=3, img_size=16, channels=[16, 32],
                      down=[1, 1]))


def _port_agent_config(d):
    return tc.AgentConfig(
        denoiser=tc.DenoiserConfig(inner_model=tc.InnerModelConfig(**d["denoiser"]["inner_model"])),
        rew_end_model=tc.RewEndModelConfig(**d["rew_end_model"]),
        actor_critic=tc.ActorCriticConfig(**d["actor_critic"]), num_actions=3)


def _jax_agent_config(d):
    from diamond_tpu.models import (ActorCriticConfig, DenoiserConfig, InnerModelConfig,
                                    RewEndModelConfig)
    return JAgentConfig(
        denoiser=DenoiserConfig(inner_model=InnerModelConfig(**d["denoiser"]["inner_model"]),
                                sigma_data=0.5, sigma_offset_noise=0.3),
        rew_end_model=RewEndModelConfig(**d["rew_end_model"]),
        actor_critic=ActorCriticConfig(**d["actor_critic"]), num_actions=3)


def test_weight_bridge_round_trip():
    """JAX init variables -> port (strict load) -> back: identical trees, all three
    models."""
    ja = JAgent(_jax_agent_config(SMALL))
    variables = jax.jit(lambda k: ja.init(k, img_size=16).variables)(jax.random.PRNGKey(0))
    port = Agent(_port_agent_config(SMALL), device="cpu")
    for name, net in port.nets.items():
        v = jax.tree_util.tree_map(np.asarray, variables[name])
        load_variables(net, v)
        back = module_to_variables(net)
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v), name
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
            np.testing.assert_array_equal(a, b)


def test_full_size_layout_and_init_match_jax():
    """The full-size default agent: every parameter name and shape equals the JAX
    package's (from jax.eval_shape, nothing computed), and the port's seeded init draws
    each tensor from the same family (zeros where JAX zero-inits, same bounds)."""
    cfg = load_config("trainer")
    ja = JAgent(JAgentConfig.from_cfg(cfg.agent, 4))
    shapes = jax.eval_shape(lambda k: JAgent.init(ja, k).variables, jax.random.PRNGKey(0))
    port = Agent(tc.AgentConfig(), device="cpu", generator=torch.Generator().manual_seed(0))
    for name, net in port.nets.items():
        ref = {k: tuple(v.shape) for k, v in
               variables_to_state_dict(jax.tree_util.tree_map(
                   lambda s: np.zeros(s.shape, np.float32), shapes[name])).items()}
        assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == ref, name
    sd = port.nets["denoiser"].state_dict()
    assert not sd["conv_out.kernel"].any() and not sd["unet.d_blocks_0.resblocks_0.conv2.kernel"].any()
    k = sd["unet.downsamples_1.conv.kernel"].reshape(-1, 64)
    torch.testing.assert_close(k.T @ k, torch.eye(64), atol=1e-5, rtol=0)  # orthogonal
    assert sd["conv_in.kernel"].abs().max() <= 1 / np.sqrt(9 * 15)
    ac = port.nets["actor_critic"].state_dict()
    assert not ac["actor_linear.kernel"].any() and not ac["critic_linear.kernel"].any()
    b = ac["lstm.bias_ih"]
    assert (b[512:1024] == 1).all() and not b[:512].any() and not b[1024:].any()


def test_reference_checkpoint_reaches_the_port():
    """A reference-format agent checkpoint (the torch twins of the reference's three
    models, keys ``{denoiser|rew_end_model|actor_critic}.<path>``) goes through
    diamond_tpu's numpy-only ``convert_reference_state_dict`` and the bridge into the
    port (strict loads), and the port reproduces the twins' outputs. This also holds the
    port's HWC flatten before both LSTMs to the converter's CHW -> HWC permutation.
    Tolerance 5e-4: the twins use torch's own GroupNorm (two-pass moments)."""
    from diamond_tpu.interop.torch_ckpt import convert_reference_state_dict
    from torch_twin import TActorCritic, TInnerModel, TRewEndModel

    inner, rew, ac = SMALL["denoiser"]["inner_model"], SMALL["rew_end_model"], SMALL["actor_critic"]
    torch.manual_seed(0)
    twins = dict(
        denoiser=TInnerModel(3, 4, 16, inner["depths"], inner["channels"],
                             inner["attn_depths"], 3),
        rew_end_model=TRewEndModel(32, 3, 16, 8, rew["depths"], rew["channels"],
                                   rew["attn_depths"], 3),
        actor_critic=TActorCritic(32, 3, 16, ac["channels"], ac["down"], 3))
    with torch.no_grad():  # the reference zero-inits these heads
        twins["actor_critic"].actor_linear.weight.normal_(0, 0.1)
        twins["actor_critic"].critic_linear.weight.normal_(0, 0.1)
    flat = {}
    for name, twin in twins.items():
        twin.eval()
        sd = twin.state_dict_ref_format() if name == "denoiser" else twin.state_dict()
        prefix = f"{name}.inner_model" if name == "denoiser" else name
        flat.update({f"{prefix}.{k}": v.numpy() for k, v in sd.items()})
    variables = convert_reference_state_dict(flat, img_size=16, ac_down=ac["down"])
    port = Agent(_port_agent_config(SMALL), device="cpu")
    for name, net in port.nets.items():
        load_variables(net, variables[name])

    rng = np.random.default_rng(1)
    nhwc = lambda x: t(np.moveaxis(x, -3, -1))  # noqa: E731  (..., C, H, W) -> (..., H, W, C)
    noisy = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    obs = rng.uniform(-1, 1, (2, 12, 16, 16)).astype(np.float32)
    act = rng.integers(0, 3, (2, 4))
    c_noise = rng.normal(size=(2,)).astype(np.float32)
    seq = rng.uniform(-1, 1, (2, 4, 3, 16, 16)).astype(np.float32)
    hx, cx = (rng.normal(size=(2, 32)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        y_ref = twins["denoiser"](t(noisy), t(c_noise), t(obs), t(act))
        y = port.denoiser.inner_model(nhwc(noisy), t(c_noise), nhwc(obs), t(act))
        close(y.permute(0, 3, 1, 2), y_ref.numpy(), 5e-4, 5e-4)

        r_ref, e_ref, _ = twins["rew_end_model"](t(seq[:, :-1]), t(act[:, :-1]), t(seq[:, 1:]))
        r, e, _ = port.rew_end_model.predict_rew_end(nhwc(seq[:, :-1]), t(act[:, :-1]),
                                                     nhwc(seq[:, 1:]))
        close(r, r_ref.numpy(), 5e-4, 5e-4)
        close(e, e_ref.numpy(), 5e-4, 5e-4)

        lg_ref, v_ref, (h_ref, _) = twins["actor_critic"](t(seq[:, 0]), (t(hx), t(cx)))
        out = port.actor_critic.head(port.actor_critic.encode(nhwc(seq[:, 0])), (t(hx), t(cx)))
        close(out.logits_act, lg_ref.numpy(), 5e-4, 5e-4)
        close(out.val, v_ref.numpy(), 5e-4, 5e-4)
        close(out.carry[0], h_ref.numpy(), 5e-4, 5e-4)


def test_port_imports_no_jax_and_no_yaml():
    modules = ["diamond_tpu_torch", "diamond_tpu_torch.config", "diamond_tpu_torch.kernels",
               "diamond_tpu_torch.ops", "diamond_tpu_torch.ops.quant", "diamond_tpu_torch.models",
               "diamond_tpu_torch.data.episode", "diamond_tpu_torch.data.segment",
               "diamond_tpu_torch.data.dataset", "diamond_tpu_torch.data.batch_sampler",
               "diamond_tpu_torch.data.device_store", "diamond_tpu_torch.data.traverser",
               "diamond_tpu_torch.utils", "diamond_tpu_torch.tracing",
               "diamond_tpu_torch.training",
               "diamond_tpu_torch.envs.world_model_env",
               "diamond_tpu_torch.interop.jax_vars",
               "diamond_tpu_torch.envs.env", "diamond_tpu_torch.envs.fake_env",
               "diamond_tpu_torch.envs.fake_ale", "diamond_tpu_torch.envs.atari_preprocessing",
               "diamond_tpu_torch.coroutines", "diamond_tpu_torch.coroutines.env_loop",
               "diamond_tpu_torch.coroutines.collector", "diamond_tpu_torch.data.prefetch",
               "diamond_tpu_torch.checkpoint", "diamond_tpu_torch.trainer",
               "diamond_tpu_torch.main", "diamond_tpu_torch.parallel",
               "diamond_tpu_torch.parallel.mesh", "diamond_tpu_torch.parallel.multihost"]
    # torch itself may import tqdm where it is installed: the forbidden modules it loaded
    # are dropped and their import blocked before the port's modules are imported
    code = ("import importlib, importlib.abc, sys\n"
            "import numpy, torch\n"
            "FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'diamond_tpu', "
            "'gymnasium', 'cv2', 'tqdm', 'wandb')\n"
            "for m in [m for m in sys.modules if m.split('.')[0] in FORBIDDEN]:\n"
            "    del sys.modules[m]\n"
            "class Block(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in FORBIDDEN:\n"
            "            raise ImportError(f'the port imported {name}')\n"
            "sys.meta_path.insert(0, Block())\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


def test_cli_refuses_to_run_without_a_gpu(tmp_path):
    """No CUDA here: ``python -m diamond_tpu_torch.main`` exits non-zero with its message
    before any later stage (no traceback, no run dir)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "diamond_tpu_torch.main", "env=fake",
                          "--run-dir", str(tmp_path / "run")], cwd=tmp_path,
                         capture_output=True, text=True, env=env)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "Traceback" not in res.stderr
    assert not (tmp_path / "run").exists()


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """No CUDA here: the chip smoke exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True)
    assert res.returncode != 0 and '"ok"' not in res.stdout
