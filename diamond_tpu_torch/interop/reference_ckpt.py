"""Published DIAMOND checkpoints -> the port's weights (the port's own copy of
diamond_tpu/interop/torch_ckpt.py, numpy only).

DIAMOND publishes trained agents (the HF Hub's eloialonso/diamond, ``atari_100k/models/
<Game>.pt``) as flat torch state dicts keyed ``{denoiser|rew_end_model|actor_critic}.
<module path>`` in its own NCHW layout. ``convert_reference_state_dict`` turns one into
a variable tree per model in the flax-path layout the port's state dicts use ({"params":
..., "constants": ...}, nested dicts of numpy arrays: what ``interop/jax_vars.py`` and
``Agent.load_state_dict`` take), array for array what the JAX package's converter gives.

Layout conversions:
  * Conv2d OIHW -> HWIO; Linear (out, in) -> (in, out).
  * GroupNorm weight/bias -> scale/bias.
  * LSTM/LSTMCell weight_ih/hh (4H, in) -> (in, 4H); the gate order (i, f, g, o) is
    shared, the biases are copied as they are.
  * The spatial flatten: DIAMOND flattens the conv features CHW before both LSTMs, the
    port HWC; the LSTMs' input weights are permuted along their input axis to match.
  * The FourierFeatures frequencies -> the 'constants' collection.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List

import numpy as np


def _t_conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _t_lin(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


def _chw_to_hwc_perm(c: int, h: int, w: int) -> np.ndarray:
    """perm[j] = torch flat index of the feature that sits at our flat index j."""
    idx = np.arange(c * h * w).reshape(c, h, w)      # torch order (C, H, W)
    return np.transpose(idx, (1, 2, 0)).reshape(-1)  # ours (H, W, C)


def _set(tree: Dict, path: List[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.ascontiguousarray(value)


class _Converter:
    """Walks the checkpoint's keys and emits the flax-path parameter trees."""

    def __init__(self, sd: Dict[str, np.ndarray]) -> None:
        self.sd = sd
        self.params: Dict[str, Any] = {}
        self.constants: Dict[str, Any] = {}

    def conv(self, ref: str, ours: List[str]) -> None:
        _set(self.params, ours + ["kernel"], _t_conv(self.sd[f"{ref}.weight"]))
        if f"{ref}.bias" in self.sd:
            _set(self.params, ours + ["bias"], self.sd[f"{ref}.bias"])

    def linear(self, ref: str, ours: List[str]) -> None:
        _set(self.params, ours + ["kernel"], _t_lin(self.sd[f"{ref}.weight"]))
        if f"{ref}.bias" in self.sd:
            _set(self.params, ours + ["bias"], self.sd[f"{ref}.bias"])

    def groupnorm(self, ref: str, ours: List[str]) -> None:
        # DIAMOND wraps nn.GroupNorm as .norm
        _set(self.params, ours + ["scale"], self.sd[f"{ref}.norm.weight"])
        _set(self.params, ours + ["bias"], self.sd[f"{ref}.norm.bias"])

    def embed(self, ref: str, ours: List[str]) -> None:
        _set(self.params, ours + ["embedding"], self.sd[f"{ref}.weight"])

    def lstm(self, ref: str, ours: List[str], input_perm=None, suffix: str = "_l0") -> None:
        w_ih = _t_lin(self.sd[f"{ref}.weight_ih{suffix}"])
        if input_perm is not None:
            w_ih = w_ih[input_perm]
        _set(self.params, ours + ["weight_ih"], w_ih)
        _set(self.params, ours + ["weight_hh"], _t_lin(self.sd[f"{ref}.weight_hh{suffix}"]))
        _set(self.params, ours + ["bias_ih"], self.sd[f"{ref}.bias_ih{suffix}"])
        _set(self.params, ours + ["bias_hh"], self.sd[f"{ref}.bias_hh{suffix}"])

    def resblock(self, ref: str, ours: List[str]) -> None:
        if f"{ref}.proj.weight" in self.sd:
            self.conv(f"{ref}.proj", ours + ["proj"])
        self.linear(f"{ref}.norm1.linear", ours + ["norm1", "linear"])
        self.conv(f"{ref}.conv1", ours + ["conv1"])
        self.linear(f"{ref}.norm2.linear", ours + ["norm2", "linear"])
        self.conv(f"{ref}.conv2", ours + ["conv2"])
        if f"{ref}.attn.qkv_proj.weight" in self.sd:
            self.groupnorm(f"{ref}.attn.norm", ours + ["attn", "norm"])
            self.conv(f"{ref}.attn.qkv_proj", ours + ["attn", "qkv_proj"])
            self.conv(f"{ref}.attn.out_proj", ours + ["attn", "out_proj"])

    def resblocks(self, ref: str, ours: List[str]) -> None:
        i = 0
        while f"{ref}.resblocks.{i}.conv1.weight" in self.sd:
            self.resblock(f"{ref}.resblocks.{i}", ours + [f"resblocks_{i}"])
            i += 1

    def small_resblock(self, ref: str, ours: List[str]) -> None:
        # DIAMOND's SmallResBlock: f.0 the GroupNorm wrapper, f.2 the conv, the skip
        _set(self.params, ours + ["norm", "scale"], self.sd[f"{ref}.f.0.norm.weight"])
        _set(self.params, ours + ["norm", "bias"], self.sd[f"{ref}.f.0.norm.bias"])
        self.conv(f"{ref}.f.2", ours + ["conv"])
        if f"{ref}.skip_projection.weight" in self.sd:
            self.conv(f"{ref}.skip_projection", ours + ["skip_projection"])


def convert_denoiser(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The denoiser's keys, rooted at ``inner_model.``."""
    c = _Converter(sd)
    p = "inner_model"
    _set(c.constants, ["noise_emb", "weight"], sd[f"{p}.noise_emb.weight"])
    c.embed(f"{p}.act_emb.0", ["act_emb"])
    c.linear(f"{p}.cond_proj.0", ["cond_proj_0"])
    c.linear(f"{p}.cond_proj.2", ["cond_proj_2"])
    c.conv(f"{p}.conv_in", ["conv_in"])

    # encoder levels
    i = 0
    while f"{p}.unet.d_blocks.{i}.resblocks.0.conv1.weight" in sd:
        c.resblocks(f"{p}.unet.d_blocks.{i}", ["unet", f"d_blocks_{i}"])
        if i > 0:
            c.conv(f"{p}.unet.downsamples.{i}.conv", ["unet", f"downsamples_{i}", "conv"])
        i += 1
    num_levels = i
    c.resblocks(f"{p}.unet.mid_blocks", ["unet", "mid_blocks"])
    for j in range(num_levels):
        c.resblocks(f"{p}.unet.u_blocks.{j}", ["unet", f"u_blocks_{j}"])
        if j > 0:
            c.conv(f"{p}.unet.upsamples.{j}.conv", ["unet", f"upsamples_{j}", "conv"])

    c.groupnorm(f"{p}.norm_out", ["norm_out"])
    c.conv(f"{p}.conv_out", ["conv_out"])
    return {"params": c.params, "constants": c.constants}


def convert_rew_end_model(sd: Dict[str, np.ndarray], img_size: int) -> Dict[str, Any]:
    """The rew/end model's keys: the encoder, the action embedding, the LSTM, the head."""
    c = _Converter(sd)
    c.conv("encoder.conv_in", ["encoder", "conv_in"])
    i = 0
    while f"encoder.blocks.{i}.resblocks.0.conv1.weight" in sd:
        c.resblocks(f"encoder.blocks.{i}", ["encoder", f"blocks_{i}"])
        if f"encoder.downsamples.{i}.conv.weight" in sd:
            c.conv(f"encoder.downsamples.{i}.conv", ["encoder", f"downsamples_{i}", "conv"])
        i += 1
    num_levels = i - 1  # last blocks entry is the extra attn pair with no downsample
    c.embed("act_emb", ["act_emb"])

    # LSTM input = flattened conv features: permute CHW -> HWC.
    # num_levels == len(depths); downsample count == len(depths) - 1
    # (DIAMOND's feature size: img_size // 2 ** (len(depths) - 1)).
    ch = sd[f"encoder.blocks.{num_levels}.resblocks.0.conv1.weight"].shape[0]
    feat = img_size // 2 ** max(0, num_levels - 1)
    perm = _chw_to_hwc_perm(ch, feat, feat)
    c.lstm("lstm", ["lstm", "cell"], input_perm=perm)
    c.linear("head.0", ["head_0"])
    c.linear("head.2", ["head_2"])
    return {"params": c.params}


def convert_actor_critic(sd: Dict[str, np.ndarray], img_size: int,
                         down: List[int]) -> Dict[str, Any]:
    """The actor-critic's keys: the encoder Sequential (conv_in at 0, the SmallResBlocks at
    1 + i + sum(down[:i]), max-pools between), the LSTMCell, the two heads."""
    c = _Converter(sd)
    c.conv("encoder.encoder.0", ["encoder", "conv_in"])
    idx = 1
    ch = None
    for i, d in enumerate(down):
        c.small_resblock(f"encoder.encoder.{idx}", ["encoder", f"blocks_{i}"])
        ch = sd[f"encoder.encoder.{idx}.f.2.weight"].shape[0]
        idx += 1 + int(d)
    feat = img_size // 2 ** sum(down)
    perm = _chw_to_hwc_perm(ch, feat, feat)
    c.lstm("lstm", ["lstm"], input_perm=perm, suffix="")
    c.linear("actor_linear", ["actor_linear"])
    c.linear("critic_linear", ["critic_linear"])
    return {"params": c.params}


def split_by_prefix(flat_sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in flat_sd.items():
        if k.startswith(prefix + "."):
            out[k[len(prefix) + 1:]] = np.asarray(v)
    return out


def convert_reference_state_dict(flat_sd: Dict[str, Any], img_size: int = 64,
                                 ac_down: List[int] = (1, 1, 1, 1)) -> Dict[str, Any]:
    """A flat DIAMOND agent state dict -> {denoiser, rew_end_model, actor_critic}
    variable trees (the checkpoint's prefix split, then each model's conversion)."""
    return {
        "denoiser": convert_denoiser(split_by_prefix(flat_sd, "denoiser")),
        "rew_end_model": convert_rew_end_model(split_by_prefix(flat_sd, "rew_end_model"),
                                               img_size),
        "actor_critic": convert_actor_critic(split_by_prefix(flat_sd, "actor_critic"),
                                             img_size, list(ac_down)),
    }


def load_reference_checkpoint(path: Path, img_size: int = 64,
                              ac_down: List[int] = (1, 1, 1, 1)) -> Dict[str, Any]:
    """Load a DIAMOND ``.pt`` agent checkpoint on the CPU and convert it."""
    import torch

    sd = torch.load(Path(path), map_location="cpu")
    flat = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}
    return convert_reference_state_dict(flat, img_size=img_size, ac_down=ac_down)
