"""Plain PyTorch reference of DIAMOND's models, written from the published design
(eloialonso/diamond: ``models/blocks.py``, ``inner_model.py``, ``denoiser.py``,
``rew_end_model.py``, ``actor_critic.py``) and the static int8 scheme of the trainer's
``int8_rollout``. It imports nothing of the program under test: every function takes a
flat dict of weights ``W`` keyed by the parameter names of ``param_specs`` and computes
in float32 (the caller turns TF32 off), NHWC activations, HWIO 3x3 kernels.

``Ctx`` carries how a call computes:
- ``precision``: "f32", or "fp8" (the control: the operands of every convolution and
  matrix product rounded to float8 e4m3 with a per-tensor scale);
- ``quant``: {site name: per-input-channel max |x|} of the int8 sites, computed as int8
  codes (``int_max`` 127; the control's int4 takes 7) with int32-exact sums;
- ``record``: where set, the int8 sites of kind ``kinds`` record their inputs' max |x|
  per channel (the calibration pass), max-merged over calls;
- ``ops``: where set, every product appends (kind, name, flops, bytes, int8, needs_dx,
  trained), so that the benchmark counts a step's work from its shapes (on "meta"
  tensors no number is computed at all).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

GN_EPS = 1e-5
GN_GROUP = 32
HEAD_DIM = 8
HEADROOM = 1.05          # the int8 activation scale's headroom over the calibrated max
FP8_MAX = 448.0          # float8 e4m3


class Ctx:
    def __init__(self, precision: str = "f32", quant: Optional[Dict[str, torch.Tensor]] = None,
                 record: Optional[Dict[str, torch.Tensor]] = None,
                 kinds: Sequence[str] = ("conv3x3", "conv1x1"), int_max: int = 127,
                 ops: Optional[list] = None, trained: bool = False) -> None:
        self.precision, self.record = precision, record
        self.quant = {} if quant is None else quant
        self.kinds, self.int_max, self.ops, self.trained = set(kinds), int_max, ops, trained

    def with_(self, **kw) -> "Ctx":
        c = Ctx.__new__(Ctx)
        c.__dict__.update(self.__dict__)
        c.__dict__.update(kw)
        return c


def _round8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    s = torch.clamp_min(x.abs().amax(), 1e-30) / top
    return (x / s).to(dtype).to(torch.float32) * s


class _FP8(torch.autograd.Function):
    """The fp8 training recipe's rounding of a product's operand: e4m3 forward, and its
    gradient in e5m2 backward, each under a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


def _operand(ctx: Ctx, x: torch.Tensor) -> torch.Tensor:
    return fp8(x) if ctx.precision == "fp8" and x.device.type != "meta" else x


def _count(ctx: Ctx, kind: str, name: str, flops: float, nbytes: float, q: bool,
           x: torch.Tensor) -> None:
    if ctx.ops is not None:
        ctx.ops.append(dict(kind=kind, name=name, flops=float(flops), bytes=float(nbytes),
                            int8=q, needs_dx=bool(x.requires_grad),
                            trained=ctx.trained and torch.is_grad_enabled()))


class AllSites:
    """``Ctx.quant`` of a count on meta tensors: every site of the selected kinds."""

    def __contains__(self, name) -> bool:
        return True


def _site(ctx: Ctx, name: str, kind: str, x: torch.Tensor) -> bool:
    """Record x's range where calibrating; True where the site computes in int8."""
    if kind not in ctx.kinds:
        return False
    if ctx.record is not None and x.device.type != "meta":
        m = x.detach().abs().amax(dim=tuple(range(x.dim() - 1)))
        prev = ctx.record.get(name)
        ctx.record[name] = m if prev is None else torch.maximum(prev, m)
        return False
    return name in ctx.quant


def _qscales(ctx: Ctx, act_max: torch.Tensor, w: torch.Tensor):
    """(activation scale per input channel, int weight codes, weight scale per output
    channel) of a site: s = max(act_max, 1e-8) * HEADROOM / qmax, folded into w (..., Cin,
    Cout), w quantized per output channel."""
    q = float(ctx.int_max)
    s = torch.clamp_min(act_max, 1e-8) * HEADROOM / q
    wf = w * s[(None,) * (w.dim() - 2) + (slice(None), None)]
    sw = torch.clamp_min(wf.abs().amax(dim=tuple(range(w.dim() - 1))), 1e-8) / q
    wq = torch.clamp(torch.round(wf / sw), -q, q)
    return s, wq, sw


def _codes(ctx: Ctx, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    q = float(ctx.int_max)
    return torch.clamp(torch.round(x / s), -q, q)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3(ctx: Ctx, W: dict, name: str, x: torch.Tensor, stride: int = 1,
            site: bool = True) -> torch.Tensor:
    w, b = W[name + ".kernel"], W[name + ".bias"]
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    m = n * ((h - 1) // stride + 1) * ((wd - 1) // stride + 1)
    q = site and _site(ctx, name, "conv3x3", x)
    _count(ctx, "conv3x3", name, 2 * m * 9 * cin * cout,
           x.numel() * (1 if q else 2) + w.numel() * (1 if q else 2) + m * cout * 2, q, x)
    if x.device.type == "meta":
        return _conv(x, w, stride) + b
    if q:
        s, wq, sw = _qscales(ctx, ctx.quant[name], w)
        return _conv(_codes(ctx, x, s), wq, stride) * sw + b
    return _conv(_operand(ctx, x), _operand(ctx, w), stride) + b


def _matmul(ctx: Ctx, name: str, kind: str, x: torch.Tensor, w: torch.Tensor,
            site: bool = True) -> torch.Tensor:
    m = x.numel() // x.shape[-1]
    q = site and _site(ctx, name, kind, x)
    _count(ctx, kind, name, 2 * m * w.shape[0] * w.shape[1],
           (x.numel() + w.numel()) * (1 if q else 2) + m * w.shape[1] * 2, q, x)
    if x.device.type == "meta":
        return x @ w
    if q:
        s, wq, sw = _qscales(ctx, ctx.quant[name], w)
        return (_codes(ctx, x, s) @ wq) * sw
    return _operand(ctx, x) @ _operand(ctx, w)


def conv1x1(ctx: Ctx, W: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return _matmul(ctx, name, "conv1x1", x, W[name + ".kernel"][0, 0]) + W[name + ".bias"]


def dense(ctx: Ctx, W: dict, name: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    y = _matmul(ctx, name, "dense", x, W[name + ".kernel"])
    return y + W[name + ".bias"] if bias else y


def group_norm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               silu: bool) -> torch.Tensor:
    """GroupNorm over groups of 32 channels (one group below 32), then x * scale + shift
    ((C,) or (B, C)), then optionally SiLU."""
    n, h, w, c = x.shape
    g = max(1, c // GN_GROUP)
    xg = x.reshape(n, h * w, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + GN_EPS)).reshape(n, h, w, c)
    if scale.dim() == 2:
        scale, shift = scale[:, None, None, :], shift[:, None, None, :]
    y = y * scale + shift
    return F.silu(y) if silu else y


def gn(W: dict, name: str, x: torch.Tensor, silu: bool) -> torch.Tensor:
    return group_norm(x, W[name + ".scale"], W[name + ".bias"], silu)


def ada_gn(ctx: Ctx, W: dict, name: str, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """Affine-free GroupNorm, FiLM x * (1 + scale) + shift from a linear of the
    conditioning (scale the first half), SiLU."""
    ss = dense(ctx, W, name + ".linear", cond)
    c = x.shape[-1]
    return group_norm(x, 1.0 + ss[:, :c], ss[:, c:], True)


def attention(ctx: Ctx, W: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Spatial self-attention, head size 8; the residual is the normalized input."""
    n, h, w, c = x.shape
    heads = max(1, c // HEAD_DIM)
    hd = c // heads
    x = gn(W, name + ".norm", x, False)
    qkv = conv1x1(ctx, W, name + ".qkv_proj", x).reshape(n, h * w, 3, heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _count(ctx, "attention", name, 4 * n * heads * (h * w) ** 2 * hd,
           4 * n * h * w * c * 2, False, x)
    att = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", _operand(ctx, q), _operand(ctx, k))
                        / math.sqrt(hd), dim=-1)
    y = torch.einsum("nhqk,nkhd->nqhd", _operand(ctx, att), _operand(ctx, v))
    return x + conv1x1(ctx, W, name + ".out_proj", y.reshape(n, h, w, c))


def resblock(ctx: Ctx, W: dict, name: str, x: torch.Tensor, cond: torch.Tensor,
             attn: bool) -> torch.Tensor:
    r = conv1x1(ctx, W, name + ".proj", x) if name + ".proj.kernel" in W else x
    y = conv3x3(ctx, W, name + ".conv1", ada_gn(ctx, W, name + ".norm1", x, cond))
    y = conv3x3(ctx, W, name + ".conv2", ada_gn(ctx, W, name + ".norm2", y, cond))
    y = y + r
    return attention(ctx, W, name + ".attn", y) if attn else y


def resblocks(ctx: Ctx, W: dict, name: str, x: torch.Tensor, cond: torch.Tensor, n: int,
              attn: bool, to_cat: Optional[List[torch.Tensor]] = None):
    outs = []
    for i in range(n):
        if to_cat is not None:
            x = torch.cat([x, to_cat[i]], dim=-1)
        x = resblock(ctx, W, f"{name}.resblocks_{i}", x, cond, attn)
        outs.append(x)
    return x, outs


def unet(ctx: Ctx, W: dict, name: str, cfg: dict, x: torch.Tensor,
         cond: torch.Tensor) -> torch.Tensor:
    depths, attn = cfg["depths"], cfg["attn_depths"]
    levels = len(depths)
    n, h, w, _ = x.shape
    k = 2 ** (levels - 1)
    ph, pw = -h % k, -w % k
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    d_out = []
    for i in range(levels):
        if i > 0:
            x = conv3x3(ctx, W, f"{name}.downsamples_{i}.conv", x, stride=2)
        x_down = x
        x, outs = resblocks(ctx, W, f"{name}.d_blocks_{i}", x, cond, depths[i], bool(attn[i]))
        d_out.append([x_down, *outs])
    x, _ = resblocks(ctx, W, f"{name}.mid_blocks", x, cond, 2, True)
    for j, skip in enumerate(reversed(d_out)):
        i = levels - 1 - j
        if j > 0:
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = conv3x3(ctx, W, f"{name}.upsamples_{j}.conv", x)
        x, _ = resblocks(ctx, W, f"{name}.u_blocks_{j}", x, cond, depths[i] + 1, bool(attn[i]),
                         to_cat=skip[::-1])
    return x[:, :h, :w, :] if (ph or pw) else x


# ---------------------------------------------------------------------------
# The denoiser (EDM preconditioning around the U-Net)


def inner_model(ctx: Ctx, W: dict, cfg: dict, noisy: torch.Tensor, c_noise: torch.Tensor,
                obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """noisy (B, H, W, C), c_noise (B,), obs (B, H, W, T*C) frame-major, act (B, T) ->
    the F-space prediction (B, H, W, C). conv_in is
    never an int8 site (the sampler computes it apart, as the trainer's int8 rollout
    does)."""
    f = 2 * math.pi * c_noise[:, None] * W["noise_emb.weight"]
    cond = torch.cat([torch.cos(f), torch.sin(f)], dim=-1)
    cond = cond + W["act_emb.embedding"][act.long()].reshape(act.shape[0], -1)
    cond = dense(ctx, W, "cond_proj_2", F.silu(dense(ctx, W, "cond_proj_0", cond)))
    x = conv3x3(ctx, W, "conv_in", torch.cat([obs, noisy], dim=-1), site=False)
    x = unet(ctx, W, "unet", cfg, x, cond)
    return conv3x3(ctx, W, "conv_out", gn(W, "norm_out", x, True))


def conditioners(dcfg: dict, sigma: torch.Tensor):
    sigma = torch.sqrt(sigma ** 2 + dcfg["sigma_offset_noise"] ** 2)
    sd2 = dcfg["sigma_data"] ** 2
    c_in = 1.0 / torch.sqrt(sigma ** 2 + sd2)
    c_skip = sd2 / (sigma ** 2 + sd2)
    c_out = sigma * torch.sqrt(c_skip)
    e = lambda v: v[:, None, None, None]  # noqa: E731
    return e(c_in), e(c_out), e(c_skip), torch.log(sigma) / 4


def to_grid(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [-1, 1] and snap down to the 256-level grid of uint8 frames."""
    x = torch.clamp(x, -1.0, 1.0)
    return torch.floor((x + 1) / 2 * 255) / 255 * 2 - 1


def u8_to_float(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 255.0 * 2.0 - 1.0


def denoise(ctx: Ctx, W: dict, dcfg: dict, noisy, sigma, obs, act):
    c_in, c_out, c_skip, c_noise = conditioners(dcfg, sigma)
    out = inner_model(ctx, W, dcfg["inner_model"], noisy * c_in, c_noise,
                      obs / dcfg["sigma_data"], act)
    return to_grid(c_skip * noisy + c_out * out)


def sample_sigma(normal: torch.Tensor, scfg: dict) -> torch.Tensor:
    return torch.clamp(torch.exp(normal * scfg["scale"] + scfg["loc"]), scfg["sigma_min"],
                       scfg["sigma_max"])


def _window_loss(ctx, W, dcfg, scfg, x, cond, act, sigma_n, offset, noise, m, count):
    sigma = sample_sigma(sigma_n, scfg)
    noisy = x + dcfg["sigma_offset_noise"] * offset + noise * sigma[:, None, None, None]
    c_in, c_out, c_skip, c_noise = conditioners(dcfg, sigma)
    out = inner_model(ctx, W, dcfg["inner_model"], noisy * c_in, c_noise,
                      cond / dcfg["sigma_data"], act)
    target = (x - c_skip * noisy) / c_out
    se = ((out - target) ** 2).sum(dim=(1, 2, 3))
    b, h, w, c = x.shape
    loss = (se * m).sum() / torch.clamp_min(count * (h * w * c), 1.0)
    return loss, noisy, out, (c_out, c_skip)


def denoiser_loss(ctx: Ctx, W: dict, dcfg: dict, scfg: dict, obs: torch.Tensor,
                  act: torch.Tensor, mask: torch.Tensor, draws,
                  count_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The autoregressive EDM loss of uint8-grid segments obs (B, T, H, W, C) in [-1, 1]
    over T - n windows; each window after the first conditions on the previous window's
    prediction, snapped to the grid and detached, in place of its last frame. ``draws``
    (sigma (S, B), offset (S, B, 1, 1, C), noise (S, B, H, W, C)) standard normals. Each
    window's mean divides by the count of ``count_mask`` (``mask`` by default): a block
    of rows gives its share of the whole batch's loss."""
    count_mask = mask if count_mask is None else count_mask
    n = dcfg["inner_model"]["num_steps_conditioning"]
    b, t, h, w, c = obs.shape
    frames = list(obs.unbind(1))
    loss = obs.new_zeros(())
    for i in range(t - n):
        cond = torch.stack(frames[i:n + i], dim=3).reshape(b, h, w, n * c)
        m = mask[:, n + i].float()
        li, noisy, out, (c_out, c_skip) = _window_loss(
            ctx, W, dcfg, scfg, frames[n + i], cond, act[:, i:n + i], draws[0][i],
            draws[1][i], draws[2][i], m, count_mask[:, n + i].float().sum())
        loss = loss + li
        frames[n + i] = to_grid(c_skip * noisy + c_out * out.detach())
    return loss / (t - n)


def build_sigmas(scfg: dict) -> List[float]:
    n, lo, hi, rho = scfg["num_steps_denoising"], scfg["sigma_min"], scfg["sigma_max"], scfg["rho"]
    lin = np.linspace(0, 1, n)
    s = (hi ** (1 / rho) + lin * (lo ** (1 / rho) - hi ** (1 / rho))) ** rho
    return [float(v) for v in s] + [0.0]


def sample_frame(ctx: Ctx, W: dict, dcfg: dict, scfg: dict, prev_obs: torch.Tensor,
                 prev_act: torch.Tensor, x_init: torch.Tensor) -> torch.Tensor:
    """Euler sampling (no churn) of the next frame from x_init ~ N(0, 1): prev_obs (B, T,
    H, W, C) float, prev_act (B, T)."""
    b, t, h, w, c = prev_obs.shape
    obs = prev_obs.movedim(1, 3).reshape(b, h, w, t * c)
    sig = build_sigmas(scfg)
    x = x_init
    for s, s_next in zip(sig[:-1], sig[1:]):
        d = (x - denoise(ctx, W, dcfg, x, torch.full((b,), s, device=x.device), obs,
                         prev_act)) / s
        x = x + d * (s_next - s)
    return x


# ---------------------------------------------------------------------------
# The reward/end model and the actor-critic


def lstm_cell(ctx: Ctx, W: dict, name: str, x: torch.Tensor, carry):
    hx, cx = carry
    gates = (_matmul(ctx, name + ".ih", "lstm", x, W[name + ".weight_ih"], site=False)
             + _matmul(ctx, name + ".hh", "lstm", hx, W[name + ".weight_hh"], site=False)
             + W[name + ".bias_ih"] + W[name + ".bias_hh"])
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * cx + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def rew_end_encoder(ctx: Ctx, W: dict, cfg: dict, x: torch.Tensor,
                    cond: torch.Tensor) -> torch.Tensor:
    n = len(cfg["depths"])
    x = conv3x3(ctx, W, "encoder.conv_in", x)
    for i in range(n + 1):
        if 0 < i < n:
            x = conv3x3(ctx, W, f"encoder.downsamples_{i}.conv", x, stride=2)
        depth = cfg["depths"][i] if i < n else 2
        attn = bool(cfg["attn_depths"][i]) if i < n else True
        x, _ = resblocks(ctx, W, f"encoder.blocks_{i}", x, cond, depth, attn)
    return x


def rew_end(ctx: Ctx, W: dict, cfg: dict, obs: torch.Tensor, act: torch.Tensor,
            next_obs: torch.Tensor, carry):
    """obs/next_obs (B, T, H, W, C) float, act (B, T) -> (logits_rew (B, T, 3), logits_end
    (B, T, 2), carry). The LSTM and the head are never int8 sites here."""
    b, t, h, w, c = obs.shape
    x = torch.cat([obs, next_obs], dim=-1).reshape(b * t, h, w, 2 * c)
    cond = W["act_emb.embedding"][act.reshape(b * t).long()]
    x = rew_end_encoder(ctx, W, cfg, x, cond).reshape(b, t, -1)
    hs = []
    for i in range(t):
        carry, hh = lstm_cell(ctx, W, "lstm.cell", x[:, i], carry)
        hs.append(hh)
    hs = torch.stack(hs, dim=1)
    y = dense(ctx, W, "head_2", F.silu(dense(ctx, W, "head_0", hs)), bias=False)
    return y[..., :3], y[..., 3:], carry


def rew_end_loss(ctx: Ctx, W: dict, cfg: dict, obs, act, rew, end, mask, final_obs,
                 has_final_obs, count: Optional[torch.Tensor] = None):
    """The masked cross-entropy of reward classes sign(r) + 1 and ends over the T - 1
    transitions of segments, the true final frame in place of the padding after a death
    where it is known; means over ``count`` (the mask's by default). Returns (loss_rew,
    loss_end)."""
    o, a, nxt = obs[:, :-1], act[:, :-1], obs[:, 1:]
    r, e, m = rew[:, :-1], end[:, :-1].long(), mask[:, :-1].float()
    t = e.shape[1]
    dead = (e.sum(dim=1) > 0) & has_final_obs.bool()
    first = F.one_hot(e.argmax(dim=1), t).bool() & dead[:, None]
    nxt = torch.where(first[:, :, None, None, None], final_obs[:, None], nxt)
    z = obs.new_zeros((obs.shape[0], cfg["lstm_dim"]))
    lr_, le_, _ = rew_end(ctx, W, cfg, o, a, nxt, (z, z))
    denom = torch.clamp_min(m.sum() if count is None else count, 1.0)

    def ce(logits, target):
        nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, target[..., None])[..., 0]
        return (nll * m).sum() / denom

    return ce(lr_, torch.sign(r).long() + 1), ce(le_, e)


def ac_encode(ctx: Ctx, W: dict, cfg: dict, obs: torch.Tensor) -> torch.Tensor:
    x = conv3x3(ctx, W, "encoder.conv_in", obs)
    for i in range(len(cfg["channels"])):
        p = f"encoder.blocks_{i}"
        y = conv3x3(ctx, W, p + ".conv", gn(W, p + ".norm", x, True))
        skip = conv1x1(ctx, W, p + ".skip_projection", x) \
            if p + ".skip_projection.kernel" in W else x
        x = skip + y
        if cfg["down"][i]:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    return x.reshape(x.shape[0], -1)


def ac_head(ctx: Ctx, W: dict, feat: torch.Tensor, carry):
    carry, h = lstm_cell(ctx, W, "lstm", feat, carry)
    return dense(ctx, W, "actor_linear", h), dense(ctx, W, "critic_linear", h)[:, 0], carry


def lambda_returns(rew, end, trunc, val_bootstrap, gamma: float, lam: float):
    rew = torch.sign(rew)
    stop = torch.clamp(end + trunc, max=1.0)
    base = rew + (1 - end) * gamma * ((1 - trunc) * (1 - lam) + trunc) * val_bootstrap
    last = val_bootstrap[:, -1]
    out = []
    for t in reversed(range(rew.shape[1])):
        last = base[:, t] + (1 - stop[:, t]) * gamma * lam * last
        out.append(last)
    return torch.stack(out[::-1], dim=1)


def ac_loss(logits, val, act, rew, end, trunc, val_bootstrap, lcfg: dict):
    """REINFORCE with a value baseline on lambda-returns, plus value and entropy terms.
    Returns (loss, {term: value})."""
    logp = torch.log_softmax(logits, dim=-1)
    entropy = -(logp.exp() * logp).sum(dim=-1).mean()
    ret = lambda_returns(rew, end, trunc, val_bootstrap, lcfg["gamma"], lcfg["lambda_"]).detach()
    lp_act = torch.gather(logp, -1, act[..., None].long())[..., 0]
    l_act = (-lp_act * (ret - val).detach()).mean()
    l_val = lcfg["weight_value_loss"] * ((val - ret) ** 2).mean()
    l_ent = -lcfg["weight_entropy_loss"] * entropy
    return l_act + l_val + l_ent, dict(loss_actions=l_act, loss_values=l_val,
                                       loss_entropy=l_ent)


# ---------------------------------------------------------------------------
# Parameters


def _inner_specs(cfg: dict, actions: bool = True) -> Dict[str, tuple]:
    """name -> (shape, kind, fan_in) of an InnerModel's parameters (without the action
    embedding where ``actions`` is false, as the rew/end model's U-Net has none)."""
    cc, n = cfg["cond_channels"], cfg["num_steps_conditioning"]
    chans, depths = cfg["channels"], cfg["depths"]
    s: Dict[str, tuple] = {}

    def conv(name, cin, cout, k=3):
        s[name + ".kernel"] = ((k, k, cin, cout), "kernel", k * k * cin)
        s[name + ".bias"] = ((cout,), "bias", k * k * cin)

    def dns(name, cin, cout, bias=True):
        s[name + ".kernel"] = ((cin, cout), "kernel", cin)
        if bias:
            s[name + ".bias"] = ((cout,), "bias", cin)

    def norm(name, c):
        s[name + ".scale"] = ((c,), "scale", c)
        s[name + ".bias"] = ((c,), "shift", c)

    def block(name, cin, cout, attn):
        if cin != cout:
            conv(name + ".proj", cin, cout, 1)
        dns(name + ".norm1.linear", cc, 2 * cin)
        conv(name + ".conv1", cin, cout)
        dns(name + ".norm2.linear", cc, 2 * cout)
        conv(name + ".conv2", cout, cout)
        if attn:
            norm(name + ".attn.norm", cout)
            conv(name + ".attn.qkv_proj", cout, 3 * cout, 1)
            conv(name + ".attn.out_proj", cout, cout, 1)

    s["noise_emb.weight"] = ((1, cc // 2), "buffer", 1)
    if actions:
        s["act_emb.embedding"] = ((cfg["num_actions"], cc // n), "embedding", 1)
    dns("cond_proj_0", cc, cc)
    dns("cond_proj_2", cc, cc)
    conv("conv_in", (n + 1) * cfg["img_channels"], chans[0])
    cur, skips = chans[0], []
    for i, (d, ch) in enumerate(zip(depths, chans)):
        if i > 0:
            conv(f"unet.downsamples_{i}.conv", cur, cur)
        ins = [cur] + [ch] * (d - 1)
        for k, ci in enumerate(ins):
            block(f"unet.d_blocks_{i}.resblocks_{k}", ci, ch, bool(cfg["attn_depths"][i]))
        skips.append([cur] + [ch] * d)
        cur = ch
    for k, ci in enumerate([cur, chans[-1]]):
        block(f"unet.mid_blocks.resblocks_{k}", ci, chans[-1], True)
    cur = chans[-1]
    levels = len(chans)
    for j, skip in enumerate(reversed(skips)):
        i = levels - 1 - j
        if j > 0:
            conv(f"unet.upsamples_{j}.conv", cur, cur)
        outs = [chans[i]] * depths[i] + [chans[max(0, i - 1)]]
        for k, (o, sk) in enumerate(zip(outs, skip[::-1])):
            block(f"unet.u_blocks_{j}.resblocks_{k}", cur + sk, o, bool(cfg["attn_depths"][i]))
            cur = o
    norm("norm_out", chans[0])
    conv("conv_out", chans[0], cfg["img_channels"])
    return s


def _rew_end_specs(cfg: dict) -> Dict[str, tuple]:
    cc = cfg["cond_channels"]
    s: Dict[str, tuple] = {}
    inner = _inner_specs(dict(cond_channels=cc, num_steps_conditioning=1,
                              channels=cfg["channels"], depths=cfg["depths"],
                              attn_depths=cfg["attn_depths"], img_channels=1,
                              num_actions=1), actions=False)
    for k, v in inner.items():  # the U-Net's encoder half, renamed; blocks as in the U-Net
        if k.startswith("unet.d_blocks_"):
            s["encoder.blocks_" + k[len("unet.d_blocks_"):]] = v
        elif k.startswith("unet.downsamples_"):
            s["encoder." + k[len("unet."):]] = v
    last = cfg["channels"][-1]
    n = len(cfg["depths"])
    for k, v in inner.items():
        if k.startswith("unet.mid_blocks."):
            s[f"encoder.blocks_{n}." + k[len("unet.mid_blocks."):]] = v
    ci = 2 * cfg["img_channels"]
    s["encoder.conv_in.kernel"] = ((3, 3, ci, cfg["channels"][0]), "kernel", 9 * ci)
    s["encoder.conv_in.bias"] = ((cfg["channels"][0],), "bias", 9 * ci)
    s["act_emb.embedding"] = ((cfg["num_actions"], cc), "embedding", 1)
    feat = cfg["img_size"] // 2 ** (n - 1)
    s.update(_lstm_specs("lstm.cell", last * feat * feat, cfg["lstm_dim"]))
    d = cfg["lstm_dim"]
    s["head_0.kernel"] = ((d, d), "kernel", d)
    s["head_0.bias"] = ((d,), "bias", d)
    s["head_2.kernel"] = ((d, 5), "kernel", d)
    return s


def _lstm_specs(name: str, fin: int, d: int) -> Dict[str, tuple]:
    return {name + ".weight_ih": ((fin, 4 * d), "kernel", fin),
            name + ".weight_hh": ((d, 4 * d), "kernel", d),
            name + ".bias_ih": ((4 * d,), "bias", d),
            name + ".bias_hh": ((4 * d,), "bias", d)}


def _ac_specs(cfg: dict) -> Dict[str, tuple]:
    s: Dict[str, tuple] = {}
    ci, ch = cfg["img_channels"], cfg["channels"]
    s["encoder.conv_in.kernel"] = ((3, 3, ci, ch[0]), "kernel", 9 * ci)
    s["encoder.conv_in.bias"] = ((ch[0],), "bias", 9 * ci)
    cur = ch[0]
    for i, c in enumerate(ch):
        p = f"encoder.blocks_{i}"
        s[p + ".norm.scale"] = ((cur,), "scale", cur)
        s[p + ".norm.bias"] = ((cur,), "shift", cur)
        s[p + ".conv.kernel"] = ((3, 3, cur, c), "kernel", 9 * cur)
        s[p + ".conv.bias"] = ((c,), "bias", 9 * cur)
        if cur != c:
            s[p + ".skip_projection.kernel"] = ((1, 1, cur, c), "kernel", cur)
            s[p + ".skip_projection.bias"] = ((c,), "bias", cur)
        cur = c
    feat = cfg["img_size"] // 2 ** sum(cfg["down"])
    d = cfg["lstm_dim"]
    s.update(_lstm_specs("lstm", cur * feat * feat, d))
    s["actor_linear.kernel"] = ((d, cfg["num_actions"]), "kernel", d)
    s["actor_linear.bias"] = ((cfg["num_actions"],), "bias", d)
    s["critic_linear.kernel"] = ((d, 1), "kernel", d)
    s["critic_linear.bias"] = ((1,), "bias", d)
    return s


def param_specs(model: str, cfg: dict) -> Dict[str, tuple]:
    """name -> (shape, kind, fan_in) of a model's weights: ``model`` is "denoiser",
    "rew_end_model" or "actor_critic", ``cfg`` its section of the
    configuration file. Kind "buffer" is a fixed tensor, not trained."""
    if model == "denoiser":
        return _inner_specs(cfg["inner_model"])
    if model == "rew_end_model":
        return _rew_end_specs(cfg)
    if model == "actor_critic":
        return _ac_specs(cfg)
    raise ValueError(f"unknown model {model!r}")


def decayed(name: str) -> bool:
    """AdamW's weight decay applies to the matrix weights: kernels and LSTM weights."""
    leaf = name.rsplit(".", 1)[-1]
    return leaf == "kernel" or leaf.startswith("weight_")


def make_weights(specs: Dict[str, tuple], generator: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """Every weight from one uniform draw on ``device``: kernels U(+-1/sqrt(fan_in)),
    biases U(+-0.1/sqrt(fan_in)), norm scales 1 + U(+-0.1) and shifts U(+-0.1),
    embeddings and the noise embedding's frequencies N(0, 1) (two uniforms, Box-Muller).
    Nothing is zero: every leaf takes part in the first gradient."""
    sizes = [math.prod(shape) for shape, _, _ in specs.values()]
    u = torch.rand(2 * sum(sizes), generator=generator, device=device)
    out, off = {}, 0
    for (name, (shape, kind, fan_in)), n in zip(specs.items(), sizes):
        a, b = u[off:off + n], u[off + n:off + 2 * n]
        off += 2 * n
        if kind == "kernel":
            v = (2 * a - 1) / math.sqrt(fan_in)
        elif kind == "bias":
            v = (2 * a - 1) * 0.1 / math.sqrt(fan_in)
        elif kind == "scale":
            v = 1 + (2 * a - 1) * 0.1
        elif kind == "shift":
            v = (2 * a - 1) * 0.1
        else:  # embedding, buffer
            v = torch.sqrt(-2 * torch.log(a.clamp_min(1e-12))) * torch.cos(2 * math.pi * b)
        out[name] = v.reshape(shape).contiguous()
    return out
