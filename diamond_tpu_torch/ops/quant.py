"""The static int8 rollout: calibrated per-input-channel activation scales, folded into
per-output-channel weight scales (diamond_tpu/ops/quant.py).

The scheme: a calibration pass records each site's per-input-channel max |x|
(``act_max``); the activation scale s_c = max(act_max, 1e-8) * ACT_SCALE_HEADROOM / 127
folds into the weight, which is quantized per output channel
(``fold_quantize_weight``); at run time x is quantized with s_c, the product runs on
int8 values with int32 sums, and one f32 rescale by ``w_scale`` follows. Sites are
3x3 convs (``conv3x3_q8_static``, the K5 kernel), 1x1 convs, dense layers and the LSTM
gates (``matmul_q8_static``, the K6 kernel). ``conv3x3_q8``, the dynamic per-tensor-scale
int8 conv of the JAX package, which no path calls, quantizes x with one max pass (K7)
and convolves through K5.

Enablement is structural, as in the JAX package: a site quantizes only when its module
holds a calibrated ``act_scale`` buffer (``install``; with ``w_q``/``w_scale`` beside it
where calibration stashed the weight) AND the call runs inside ``int8_scope(True)``,
which the sampler and the rollout's rew/end step enter and nothing else does. Inside
``calibration_scope`` the sites record instead (``record``, max-merged) and run their
unquantized path. The scopes are context variables set and reset by context managers.

The "quant" collection is a nested dict keyed like the flax variables (module path,
then ``act_scale``/``w_q``/``w_scale``), the form ``registry_to_collection`` returns and
``interop/jax_vars.py`` carries to and from the JAX package. On a module it lives in
non-persistent buffers, so ``state_dict`` stays the parameters alone and ``.to()``
moves the scales with the weights.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .conv3x3_q8 import (ACT_SCALE_HEADROOM, conv3x3_int8, kmajor_weights, refuse_grad,
                         static_scale, true_div)
from .fused_q8 import conv3x3_qtensor
from .matmul_q8 import kmajor_2d, matmul_int8
from .quantize_q8 import absmax_quantize_q8

SITES_ALL = ("conv3x3", "conv1x1", "dense", "lstm")
LEAVES = ("act_scale", "w_q", "w_scale")
# Made from the leaves by ``install``, never part of the collection: a site's K-major
# weight copy, which its int8 kernel reads (conv3x3_q8.kmajor_weights for a 3x3 site,
# matmul_q8.kmajor_2d for a matmul site).
DERIVED = ("w_k",)
# An LSTM site's two gate products, folded by ``install`` from the cell's weights as they
# are then: the input side with its calibrated act_scale, the hidden side with the static
# bound |h| < 1 (``hh_max``, ones). The JAX cell folds both inside its scan body, where
# XLA hoists the loop-invariant fold; here it is made once, not on every step.
LSTM_DERIVED = ("ih_q", "ih_scale", "ih_k", "hh_max", "hh_q", "hh_scale", "hh_k")

_ACTIVE = contextvars.ContextVar("diamond_tpu_torch_int8_active", default=False)
_CALIBRATING = contextvars.ContextVar("diamond_tpu_torch_int8_calibrating", default=None)


@contextlib.contextmanager
def int8_scope(enabled: bool):
    """Mark a region (the sampler's loop, the rollout's rew/end step) as int8 inference."""
    tok = _ACTIVE.set(bool(enabled))
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


@contextlib.contextmanager
def calibration_scope(registry: dict, root: nn.Module):
    """Sites of ``root`` called inside (and inside an int8 scope) record their input
    ranges into ``registry`` under their path in ``root``."""
    paths = {m: tuple(n.split(".")) if n else () for n, m in root.named_modules()}
    tok = _CALIBRATING.set((registry, paths))
    try:
        yield
    finally:
        _CALIBRATING.reset(tok)


def calibrating() -> bool:
    return _CALIBRATING.get() is not None


def recording() -> bool:
    """True where a site should record its input range (and run unquantized)."""
    return _ACTIVE.get() and _CALIBRATING.get() is not None


def quantized(module: nn.Module) -> bool:
    """True where ``module`` (a site) should take its int8 path."""
    return (_ACTIVE.get() and _CALIBRATING.get() is None
            and getattr(module, "act_scale", None) is not None)


def parse_sites(spec) -> frozenset:
    """'all' | comma-separated kinds | sequence of kinds -> frozenset (validated)."""
    if spec is None or spec == "all":
        return frozenset(SITES_ALL)
    names = [s.strip() for s in spec.split(",")] if isinstance(spec, str) else list(spec)
    names = [s for s in names if s]
    unknown = set(names) - set(SITES_ALL)
    if unknown:
        raise ValueError(f"unknown int8 site kind(s) {sorted(unknown)}; "
                         f"valid: {SITES_ALL} or 'all'")
    if not names:
        raise ValueError("empty int8 site selection (use 'all' or a kind list)")
    return frozenset(names)


def record(module: nn.Module, act_max: torch.Tensor, kind: str,
           w: Optional[torch.Tensor] = None) -> None:
    """Max-merge one site's per-input-channel |x| maxima into the active registry, keyed
    ``(*path of module, "act_scale")``. ``w``: the site's weight in its quantization
    layout ((3, 3, Cin, Cout) or (Cin, Cout)); where given, ``registry_to_collection``
    also emits the folded and quantized weight."""
    if kind not in SITES_ALL:
        raise ValueError(f"unknown int8 site kind {kind!r}")
    reg, paths = _CALIBRATING.get()
    key = (*paths[module], "act_scale")
    prev = reg.get(key)
    reg[key] = (kind, act_max if prev is None else torch.maximum(prev[1], act_max),
                (None if w is None else w.detach()) if prev is None else prev[2])


def all_reduce_ranges(registry: dict, dp) -> None:
    """Each site's |x| maxima, max-merged over the data-parallel ranks (``dp``) by one
    all_reduce, in place: every rank then folds the same int8 weights. The registry's
    order (the order the forward met the sites) is the same on every rank."""
    dp.all_reduce_max_flat([v for _, v, _ in registry.values()])


def fold_quantize_weight(w: torch.Tensor, act_max: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the per-input-channel activation scales into ``w`` (..., Cin, Cout) and
    quantize per output channel: (w_q int8, w_scale f32 (Cout,))."""
    s_c = static_scale(act_max)
    wf = w.float() * s_c[(None,) * (w.dim() - 2) + (slice(None), None)]
    sw = true_div(torch.clamp_min(wf.abs().amax(dim=tuple(range(w.dim() - 1))), 1e-8), 127.0)
    wq = torch.clamp(torch.round(wf / sw), -127, 127).to(torch.int8)
    return wq, sw


def registry_to_collection(registry: dict, sites=None) -> dict:
    """{(*path, leaf): (kind, act_max, w)} -> the nested "quant" collection: one
    ``act_scale`` per calibrated site plus ``w_q``/``w_scale`` where the site stashed its
    weight. ``sites``: keep only these kinds (None = all)."""
    out: dict = {}
    for path, (kind, v, w) in registry.items():
        if sites is not None and kind not in sites:
            continue
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = v
        if w is not None:
            node["w_q"], node["w_scale"] = fold_quantize_weight(w, v)
    return out


def conv3x3_q8_static(x: torch.Tensor, w: torch.Tensor, act_max: torch.Tensor,
                      strides: int = 1, w_q: Optional[torch.Tensor] = None,
                      w_scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32,
                      w_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 SAME conv on int8 values with static per-input-channel activation scales.

    x: (B, H, W, Cin) float, or int8 codes already quantized with these scales (the
    output of a quantizing norm); w: (3, 3, Cin, Cout) f32; act_max: (Cin,) f32 from
    calibration. ``w_q``/``w_scale``: the calibration-time fold (else folded here);
    ``w_k``: the kernel's K-major copy of that ``w_q`` (``install`` makes it).
    Returns f32(conv) * w_scale in ``out_dtype``, plus ``bias`` added in ``out_dtype``
    (the JAX package's order: quant.py:187, blocks.py:202, :210). Forward-only: on a
    CUDA tensor under grad mode it refuses inputs that need a gradient."""
    fold = w_q is None or w_scale is None
    if x.is_cuda:
        refuse_grad("conv3x3_q8_static", x, bias, w if fold else None)
    if fold:
        w_q, w_scale, w_k = *fold_quantize_weight(w, act_max), None
    return conv3x3_int8(x, w_q, w_scale, act_max, bias, strides, out_dtype, w_k=w_k)


def matmul_q8_static(x: torch.Tensor, w: torch.Tensor, act_max: torch.Tensor,
                     w_q: Optional[torch.Tensor] = None,
                     w_scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     out_dtype: torch.dtype = torch.float32,
                     w_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Contraction over the last axis on int8 values with static per-input-channel
    scales, the matmul twin of ``conv3x3_q8_static`` (conv1x1, dense and LSTM sites).
    x: (..., Cin); w: (Cin, Cout) f32, or a 1x1 conv's (1, 1, Cin, Cout), read only where
    it is folded here; act_max: (Cin,). ``w_q``/``w_scale``: the calibration-time fold
    (else folded here); ``w_k``: the kernel's K-major copy of that ``w_q`` (``install``
    makes it). Returns f32(x_q @ w_q) * w_scale in ``out_dtype``, plus
    ``bias`` added in ``out_dtype`` (the JAX package's order: quant.py:209, blocks.py:104,
    :109). On a CUDA tensor the product is always K6 (ops/matmul_q8.py). Forward-only: on
    a CUDA tensor under grad mode it refuses inputs that need a gradient."""
    fold = w_q is None or w_scale is None
    if x.is_cuda:
        refuse_grad("matmul_q8_static", x, bias, w if fold else None)
    if fold:
        w_q, w_scale, w_k = *fold_quantize_weight(w.reshape(w.shape[-2:]), act_max), None
    return matmul_int8(x, w_q, w_scale, act_max, bias, out_dtype, w_k=w_k)


def conv3x3_q8(x: torch.Tensor, w: torch.Tensor, strides: int = 1) -> torch.Tensor:
    """3x3 SAME conv on int8 values with a dynamic per-tensor activation scale
    (diamond_tpu/ops/quant.py::conv3x3_q8): sx = max(max |x|, 1e-12) / 127 over the whole
    tensor, per-output-channel weight scales sw = max(max |w| over (kh, kw, Cin), 1e-8) /
    127 of the unfolded weights, int32 sums, y = f32(acc) * (sx * sw). x: (B, H, W, Cin)
    float; w: (3, 3, Cin, Cout). Returns f32 (caller adds bias). On a CUDA tensor x is
    quantized by K7 (ops/quantize_q8.py) and convolved by K5; sx stays on the card.
    Forward-only: on a CUDA tensor under grad mode it refuses inputs that need a
    gradient."""
    if x.is_cuda:
        refuse_grad("conv3x3_q8", x, w)
    return conv3x3_qtensor(absmax_quantize_q8(x), w, strides)


# ---------------------------------------------------------------------------
# The collection on a module tree


def add_site_buffers(module: nn.Module, lstm: bool = False) -> None:
    """Give a quantizable module its (empty, non-persistent) collection buffers, and an
    LSTM cell (``lstm``) those of its folded gate products."""
    for name in LEAVES + DERIVED + (LSTM_DERIVED if lstm else ()):
        module.register_buffer(name, None, persistent=False)


def _sites(root: nn.Module):
    return ((name, m) for name, m in root.named_modules() if "act_scale" in m._buffers)


def strip(root: nn.Module) -> None:
    """Drop every site's collection: the tree runs unquantized again."""
    for _, m in _sites(root):
        for name in LEAVES + DERIVED + LSTM_DERIVED:
            if name in m._buffers:
                setattr(m, name, None)


def _fold_lstm(m: nn.Module) -> None:
    """An LSTM site's folded gate products (LSTM_DERIVED), from its weights as they are."""
    with torch.no_grad():
        m.ih_q, m.ih_scale = fold_quantize_weight(m.weight_ih, m.act_scale)
        m.hh_max = torch.ones(m.weight_hh.shape[0], device=m.weight_hh.device)
        m.hh_q, m.hh_scale = fold_quantize_weight(m.weight_hh, m.hh_max)
        m.ih_k, m.hh_k = kmajor_2d(m.ih_q), kmajor_2d(m.hh_q)


def install(root: nn.Module, collection: dict) -> None:
    """Put a nested "quant" collection (tensors or arrays) into the sites of ``root``,
    after dropping any previous one. Raises on a path that is no site of ``root``."""
    strip(root)

    def walk(node: dict, path: Tuple[str, ...]) -> None:
        leaves = {k: v for k, v in node.items() if not isinstance(v, dict)}
        if leaves:
            m = root.get_submodule(".".join(path))
            if "act_scale" not in m._buffers or set(leaves) - set(LEAVES) \
                    or "act_scale" not in leaves:
                raise ValueError(f"{'.'.join(path)}: no int8 site for leaves {sorted(leaves)}")
            dev = next(m.parameters()).device
            for name, v in leaves.items():
                dtype = torch.int8 if name == "w_q" else torch.float32
                t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
                setattr(m, name, t.to(device=dev, dtype=dtype).contiguous())
            if m.w_q is not None:
                m.w_k = kmajor_weights(m.w_q) if m.w_q.dim() == 4 else kmajor_2d(m.w_q)
            if "hh_q" in m._buffers:
                _fold_lstm(m)
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, (*path, k))

    walk(collection, ())


def collection(root: nn.Module) -> Dict:
    """The nested "quant" collection the sites of ``root`` hold ({} if none)."""
    out: dict = {}
    for name, m in _sites(root):
        if m.act_scale is None:
            continue
        node = out
        for part in name.split("."):
            node = node.setdefault(part, {})
        node.update({leaf: getattr(m, leaf) for leaf in LEAVES if getattr(m, leaf) is not None})
    return out


def folded_from_current_weights(root: nn.Module) -> bool:
    """True where every site's ``w_q``/``w_scale`` is the fold of its weight as it is now
    (a site calibrated before its weight was updated rolls out on the old weight)."""
    for _, m in _sites(root):
        if getattr(m, "hh_q", None) is not None:  # an LSTM site: both folds
            for w, am, wq_, ws_ in ((m.weight_ih, m.act_scale, m.ih_q, m.ih_scale),
                                    (m.weight_hh, m.hh_max, m.hh_q, m.hh_scale)):
                wq, ws = fold_quantize_weight(w, am)
                if not (torch.equal(wq, wq_) and torch.equal(ws, ws_)):
                    return False
        if m.w_q is None or m.act_scale is None:
            continue
        w = m.kernel if m.kernel.dim() == m.w_q.dim() else m.kernel[0, 0]
        wq, ws = fold_quantize_weight(w, m.act_scale)
        if not (torch.equal(wq, m.w_q) and torch.equal(ws, m.w_scale)):
            return False
    return True


def has_collection(root: nn.Module) -> bool:
    return any(m.act_scale is not None for _, m in _sites(root))
