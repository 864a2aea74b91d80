"""The static int8 rollout: calibrated per-input-channel activation scales, folded into
per-output-channel weight scales (diamond_tpu/ops/quant.py).

The scheme: a calibration pass records each site's per-input-channel max |x|
(``act_max``); the activation scale s_c = max(act_max, 1e-8) * ACT_SCALE_HEADROOM / 127
folds into the weight, which is quantized per output channel
(``fold_quantize_weight``); at run time x is quantized with s_c, the product runs on
int8 values with int32 sums, and one f32 rescale by ``w_scale`` follows. Sites are
3x3 convs (``conv3x3_q8_static``, the K5 kernel), 1x1 convs, dense layers and the LSTM
gates (``matmul_q8_static``, a plain product of int8 values).

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

from .conv3x3_q8 import (ACT_SCALE_HEADROOM, conv3x3_int8, quantize_static, static_scale,
                         true_div)

SITES_ALL = ("conv3x3", "conv1x1", "dense", "lstm")
LEAVES = ("act_scale", "w_q", "w_scale")

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
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """3x3 SAME conv on int8 values with static per-input-channel activation scales.

    x: (B, H, W, Cin) float, or int8 codes already quantized with these scales (the
    output of a quantizing norm); w: (3, 3, Cin, Cout) f32; act_max: (Cin,) f32 from
    calibration. ``w_q``/``w_scale``: the calibration-time fold (else folded here).
    Returns f32(conv) * w_scale in ``out_dtype``, plus ``bias`` added in ``out_dtype``
    (the JAX package's order: quant.py:187, blocks.py:202, :210)."""
    if w_q is None or w_scale is None:
        w_q, w_scale = fold_quantize_weight(w, act_max)
    return conv3x3_int8(x, w_q, w_scale, act_max, bias, strides, out_dtype)


def _int_mm_takes(m: int, k: int, n: int) -> bool:
    """The shapes ``torch._int_mm`` takes on the card: more than 16 rows, K and N
    multiples of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def matmul_q8_static(x: torch.Tensor, w: torch.Tensor, act_max: torch.Tensor,
                     w_q: Optional[torch.Tensor] = None,
                     w_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Contraction over the last axis on int8 values with static per-input-channel
    scales, the matmul twin of ``conv3x3_q8_static`` (conv1x1, dense and LSTM sites).
    x: (..., Cin); w: (Cin, Cout) f32; act_max: (Cin,). Returns f32 (caller adds bias).

    The int8 product is ``torch._int_mm`` for a CUDA tensor of a shape it takes, else a
    matmul of the int8 values in float64; both sums are exact."""
    if w_q is None or w_scale is None:
        w_q, w_scale = fold_quantize_weight(w, act_max)
    xq = quantize_static(x, act_max).reshape(-1, x.shape[-1])
    (m, k), n = xq.shape, w_q.shape[-1]
    if xq.is_cuda and _int_mm_takes(m, k, n):
        acc = torch._int_mm(xq, w_q)
    else:
        acc = xq.double() @ w_q.double()
    return (acc.float() * w_scale).reshape(*x.shape[:-1], n)


# ---------------------------------------------------------------------------
# The collection on a module tree


def add_site_buffers(module: nn.Module) -> None:
    """Give a quantizable module its (empty, non-persistent) collection buffers."""
    for name in LEAVES:
        module.register_buffer(name, None, persistent=False)


def _sites(root: nn.Module):
    return ((name, m) for name, m in root.named_modules() if "act_scale" in m._buffers)


def strip(root: nn.Module) -> None:
    """Drop every site's collection: the tree runs unquantized again."""
    for _, m in _sites(root):
        for name in LEAVES:
            setattr(m, name, None)


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


def has_collection(root: nn.Module) -> bool:
    return any(m.act_scale is not None for _, m in _sites(root))
