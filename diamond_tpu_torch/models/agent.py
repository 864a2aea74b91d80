"""Agent container: the three models (four with the two-stage world model's upsampler,
``AgentConfig.upsampler``), initialised from a ``torch.Generator``, their snapshot IO
and the optimizer (diamond_tpu/models/agent.py). The models live on the card unless the
caller asks for another device (the CPU tests pass ``device="cpu"``). ``state_dict`` is
the JAX package's variable tree of each model ({"denoiser": {"params": ...,
"constants": ...}, ..., "upsampler": ...}, numpy), without the int8 ``quant``
collection, so ``save``/``load`` read and write the snapshots both packages share
(checkpoint.py). With an upsampler the dynamics denoiser, the rew/end model and the
actor-critic work at the low resolution (``img_size // upsampling_factor``); torch
modules need no frame size to be built, so only the config carries it.

``configure_opt`` is the JAX package's optax chain: global-norm clipping, then AdamW
with the minGPT decay split as a mask on the parameter names (the flax paths) and a
linear warmup from 0; with ``grad_acc_steps`` k > 1 the trainer's ``optax.MultiSteps``
around it (and ``optax.scale(k)`` in front under ``grad_acc_sum``). Under data
parallelism (``dp``) the gradients are summed over the ranks by one all_reduce of each
step's gradient, before the clip (parallel/mesh.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ..config import AgentConfig
from ..parallel.mesh import DataParallel
from .actor_critic import ActorCritic
from .blocks import init_weights
from .denoiser import Denoiser
from .rew_end_model import RewEndModel


MODEL_NAMES = ("denoiser", "rew_end_model", "actor_critic")


class Agent:
    """Parameters are float32; the models compute in ``compute_dtype``. The weights are
    drawn from ``generator`` on the CPU, model by model in ``model_names`` order, then
    moved to ``device``."""

    def __init__(self, cfg: AgentConfig, compute_dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        self.cfg = cfg
        self.denoiser = Denoiser(cfg.denoiser, compute_dtype)
        self.rew_end_model = RewEndModel(cfg.rew_end_model, compute_dtype)
        self.actor_critic = ActorCritic(cfg.actor_critic, compute_dtype)
        self.upsampler = Denoiser(cfg.upsampler, compute_dtype) \
            if cfg.upsampler is not None else None
        if generator is not None:
            for net in self.nets.values():
                init_weights(net, generator)
        for net in self.nets.values():
            net.to(device)

    @property
    def model_names(self) -> tuple:
        return MODEL_NAMES + (("upsampler",) if self.upsampler is not None else ())

    @property
    def nets(self) -> Dict[str, nn.Module]:
        """Model name -> the nn.Module holding its weights (state-dict keys = the flax
        variable paths of the JAX package's model of that name)."""
        nets = {"denoiser": self.denoiser.inner_model, "rew_end_model": self.rew_end_model.net,
                "actor_critic": self.actor_critic.net}
        if self.upsampler is not None:
            nets["upsampler"] = self.upsampler.inner_model
        return nets

    def state_dict(self) -> Dict[str, Any]:
        from ..interop.jax_vars import QUANT, module_to_variables

        out = {}
        for name, net in self.nets.items():
            v = module_to_variables(net)
            v.pop(QUANT, None)
            out[name] = v
        return out

    def load_state_dict(self, sd: Dict[str, Any], names: Optional[Sequence[str]] = None
                        ) -> None:
        """Load the trees of ``names`` (every model by default); a model's int8
        collection is dropped, since it was folded from the weights it had."""
        from ..interop.jax_vars import QUANT, variables_to_state_dict
        from ..ops import quant

        for name in (names if names is not None else self.nets):
            net = self.nets[name]
            v = {k: x for k, x in sd[name].items() if k != QUANT}
            net.load_state_dict(variables_to_state_dict(v), strict=True)
            quant.strip(net)

    def save(self, path: Path) -> None:
        from ..checkpoint import save_agent_snapshot

        save_agent_snapshot(self.state_dict(), path)

    def load(self, path_to_ckpt: Path, load_denoiser: bool = True,
             load_rew_end_model: bool = True, load_actor_critic: bool = True,
             load_upsampler: bool = True) -> None:
        """Load a snapshot's models, those whose flag is set (the upsampler's where the
        agent has one)."""
        from ..checkpoint import load_agent_snapshot

        flags = {"denoiser": load_denoiser, "rew_end_model": load_rew_end_model,
                 "actor_critic": load_actor_critic}
        if self.upsampler is not None:
            flags["upsampler"] = load_upsampler
        self.load_state_dict(load_agent_snapshot(Path(path_to_ckpt)),
                             [n for n, f in flags.items() if f])


# ---------------------------------------------------------------------------
# Optimizer


def decay_mask(name: str) -> bool:
    """Weight-decay exactly the matmul weights (the JAX package's ``_decay_mask``): a
    parameter whose own name is ``kernel`` (conv and linear kernels; embeddings are
    named ``embedding``) or starts with ``weight_`` (the LSTM's). Biases and norm
    affines (``scale``, ``bias``) get no decay."""
    leaf = name.rsplit(".", 1)[-1]
    return leaf == "kernel" or leaf.startswith("weight_")


class AdamWClip:
    """optax.chain(clip_by_global_norm(max_grad_norm), adamw(linear_schedule(0, lr,
    lr_warmup_steps), b1=0.9, b2=0.999, eps, weight_decay, mask=_decay_mask)), built by
    ``configure_opt``: ``init`` makes the torch optimizer of a module (``torch.optim.AdamW``,
    decoupled decay, eps outside the square root, one parameter group with decay and one
    without), ``update`` applies one step of the chain to the gradients in ``.grad``.

    With ``grad_acc_steps`` k > 1 it is ``optax.MultiSteps`` of that chain, as the
    JAX package's trainer builds it (``accumulate``): the micro-gradients' running mean
    (optax's form, acc + (g - acc) / (n + 1)) is kept, every k-th micro-step the chain
    updates the weights with it (with ``grad_acc_sum`` with k times it, the sum, so that
    clipping acts on the sum), and the other micro-steps leave the weights and the AdamW
    moments as they are. The warmup counts the chain's updates, not the micro-steps.

    ``dp`` (data parallelism): each rank's gradients are its share of the global
    gradient (the losses divide by global counts); they are summed over the ranks by one
    flat all_reduce before the clip, so every rank clips and steps on the same gradient.
    Under accumulation each micro-gradient is summed as it comes (k all_reduces an
    update), so that each micro-step's gradient, and the norm it reports, is the global
    one, as it is in the JAX package. ``reduced_bytes``: the bytes the last all_reduce
    summed."""

    def __init__(self, lr: float, weight_decay: float, eps: float,
                 max_grad_norm: Optional[float] = None, lr_warmup_steps: int = 0,
                 grad_acc_steps: int = 1, grad_acc_sum: bool = False,
                 dp: Optional[DataParallel] = None) -> None:
        if grad_acc_steps < 1:
            raise ValueError(f"grad_acc_steps must be at least 1, got {grad_acc_steps}")
        self.lr, self.weight_decay, self.eps = lr, weight_decay, eps
        self.max_grad_norm, self.lr_warmup_steps = max_grad_norm, lr_warmup_steps
        self.grad_acc_steps, self.grad_acc_sum = grad_acc_steps, grad_acc_sum
        self.dp = dp if dp is not None else DataParallel()
        self.reduced_bytes = 0

    def lr_at(self, step: int) -> float:
        """The learning rate of update ``step`` (0-based): optax's linear schedule from 0."""
        if self.lr_warmup_steps > 0:
            return self.lr * min(step, self.lr_warmup_steps) / self.lr_warmup_steps
        return self.lr

    def init(self, net: nn.Module) -> torch.optim.AdamW:
        named = list(net.named_parameters())
        groups = [{"params": [p for n, p in named if decay_mask(n)],
                   "weight_decay": self.weight_decay},
                  {"params": [p for n, p in named if not decay_mask(n)], "weight_decay": 0.0}]
        return torch.optim.AdamW([g for g in groups if g["params"]], lr=self.lr,
                                 betas=(0.9, 0.999), eps=self.eps)

    @staticmethod
    def grads(opt: torch.optim.AdamW) -> List[torch.Tensor]:
        """The parameters' ``.grad``, a zero gradient where a parameter has none (optax
        counts a missing gradient as zero)."""
        params: List[torch.Tensor] = [p for g in opt.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in params]

    @staticmethod
    def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))

    def reduce(self, grads: List[torch.Tensor]) -> None:
        """Sum the gradients over the ranks (``dp``) in place."""
        self.reduced_bytes = self.dp.all_reduce_sum_flat(grads)

    def update(self, opt: torch.optim.AdamW, step: int, reduce: bool = True) -> torch.Tensor:
        """Sum the gradients over the ranks (unless ``reduce`` is False: they were),
        clip them to ``max_grad_norm`` by their global norm, step the optimizer at
        ``lr_at(step)`` and clear the gradients. A parameter without a gradient counts
        as a zero gradient, as in optax. Returns the global norm before clipping, on the
        device; nothing here waits for the device."""
        grads = self.grads(opt)
        if reduce:
            self.reduce(grads)
        norm = self.global_norm(grads)
        if self.max_grad_norm is not None:
            # optax: g where norm < max, else g / norm * max
            scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                                self.max_grad_norm / norm)
            torch._foreach_mul_(grads, scale)
        for g in opt.param_groups:
            g["lr"] = self.lr_at(step)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return norm

    def accumulate(self, opt: torch.optim.AdamW, acc: Optional[List[torch.Tensor]],
                   micro_step: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Micro-step ``micro_step`` (0-based, counted over the whole run) of
        ``optax.MultiSteps``: sum the gradients in ``.grad`` over the ranks, fold them
        into the running mean ``acc`` (zeros where it is None) and clear them; on every
        k-th micro-step update the weights with the mean (times k under
        ``grad_acc_sum``) by ``update`` at the chain's own count, micro_step // k.
        Returns the new running mean (zeros after an update, as optax resets it) and the
        global norm of this micro-step's gradient."""
        k = self.grad_acc_steps
        grads = self.grads(opt)
        self.reduce(grads)
        norm = self.global_norm(grads)
        if acc is None:
            acc = [torch.zeros_like(g) for g in grads]
        n = micro_step % k
        delta = torch._foreach_sub(grads, acc)
        torch._foreach_div_(delta, float(n + 1))
        torch._foreach_add_(acc, delta)
        if n < k - 1:
            opt.zero_grad(set_to_none=True)
            return acc, norm
        params = [p for g in opt.param_groups for p in g["params"]]
        for p, a in zip(params, acc):
            p.grad = a * float(k) if self.grad_acc_sum else a
        self.update(opt, micro_step // k, reduce=False)
        torch._foreach_zero_(acc)
        return acc, norm


def configure_opt(lr: float, weight_decay: float, eps: float,
                  max_grad_norm: Optional[float] = None, lr_warmup_steps: int = 0,
                  grad_acc_steps: int = 1, grad_acc_sum: bool = False,
                  dp: Optional[DataParallel] = None) -> AdamWClip:
    """AdamW with masked weight decay, global-norm clipping and linear LR warmup; with
    ``grad_acc_steps`` > 1, gradient accumulation (``AdamWClip.accumulate``); with a
    data-parallel ``dp``, the gradients summed over its ranks."""
    return AdamWClip(lr, weight_decay, eps, max_grad_norm, lr_warmup_steps, grad_acc_steps,
                     grad_acc_sum, dp)
