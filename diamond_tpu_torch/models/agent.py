"""Agent container: the three models, initialised from a ``torch.Generator``
(diamond_tpu/models/agent.py without optimizers and checkpoint IO, which come with the
training slice). The models live on the card unless the caller asks for another
device (the CPU tests pass ``device="cpu"``)."""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from ..config import AgentConfig
from .actor_critic import ActorCritic
from .blocks import init_weights
from .denoiser import Denoiser
from .rew_end_model import RewEndModel


class Agent:
    """Parameters are float32; the models compute in ``compute_dtype``. The weights are
    drawn from ``generator`` on the CPU, then moved to ``device``."""

    def __init__(self, cfg: AgentConfig, compute_dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        self.cfg = cfg
        self.denoiser = Denoiser(cfg.denoiser, compute_dtype)
        self.rew_end_model = RewEndModel(cfg.rew_end_model, compute_dtype)
        self.actor_critic = ActorCritic(cfg.actor_critic, compute_dtype)
        if generator is not None:
            for net in self.nets.values():
                init_weights(net, generator)
        for net in self.nets.values():
            net.to(device)

    @property
    def nets(self) -> Dict[str, nn.Module]:
        """Model name -> the nn.Module holding its weights (state-dict keys = the flax
        variable paths of the JAX package's model of that name)."""
        return {"denoiser": self.denoiser.inner_model, "rew_end_model": self.rew_end_model.net,
                "actor_critic": self.actor_critic.net}
