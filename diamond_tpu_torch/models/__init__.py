from .actor_critic import ActorCritic, ActorCriticNet, ActorCriticOutput
from .agent import Agent
from .denoiser import (Conditioners, Denoiser, DenoiserDraws, downsample_avg,
                       quantize_to_uint8_grid, upsample_frame)
from .diffusion_sampler import DiffusionSampler, TwoStageSampler, build_sigmas
from .inner_model import InnerModel
from .rew_end_model import RewEndModel, RewEndNet
