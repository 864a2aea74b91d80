"""The host-side rollout: ``EnvLoop`` drives the policy over a vector env, ``Collector``
turns its steps into episodes of a Dataset (diamond_tpu/coroutines)."""

from .collector import Collector, NumToCollect
from .env_loop import EnvLoop
