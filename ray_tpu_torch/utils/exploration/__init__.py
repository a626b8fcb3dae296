from ray_tpu_torch.utils.exploration.exploration import (
    EpsilonGreedy,
    Exploration,
    StochasticSampling,
    exploration_from_config,
    register_exploration,
)
from ray_tpu_torch.utils.exploration.curiosity import Curiosity  # noqa: E402
from ray_tpu_torch.utils.exploration.rnd import RND  # noqa: E402

__all__ = ["Curiosity", "EpsilonGreedy", "Exploration", "RND", "StochasticSampling",
           "exploration_from_config", "register_exploration"]
