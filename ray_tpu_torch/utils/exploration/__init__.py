from ray_tpu_torch.utils.exploration.exploration import (
    EpsilonGreedy,
    Exploration,
    StochasticSampling,
    exploration_from_config,
)

__all__ = ["EpsilonGreedy", "Exploration", "StochasticSampling", "exploration_from_config"]
