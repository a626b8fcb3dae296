from ray_tpu_torch.utils.exploration.exploration import (
    Exploration,
    StochasticSampling,
    exploration_from_config,
)

__all__ = ["Exploration", "StochasticSampling", "exploration_from_config"]
