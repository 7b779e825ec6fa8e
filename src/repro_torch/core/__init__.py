"""CLOES core: the cascade model, the serving pipeline, the objectives
(`losses`), the trainer, the paper's baselines and the offline metrics."""

from repro_torch.core.cascade import (CascadeConfig, init_params,
                                      params_from_numpy, stage_probs,
                                      pass_probs, final_prob, final_score,
                                      expected_counts_per_query,
                                      hard_cascade_filter)
from repro_torch.core.losses import LossConfig

__all__ = [
    "CascadeConfig", "init_params", "params_from_numpy", "stage_probs",
    "pass_probs", "final_prob", "final_score", "expected_counts_per_query",
    "hard_cascade_filter", "LossConfig",
]
