"""Optimizers implementing the paper's Algorithms 2-5 plus baselines."""
from repro_torch.optim.adamw import AdamWState, adamw
from repro_torch.optim.base import (GivenKey, Optimizer, StepKey, UpdateOps,
                                    init_params_for_policy, leafwise)
from repro_torch.optim.fused import fused_adamw_optimizer, fused_sgd_optimizer
from repro_torch.optim.schedule import (constant, cosine_decay, linear_warmup_cosine,
                                        linear_warmup_linear_decay, step_decay)
from repro_torch.optim.sgd import SGDState, sgd

__all__ = [
    "adamw", "AdamWState", "sgd", "SGDState", "Optimizer", "UpdateOps",
    "StepKey", "GivenKey", "init_params_for_policy", "leafwise",
    "fused_adamw_optimizer", "fused_sgd_optimizer",
    "constant", "cosine_decay", "linear_warmup_cosine",
    "linear_warmup_linear_decay", "step_decay",
]
