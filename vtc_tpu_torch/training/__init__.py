"""Training: the 4-group optimizer with its schedule, and the train step."""

from .optim import (
    build_optimizer,
    classify_param,
    is_nodecay,
    make_lr_schedule,
    param_labels,
)
from .step import global_truncate_tokens, train_step

__all__ = [
    "build_optimizer",
    "classify_param",
    "global_truncate_tokens",
    "is_nodecay",
    "make_lr_schedule",
    "param_labels",
    "train_step",
]
