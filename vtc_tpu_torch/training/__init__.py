"""Training: the 4-group optimizer with its schedule, the train and eval
steps (GradCache accumulation too), metrics, checkpoints and the Trainer."""

from .checkpoints import (
    assert_warm_start_keys,
    graft_params,
    load_checkpoint,
    save_checkpoint,
)
from .metrics import METRICS, LossMetric, MetricTracker, RecallAtK, ScalarPerBatchMetric
from .optim import (
    Bf16MomentAdam,
    build_optimizer,
    classify_param,
    is_nodecay,
    make_lr_schedule,
    param_labels,
)
from .step import eval_step, global_truncate_tokens, train_step
from .trainer import Trainer

__all__ = [
    "Bf16MomentAdam",
    "LossMetric",
    "METRICS",
    "MetricTracker",
    "RecallAtK",
    "ScalarPerBatchMetric",
    "Trainer",
    "assert_warm_start_keys",
    "build_optimizer",
    "classify_param",
    "eval_step",
    "global_truncate_tokens",
    "graft_params",
    "is_nodecay",
    "load_checkpoint",
    "make_lr_schedule",
    "param_labels",
    "save_checkpoint",
    "train_step",
]
