"""The reference's 4-group Adam/AdamW and its schedules, on ``torch.optim``.

Port of ``vtc_tpu/training/optim.py`` (reference ``train.py:94-192``). The
trainable parameters fall into four groups by name: CLIP's final projections
(``fc_lr``), the time/temporal parameters (``time_lr``), the CAM
(``adapter_lr``) and the rest (the base ``lr``); each group splits into
weight decay and no decay (biases, LayerNorms, embeddings). The parameters
with ``requires_grad=False`` (the branches that the model's ``freeze``
names, which ``create_model`` marks) sit in no group.

The JAX package's ``FusedOptimizer`` defines its semantics as torch's
(``optim.py:277-280``): L2 decay added to the gradient for Adam, decoupled
for AdamW, and amsgrad's running max over the uncorrected second moment. So
``torch.optim.Adam``/``AdamW`` are the counterpart, and the tests hold them
to ``FusedOptimizer`` number for number. The per-step schedule
(``make_lr_schedule``) is a ``LambdaLR`` indexed by the step before the
update, as ``FusedOptimizer`` indexes it by its pre-increment count.

Names are the port's (the reference state dict's): ``model.visual.*``,
``model.transformer.*`` (the text transformer), ``model.text_projection``;
the CAM is ``final_transformer.*``, ``final_linear.*``, ``mask_embedding``
and ``mean_center_bn.*``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models.factory import ADAPTER_PREFIXES, frozen_predicate

FC_NAMES = ("model.text_projection", "model.visual.proj")
TIME_MATCHES = ("time", "temporal")
# bias, LayerNorm (".ln_1.weight", ".ln_final.weight", ...), embeddings
NODECAY_MATCHES = ("bias", ".ln", "embedding", "temporal_embed")
GROUPS = ("rest", "adapter", "fc", "time")


def classify_param(name: str) -> str:
    """-> one of rest/adapter/fc/time (before the decay split)."""
    if name in FC_NAMES:
        return "fc"
    if any(t in name for t in TIME_MATCHES):
        return "time"
    if name.startswith(ADAPTER_PREFIXES):
        return "adapter"
    return "rest"


def is_nodecay(name: str) -> bool:
    # BatchNorm scales and logit_scale match none of these: they decay, as
    # in the reference
    return any(t in name for t in NODECAY_MATCHES)


def param_labels(model: torch.nn.Module, branch_to_freeze=False) -> Dict[str, str]:
    """``{name: '<group>_<decay|nodecay>' or 'frozen'}`` for every parameter,
    with ``branch_to_freeze`` read as a model's ``freeze``."""
    frozen = frozen_predicate(branch_to_freeze)
    labels = {}
    for name, _ in model.named_parameters():
        if frozen(name):
            labels[name] = "frozen"
        else:
            decay = "nodecay" if is_nodecay(name) else "decay"
            labels[name] = f"{classify_param(name)}_{decay}"
    return labels


def make_lr_schedule(lr: float, scheduler_cfg: Optional[dict],
                     steps_per_epoch: int) -> Callable[[int], float]:
    """Per-step lr from the reference's per-epoch scheduler config: StepLR,
    CosineAnnealingLR (periodic, torch's closed form: past ``T_max`` the lr
    rises again, it is not clamped) or a constant."""
    if not scheduler_cfg:
        return lambda step: lr
    stype = scheduler_cfg.get("type", "StepLR")
    args = dict(scheduler_cfg.get("args", {}))
    spe = max(steps_per_epoch, 1)
    if stype == "StepLR":
        step_size = int(args.get("step_size", 10))
        gamma = float(args.get("gamma", 0.1))
        return lambda step: lr * (gamma ** ((step // spe) // step_size))
    if stype in ("ConstantLR", "off", None):
        return lambda step: lr
    if stype == "CosineAnnealingLR":
        t_max = int(args.get("T_max", 10))
        eta_min = float(args.get("eta_min", 0.0))
        return lambda step: eta_min + (lr - eta_min) * (
            1 + math.cos(math.pi * (step // spe) / t_max)) / 2
    raise ValueError(f"Unknown lr_scheduler type {stype!r}")


def build_optimizer(
    model: torch.nn.Module,
    optimizer_cfg: dict,
    scheduler_cfg: Optional[dict] = None,
    steps_per_epoch: int = 1,
    fc_lr: Optional[float] = None,
    time_lr: Optional[float] = None,
    adapter_lr: Optional[float] = None,
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """``(optimizer, scheduler)``: ``torch.optim.Adam`` or ``AdamW`` over the
    4 groups × decay/no-decay (param groups named by ``"name"``), and a
    ``LambdaLR`` to step once per optimizer step. Parameters with
    ``requires_grad=False`` (the frozen ones) join no group."""
    opt_type = optimizer_cfg.get("type", "Adam")
    if opt_type not in ("Adam", "AdamW"):
        raise ValueError(f"Unsupported optimizer type {opt_type!r}")
    args = dict(optimizer_cfg.get("args", {}))
    if args.pop("moments_dtype", None):
        raise NotImplementedError(
            "moments_dtype (narrow optimizer-moment storage) needs its own "
            "multi-tensor update, not ported yet (ROADMAP: Queue 1)"
        )
    base_lr = float(args.get("lr", 1e-3))  # torch.optim.Adam's default
    wd = float(args.get("weight_decay", 0.0) or 0.0)
    group_lr = {
        "rest": base_lr,
        "adapter": adapter_lr if adapter_lr is not None else base_lr,
        "fc": fc_lr if fc_lr is not None else base_lr,
        "time": time_lr if time_lr is not None else base_lr,
    }
    labels = param_labels(model)
    members: Dict[str, List[torch.nn.Parameter]] = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            members.setdefault(labels[name], []).append(p)
    groups, lambdas = [], []
    for group in GROUPS:
        lr = float(group_lr[group])
        schedule = make_lr_schedule(lr, scheduler_cfg, steps_per_epoch)
        for decay in ("decay", "nodecay"):
            params = members.get(f"{group}_{decay}")
            if not params:
                continue
            groups.append({"params": params, "name": f"{group}_{decay}", "lr": lr,
                           "weight_decay": wd if decay == "decay" else 0.0})
            lambdas.append(_factor(schedule, lr))
    kwargs = {
        "betas": tuple(args.get("betas", (0.9, 0.999))),
        "eps": float(args.get("eps", 1e-8)),
        "amsgrad": bool(args.get("amsgrad", False)),
    }
    cls = torch.optim.AdamW if opt_type == "AdamW" else torch.optim.Adam
    optimizer = cls(groups, lr=base_lr, **kwargs)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lambdas)


def _factor(schedule: Callable[[int], float], lr: float) -> Callable[[int], float]:
    """``LambdaLR`` multiplies a group's initial lr by the factor."""
    return lambda step: schedule(step) / lr if lr else 0.0
