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
to ``FusedOptimizer`` number for number. With ``moments_dtype="bfloat16"``
(``optim.py:298``) the moments are stored in bf16 and the update is
``Bf16MomentAdam``, ``FusedOptimizer._leaf``'s arithmetic in fp32. The
per-step schedule (``make_lr_schedule``) is a ``LambdaLR`` indexed by the
step before the update, as ``FusedOptimizer`` indexes it by its
pre-increment count.

A parameter of a group that took no gradient in a step (``final_linear``
beside ``init_from_avg``, whose output the adapter never reads) is stepped
as if its gradient were zero, as ``FusedOptimizer`` steps every leaf it
holds: its moments decay, its count advances, and under weight decay the
decay moves it. ``torch.optim`` would skip it; ``Adam``, ``AdamW`` and
``Bf16MomentAdam`` here give it a zero gradient for the update, after the
step's pre-hooks (which still see ``None``), and take it away after. A
parameter with ``requires_grad=False`` sits in no group and is left alone.

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
# optimizer.args.moments_dtype: the moments' storage
MOMENT_DTYPES = {None: torch.float32, "float32": torch.float32,
                 "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")


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
    4 groups × decay/no-decay (param groups named by ``"name"``), or
    ``Bf16MomentAdam`` where ``args.moments_dtype`` is bf16, and a
    ``LambdaLR`` to step once per optimizer step. Parameters with
    ``requires_grad=False`` (the frozen ones) join no group."""
    opt_type = optimizer_cfg.get("type", "Adam")
    if opt_type not in ("Adam", "AdamW"):
        raise ValueError(f"Unsupported optimizer type {opt_type!r}")
    args = dict(optimizer_cfg.get("args", {}))
    moments_dtype = args.pop("moments_dtype", None)
    if moments_dtype not in MOMENT_DTYPES:
        raise ValueError(f"Unsupported moments_dtype {moments_dtype!r}; expected "
                         f"one of {sorted(k for k in MOMENT_DTYPES if k)}")
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
    if MOMENT_DTYPES[moments_dtype] == torch.bfloat16:
        optimizer = Bf16MomentAdam(groups, lr=base_lr, decoupled=opt_type == "AdamW",
                                   **kwargs)
    else:
        cls = AdamW if opt_type == "AdamW" else Adam
        optimizer = cls(groups, lr=base_lr, **kwargs)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lambdas)


class _ZeroGradients:
    """Within the block, every parameter of ``optimizer``'s groups that has
    no gradient holds a zero one; after it, ``None`` again."""

    def __init__(self, optimizer):
        self.filled = [p for g in optimizer.param_groups for p in g["params"]
                       if p.requires_grad and p.grad is None]

    def __enter__(self):
        for p in self.filled:
            p.grad = torch.zeros_like(p)

    def __exit__(self, *exc):
        for p in self.filled:
            p.grad = None


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` that steps a parameter without a gradient as
    one with a zero gradient (the module docstring)."""

    def step(self, closure=None):
        with _ZeroGradients(self):
            return super().step(closure)


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` that steps a parameter without a gradient as
    one with a zero gradient (the module docstring)."""

    def step(self, closure=None):
        with _ZeroGradients(self):
            return super().step(closure)


def _factor(schedule: Callable[[int], float], lr: float) -> Callable[[int], float]:
    """``LambdaLR`` multiplies a group's initial lr by the factor."""
    return lambda step: schedule(step) / lr if lr else 0.0


class Bf16MomentAdam(torch.optim.Optimizer):
    """Adam/AdamW with the moments stored in bf16: the counterpart of
    ``FusedOptimizer(moments_dtype="bfloat16")`` (``_leaf``,
    ``vtc_tpu/training/optim.py:340-366``). Per group, in fp32 over its
    tensors (``torch._foreach_*``): load and cast the moments up, update
    them, take this step's update from the unrounded fp32 moments, and cast
    them down to bf16 (round to nearest even) at the store; a ZeRO-3 shard
(``DTensor``) updates its local part, since every operation is
elementwise. Decay is added
    to the gradient (Adam) or to the update as ``upd + wd·p`` (AdamW);
    amsgrad keeps the running max of the uncorrected second moment. The
    state's names are ``torch.optim.Adam``'s."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, amsgrad=False, decoupled=False):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps,
                        weight_decay=weight_decay, amsgrad=amsgrad,
                        decoupled=decoupled)
        super().__init__(params, defaults)

    def load_state_dict(self, state_dict):
        """``Optimizer.load_state_dict`` casts the state to the parameters'
        dtype; the moments go back to bf16 (exact for bf16 values)."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            for key in MOMENTS:
                if key in state:
                    state[key] = state[key].to(torch.bfloat16)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        with _ZeroGradients(self):
            for group in self.param_groups:
                params = [p for p in group["params"] if p.grad is not None]
                if params:
                    self._update(group, params)
        return loss

    def _update(self, group, params):
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        amsgrad = group["amsgrad"]
        states = []
        for p in params:
            state = self.state[p]
            if not state:
                state["step"] = torch.tensor(0.0)
                for key in MOMENTS[: 3 if amsgrad else 2]:
                    state[key] = torch.zeros_like(p, dtype=torch.bfloat16)
            states.append(state)
        # each tensor's count, as torch.optim.Adam's; the bias corrections
        # in fp32, as FusedOptimizer computes them
        counts = []
        for state in states:
            state["step"] += 1
            counts.append(state["step"])
        counts = torch.stack(counts).float()
        bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** counts).tolist()
        sqrt_bc2 = torch.sqrt(1 - torch.tensor(b2, dtype=torch.float32) ** counts).tolist()

        # elementwise throughout: ZeRO-3's shards update on their own
        g = [_local(p.grad).float() for p in params]
        params = [_local(p) for p in params]
        moments = {key: [_local(s[key]) for s in states] for key in MOMENTS if key in states[0]}
        p32 = [p.float() for p in params]
        if wd and not group["decoupled"]:
            g = torch._foreach_add(g, torch._foreach_mul(p32, wd))
        m = _fp32(moments["exp_avg"])
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        v = _fp32(moments["exp_avg_sq"])
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        if amsgrad:
            vm = _fp32(moments["max_exp_avg_sq"])
            torch._foreach_maximum_(vm, v)
            denom = torch._foreach_sqrt(vm)
        else:
            denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, sqrt_bc2)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        if wd and group["decoupled"]:
            torch._foreach_add_(upd, torch._foreach_mul(p32, wd))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, [u.to(p.dtype) for u, p in zip(upd, params)])
        # the stores round to bf16 (nearest even), one multi-tensor copy each
        torch._foreach_copy_(moments["exp_avg"], m)
        torch._foreach_copy_(moments["exp_avg_sq"], v)
        if amsgrad:
            torch._foreach_copy_(moments["max_exp_avg_sq"], vm)


def _local(t):
    """This rank's shard of a ``DTensor`` (ZeRO-3, ``parallel.mesh.
    fully_shard_model``), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _fp32(tensors):
    """fp32 copies of a list of tensors, in one multi-tensor copy."""
    out = [torch.empty_like(t, dtype=torch.float32) for t in tensors]
    torch._foreach_copy_(out, tensors)
    return out
