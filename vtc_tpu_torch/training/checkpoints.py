"""Checkpoint save / load and warm start, the port of
``vtc_tpu/training/checkpoints.py`` on the reference's ``.pth`` layout.

* Format: the reference trainer's (``trainer/base_trainer.py:123-140``, as
  ``vtc_tpu/models/torch_export.py:250-277`` writes it): ``arch``,
  ``epoch``, ``state_dict``, ``monitor_best``, ``config``. The port adds
  ``optimizer`` (its ``state_dict()``) and ``lr_scheduler`` (the schedule's
  ``state_dict()``, whose ``last_epoch`` is the step the JAX package keeps as
  the optimizer's count).
* Names: ``checkpoint-epoch{N}.pth`` and ``model_best.pth``.
* ``load_checkpoint`` reads a ``.pth`` that the port or the JAX package's
  ``save_torch_checkpoint`` wrote; the port's parameter names are the
  reference's, so ``load_state_dict`` takes its ``state_dict`` as is.
* Warm start across architectures (image CAM model -> TimeSformer video
  model) grafts every entry present in both with the same shape and holds
  the reference's key patterns (``base_trainer.py:165-176``).

Reading the JAX package's Orbax directories is not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch


def save_checkpoint(ckpt_dir, name: str, *, arch: str, epoch: int,
                    state_dict: Dict[str, torch.Tensor], optimizer=None,
                    lr_scheduler=None, monitor_best=None, config=None) -> Path:
    """Write ``ckpt_dir/{name}.pth``; ``optimizer`` and ``lr_scheduler`` are
    the objects whose ``state_dict()`` is saved, or ``optimizer`` the state
    dict itself (a tensor-parallel run's, gathered into the single-card
    layout). Tensors are saved on their device; ``load_checkpoint`` maps
    them to the CPU."""
    path = Path(ckpt_dir) / f"{name}.pth"
    payload = {
        "arch": arch,
        "epoch": int(epoch),
        "state_dict": state_dict,
        "monitor_best": float(monitor_best if monitor_best is not None else 0.0),
        "config": dict(config) if config is not None else {},
    }
    if optimizer is not None:
        payload["optimizer"] = optimizer if isinstance(optimizer, dict) \
            else optimizer.state_dict()
    if lr_scheduler is not None:
        payload["lr_scheduler"] = lr_scheduler.state_dict()
    torch.save(payload, path)
    return path


def load_checkpoint(path) -> dict:
    """A ``.pth`` of the reference layout, its tensors on the CPU. Only
    tensors and plain containers are unpickled (``weights_only``). A
    directory (the JAX package's Orbax layout) raises
    ``NotImplementedError`` naming the route to a ``.pth``."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory: the port reads .pth checkpoints, not the JAX "
            "package's Orbax checkpoint directories; convert one with "
            "scripts/export_torch_checkpoint.py, run where JAX is installed")
    return torch.load(path, map_location="cpu", weights_only=True)


def graft_params(init_sd: Dict[str, torch.Tensor], loaded_sd: Dict[str, torch.Tensor],
                 strict: bool = False):
    """Copy every entry of ``loaded_sd`` that ``init_sd`` has into it; return
    ``(state_dict, missing_keys, unexpected_keys)``. ``missing`` = entries the
    model has but the checkpoint lacks (the reference's warm start: they
    must be time/temporal), ``unexpected`` = checkpoint entries the model
    lacks (must be final/mask). A shared entry of another shape raises."""
    missing = sorted(set(init_sd) - set(loaded_sd))
    unexpected = sorted(set(loaded_sd) - set(init_sd))
    if strict and (missing or unexpected):
        raise ValueError(f"missing={missing} unexpected={unexpected}")
    merged = dict(init_sd)
    for k in set(init_sd) & set(loaded_sd):
        if tuple(init_sd[k].shape) != tuple(loaded_sd[k].shape):
            raise ValueError(
                f"shape mismatch for {k}: {tuple(init_sd[k].shape)} vs "
                f"{tuple(loaded_sd[k].shape)}"
            )
        merged[k] = loaded_sd[k]
    return merged, missing, unexpected


def graft_into(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
               strict: bool = False):
    """``graft_params`` of ``state_dict`` into ``model``'s own state, loaded
    into ``model``; returns ``(missing, unexpected)``. With ``strict`` a key
    that either side lacks raises ``ValueError`` and nothing is loaded."""
    merged, missing, unexpected = graft_params(model.state_dict(), state_dict)
    if strict and (missing or unexpected):
        raise ValueError(f"checkpoint keys: missing {missing[:5]}, unexpected {unexpected[:5]}")
    model.load_state_dict(merged)
    return missing, unexpected


def assert_warm_start_keys(missing, unexpected) -> None:
    """``base_trainer.py:175-176``: raises ``AssertionError`` when a missing
    key is not a time/temporal one or an unexpected key not a CAM one."""
    bad_missing = [m for m in missing if "time" not in m and "temporal" not in m]
    if bad_missing:
        raise AssertionError(f"unexpected missing keys: {bad_missing[:5]}")
    bad_unexpected = [u for u in unexpected
                      if "final" not in u and "mask" not in u and "cam" not in u]
    if bad_unexpected:
        raise AssertionError(f"unexpected extra keys: {bad_unexpected[:5]}")


def schedule_step(ckpt: dict) -> Optional[int]:
    """The optimizer steps taken when ``ckpt`` was saved: the schedule's
    ``last_epoch``, or None when the checkpoint holds no schedule."""
    sched = ckpt.get("lr_scheduler")
    return None if sched is None else int(sched["last_epoch"])
