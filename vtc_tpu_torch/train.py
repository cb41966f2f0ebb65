"""Training CLI of the port, the twin of the JAX package's ``train.py``:

    python -m vtc_tpu_torch.train -c configs/pretrained_clip_comments_attention.jsonc \\
        --csv_file posts.csv --root thumbnails/

The same config files, flags and ``;``-path overrides; ``main`` wires the
pieces in ``train.py``'s order (seeds, datasets by name, the two loaders,
``create_model``, the loss with ``loss_args``, the metrics, the 4-group
optimizer) and calls ``Trainer.train()``, on the card unless ``device``
says otherwise. ``VTC_CLIP_WEIGHTS`` names CLIP weights and
``VTC_BPE_VOCAB`` CLIP's merges file, as for the JAX package.

What the port cannot do yet raises a ``NotImplementedError`` naming its
ROADMAP item: the grain loader, multihost runs, pipeline, sequence, expert
and multi-slice axes, and a mesh of more than one card on a machine that
has them. Where the JAX package trains unsharded with a warning (fewer
devices than the mesh asks for), the port does the same.
"""

from __future__ import annotations

import argparse
import functools
import os
import random
from typing import Optional

import numpy as np
import torch

from . import data as module_data
from .config import ConfigParser, CustomArgs
from .data import DataLoader
from .device import DISTRIBUTION, resolve_device
from .models import create_model
from .ops.losses import LOSSES
from .training import METRICS, Trainer, build_optimizer

try:
    import wandb

    _HAS_WANDB = True
except ImportError:
    _HAS_WANDB = False


def _make_probe(config):
    """The per-epoch MSRVTT probe stays off while its root is absent; with
    the root present it needs the MSRVTT video dataset, not ported yet
    (``evaluation.retrieval_eval`` is), so it raises before training."""
    root = config.get("msrvtt_root", "/data/MSRVTT")
    if not os.path.exists(os.path.join(root, "train_val_videodatainfo.json")):
        return None
    raise NotImplementedError(
        f"the MSRVTT probe (root {root}) needs the MSRVTT video dataset, not ported yet "
        "(ROADMAP: Queue 1 item 3, the video datasets)")


def _check_mesh(config, device: torch.device, logger) -> None:
    """The port trains on one device: the axes that need distribution raise;
    a data or tensor-parallel mesh warns and trains unsharded where the
    machine lacks the devices (as the JAX package does), and raises where it
    has them."""
    if config.get("loader", "threads") == "grain":
        raise NotImplementedError(
            "loader 'grain' is not ported; the port's DataLoader runs thread "
            "workers (ROADMAP: Queue 1 item 10, TPU-era opt-ins)")
    if config.get("multihost"):
        raise NotImplementedError(f"multihost runs wait for the port of distribution "
                                  f"({DISTRIBUTION})")
    for key in ("pp", "sp", "ep", "slices"):
        if int(config.get(key, 1) or 1) > 1:
            raise NotImplementedError(
                f"--{key} {config[key]}: pipeline, sequence, expert and multi-slice "
                f"axes wait for the port of distribution ({DISTRIBUTION})")
    n_devices = int(config.get("n_devices", config.get("n_gpu", 1)) or 1)
    n_model = int(config.get("n_model", 1) or 1)
    want = n_devices * n_model
    if want <= 1:
        return
    have = torch.cuda.device_count() if device.type == "cuda" else 1
    if have >= want:
        raise NotImplementedError(
            f"a {n_devices}x{n_model} (data x model) mesh on {have} devices: "
            f"sharded training waits for the port of distribution ({DISTRIBUTION})")
    logger.warning(
        "Requested a 1x%dx%d (slices x data x second-axis) mesh but only %d "
        "device(s) are available; training UNSHARDED on one device.",
        n_devices, n_model, have)


def main(config: ConfigParser, device: Optional[str] = None) -> Trainer:
    """Train as ``train.py:main`` does; returns the Trainer after
    ``train()``."""
    device = resolve_device(device)
    seed_value = int(config.get("random_seed_value", 1023))
    os.environ["PYTHONHASHSEED"] = str(seed_value)
    random.seed(seed_value)
    np.random.seed(seed_value)
    torch.manual_seed(seed_value)

    logger = config.get_logger("train")
    _check_mesh(config, device, logger)

    dataset = config.init_obj("dataset", module_data, device=device)
    valid_dataset = config.init_obj("dataset", module_data, train=False, device=device)
    num_workers = config.get("num_workers", 4)
    data_loader = DataLoader(dataset, batch_size=config["batch_size"],
                             num_workers=num_workers, shuffle=True, drop_last=True,
                             seed=seed_value)
    valid_data_loader = DataLoader(valid_dataset, batch_size=config["batch_size"],
                                   num_workers=num_workers, shuffle=False, drop_last=True)

    arch_cfg = config["arch"]
    model = create_model(arch_cfg["type"], seed=seed_value, device=device,
                         **dict(arch_cfg["args"]))
    logger.info("Model: %s", arch_cfg["type"])

    criterion = LOSSES[config["loss"]]
    loss_args = dict(config.get("loss_args") or {})
    if loss_args:
        criterion = functools.partial(criterion, **loss_args)
    metrics = [METRICS[met["type"]](**dict(met["args"])) for met in config["metrics"]]

    optimizer, scheduler = build_optimizer(
        model, config["optimizer"], config.get("lr_scheduler"),
        steps_per_epoch=len(data_loader), fc_lr=config.get("fc_lr"),
        time_lr=config.get("time_lr"), adapter_lr=config.get("adapter_lr"))

    trainer = Trainer(model, criterion, metrics, optimizer, scheduler, config,
                      data_loader, valid_data_loader, seed=seed_value,
                      probe_fn=_make_probe(config), branch_to_adapt_val=None,
                      arch_name=arch_cfg["type"], device=device)
    trainer.train()
    return trainer


OPTIONS = [
    CustomArgs(["--lr", "--learning_rate"], type=float, target="optimizer;args;lr"),
    CustomArgs(["--fc_lr"], type=float, target="fc_lr"),
    CustomArgs(["--time_lr"], type=float, target="time_lr"),
    CustomArgs(["--adapter_lr"], type=float, target="adapter_lr"),
    CustomArgs(["--bs", "--batch_size"], type=int, target="batch_size"),
    CustomArgs(["--n_gpu"], type=int, target="n_gpu"),
    CustomArgs(["--n_devices"], type=int, target="n_devices"),
    CustomArgs(["--n_model"], type=int, target="n_model"),
    CustomArgs(["--fsdp"], type=int, target="fsdp"),
    CustomArgs(["--pp"], type=int, target="pp"),
    CustomArgs(["--sp"], type=int, target="sp"),
    CustomArgs(["--ep"], type=int, target="ep"),
    CustomArgs(["--slices"], type=int, target="slices"),
    CustomArgs(["--n_micro"], type=int, target="n_micro"),
    CustomArgs(["--accum_steps"], type=int, target="trainer;accum_steps"),
    CustomArgs(["--async_checkpoint"], type=int, target="trainer;async_checkpoint"),
    CustomArgs(["--multihost"], type=int, target="multihost"),
    CustomArgs(["--moe_aux_loss_weight"], type=float, target="moe_aux_loss_weight"),
    CustomArgs(["--b", "--branch_to_adapt"], type=str, target="arch;args;branch_to_adapt"),
    CustomArgs(["--bv", "--branch_to_adapt_val"], type=str,
               target="arch;args;branch_to_adapt_val"),
    CustomArgs(["--nc", "--num_comms"], type=int, target="dataset;args;num_comms"),
    CustomArgs(["--nl", "--num_imlabels"], type=int, target="dataset;args;num_imlabels"),
    CustomArgs(["--cached_vision_features"], type=str,
               target="dataset;args;cached_vision_features"),
    CustomArgs(["--add_comments"], type=str, target="dataset;args;add_comments"),
    CustomArgs(["--csv_file"], type=str, target="dataset;args;csv_file"),
    CustomArgs(["--root"], type=str, target="dataset;args;root"),
    CustomArgs(["--e", "--exp_name"], type=str, target="name"),
    CustomArgs(["--freeze"], type=str, target="arch;args;freeze"),
    CustomArgs(["--residual_activation"], type=str, target="arch;args;residual_activation"),
    CustomArgs(["--comment_fusion"], type=str, target="arch;args;comment_fusion"),
    CustomArgs(["--save_dir"], type=str, target="trainer;save_dir"),
    CustomArgs(["--epochs"], type=int, target="trainer;epochs"),
    CustomArgs(["--visual_device"], type=str, target="arch;args;visual_device"),
    CustomArgs(["--random_seed_value"], type=int, target="random_seed_value"),
]


def parser() -> argparse.ArgumentParser:
    args = argparse.ArgumentParser(description="vtc_tpu_torch training")
    args.add_argument("-c", "--config", default=None, type=str,
                      help="config file path (default: None)")
    args.add_argument("-r", "--resume", default=None, type=str,
                      help="path to latest checkpoint (default: None)")
    args.add_argument("-d", "--device", default=None, type=str,
                      help="number of devices (data axis) to use")
    return args


def cli(argv=None, device: Optional[str] = None) -> Trainer:
    """Parse ``argv`` (default: the process's) as ``train.py`` does, then
    ``main``. A wandb run starts where ``wandb`` is importable; without a
    network, set ``WANDB_MODE=disabled``."""
    args = parser()
    config = ConfigParser.from_args(args, OPTIONS, argv)
    parsed = args.parse_args(argv)
    if _HAS_WANDB:
        wandb.init(config=parsed)
        wandb.run.name = config["name"]
        wandb.run.save()
    return main(config, device)


if __name__ == "__main__":
    cli()
