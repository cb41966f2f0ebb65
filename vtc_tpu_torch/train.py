"""Training CLI of the port, the twin of the JAX package's ``train.py``:

    python -m vtc_tpu_torch.train -c configs/pretrained_clip_comments_attention.jsonc \\
        --csv_file posts.csv --root thumbnails/

The same config files, flags and ``;``-path overrides; ``main`` wires the
pieces in ``train.py``'s order (seeds, datasets by name, the two loaders,
``create_model``, the loss with ``loss_args``, the metrics, the 4-group
optimizer) and calls ``Trainer.train()``, on the card unless ``device``
says otherwise. ``VTC_CLIP_WEIGHTS`` names CLIP weights and
``VTC_BPE_VOCAB`` CLIP's merges file, as for the JAX package.

Data parallelism runs one process per card under ``torchrun``:

    torchrun --nproc_per_node N -m vtc_tpu_torch.train -c <config> --n_devices N

trains at the global ``batch_size``, each rank loading and stepping its
``batch_size / N`` rows (``parallel.mesh``); ``--multihost 1`` keeps the
JAX package's meaning, ``batch_size`` per process with each process reading
its slice of the index stream (``DataLoader(shard_by_process=True)``). On
the CPU the group is gloo's. ``--n_devices N`` without a group trains
unsharded with a warning where the machine has fewer than N cards, as the
JAX package does, and raises with the ``torchrun`` line where it has them.

Tensor parallelism adds the model axis under the same launch:

    torchrun --nproc_per_node N·M -m vtc_tpu_torch.train -c <config> \
        --n_devices N --n_model M

lays the ranks out as ``vtc_tpu``'s ``create_mesh(N, M)`` does
(``parallel.mesh``), splits the model over each group of M consecutive
ranks (``parallel.tensor.shard_model``) and steps it at the global
``batch_size``, each data place on its ``batch_size / N`` rows.

ZeRO-3 (``--fsdp 1``, alone or with ``--n_model``) shards the parameters
and the Adam moments over the data axis with FSDP2
(``parallel.mesh.fully_shard_model``), before the optimizer is built; one
process without a group has nothing to shard and trains as without it.

The expert axis (``--ep X``, a MoE arch only) and the pipe axis (``--pp S``
with ``--n_micro``, default 4) take the second axis's place:

    torchrun --nproc_per_node N·X -m vtc_tpu_torch.train \
        -c configs/pretrained_clip_comments_attn_moe.jsonc --n_devices N --ep X
    torchrun --nproc_per_node N·S -m vtc_tpu_torch.train -c <config> \
        --n_devices N --pp S --n_micro 4

``--ep`` splits the MoE expert stacks over each group of X consecutive
ranks (``parallel.expert.shard_experts``); ``--pp`` runs every eligible
block stack as a GPipe pipeline over each group of S (``parallel.stack``),
the whole model on every rank. A MoE model routes over the global batch's
tokens on any mesh. At most one of ``--n_model``, ``--ep``, ``--pp`` and
``--sp`` a run, ``--ep`` only for a MoE arch and ``--slices`` not beside
pp/sp/ep, as ``vtc_tpu``'s ``train.py`` checks. Without a group they warn
and train unsharded where the machine lacks the cards.

What the port cannot do yet raises a ``NotImplementedError`` naming its
ROADMAP item: the grain loader, the sequence and multi-slice axes
(``--sp``, ``--slices``) and ZeRO-3 beside ``--ep`` or ``--pp``.
"""

from __future__ import annotations

import argparse
import functools
import os
import random
import time
from typing import Optional

import numpy as np
import torch

from . import data as module_data
from .config import ConfigParser, CustomArgs
from .data import DataLoader
from .device import resolve_device
from .models import create_model
from .ops.losses import LOSSES
from .parallel.expert import create_ep_mesh, shard_experts
from .parallel.mesh import (
    check_axes,
    check_data_devices,
    create_mesh,
    current_mesh,
    data_world,
    fully_shard_model,
)
from .parallel.pipeline import create_pipeline_mesh
from .parallel.stack import set_stack_parallel
from .parallel.tensor import shard_model
from .training import METRICS, Trainer, build_optimizer
from .utils.util import init_distributed, is_main, launched, world

try:
    import wandb

    _HAS_WANDB = True
except ImportError:
    _HAS_WANDB = False


def _make_probe(config):
    """The per-epoch MSRVTT full-val probe (``trainer/trainer.py:152-182``),
    on when the MSRVTT root (``msrvtt_root``, default ``/data/MSRVTT``)
    holds its metadata: R@10 video to text and text to video of
    ``retrieval_evaluation`` on the trained model, each probe's R@10 and
    seconds logged."""
    root = config.get("msrvtt_root", "/data/MSRVTT")
    if not os.path.exists(os.path.join(root, "train_val_videodatainfo.json")):
        return None

    from .evaluation.retrieval_eval import retrieval_evaluation

    def probe(trainer, branch_override=None):
        tic = time.perf_counter()
        trainer.model.eval()
        table = retrieval_evaluation(trainer.model, "MSRVTT_videos", "full-val",
                                     branch_override=branch_override,
                                     data_roots={"MSRVTT": {"root": root}},
                                     mesh=current_mesh(), device=trainer.device)
        vtt, ttv = table.to_numpy()[table.index.index("R@10")].tolist()
        trainer.logger.info("MSRVTT probe (branch_override %s): R@10 video to text %.4f, "
                            "text to video %.4f, %.3f s", branch_override, vtt, ttv,
                            time.perf_counter() - tic)
        return {"msrvtt_val_vtt": vtt, "msrvtt_val_ttv": ttv}

    return probe


def _check_mesh(config, device: torch.device, logger) -> None:
    """The data axis and one second axis (``--n_model``, ``--ep`` or
    ``--pp``) run under a process group (``--n_devices`` names the data
    axis's size, or is 1) or ``--multihost``'s, laid out on ``device`` by
    ``create_mesh``, ``create_ep_mesh`` or ``create_pipeline_mesh`` (which
    also turns the stacks' pipeline on); ``--fsdp`` shards over its data
    axis; ``check_axes`` raises for the rest. Without a group the axes warn
    and train unsharded where the machine lacks the cards (as the JAX
    package does), and raise with the ``torchrun`` line where it has
    them."""
    if config.get("loader", "threads") == "grain":
        raise NotImplementedError(
            "loader 'grain' is not ported; the port's DataLoader runs thread "
            "workers (ROADMAP: Queue 1 item 10, TPU-era opt-ins)")
    axes = {key: int(config.get(key, 1) or 1) for key in ("n_model", "pp", "sp", "ep", "slices")}
    check_axes(axes["n_model"], pp=axes["pp"], sp=axes["sp"], ep=axes["ep"],
               slices=axes["slices"], fsdp=bool(config.get("fsdp")),
               moe=bool(int(config["arch"]["args"].get("moe_experts", 0) or 0)))
    set_stack_parallel(None)  # the newest run wins over any earlier one in the process
    flag, n_second = next(((f"--{k}", axes[k]) for k in ("ep", "pp") if axes[k] > 1),
                          ("--n_model", axes["n_model"]))
    n_devices = int(config.get("n_devices", config.get("n_gpu", 1)) or 1)
    if config.get("multihost"):
        if world() % n_second or n_devices not in (1, world() // n_second):
            raise ValueError(f"--n_devices {n_devices} {flag} {n_second} with "
                             f"--multihost on {world()} processes: one process per card")
    else:
        check_data_devices(n_devices, device, logger, "training", "vtc_tpu_torch.train",
                           n_second, flag)
    if world() > 1:
        if flag == "--ep":
            create_ep_mesh(world() // n_second, n_second, device=device)
        elif flag == "--pp":
            mesh = create_pipeline_mesh(world() // n_second, n_second, device=device)
            set_stack_parallel("pipe", mesh, int(config.get("n_micro", 4) or 4))
        else:
            create_mesh(world() // n_second, n_second, device=device)
    if not config.get("multihost") and int(config["batch_size"]) % data_world():
        raise ValueError(f"batch_size {config['batch_size']} does not split over "
                         f"{data_world()} data ranks")


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
    # --multihost: batch_size per process, each reading its slice of the
    # index stream; --n_devices: the global batch, each rank its rows
    shard = dict(shard_by_process=True) if config.get("multihost") else dict(
        shard_batches=True)
    data_loader = DataLoader(dataset, batch_size=config["batch_size"],
                             num_workers=num_workers, shuffle=True, drop_last=True,
                             seed=seed_value, **shard)
    valid_data_loader = DataLoader(valid_dataset, batch_size=config["batch_size"],
                                   num_workers=num_workers, shuffle=False, drop_last=True,
                                   **shard)

    arch_cfg = config["arch"]
    model = create_model(arch_cfg["type"], seed=seed_value, device=device,
                         **dict(arch_cfg["args"]))
    shard_model(model)  # over the model axis, where the mesh has one
    shard_experts(model)  # the expert stacks over the expert axis, likewise
    if config.get("fsdp"):  # ZeRO-3 over the data axis, before the optimizer
        fully_shard_model(model, device)
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
    ``main``; in a process that ``torchrun`` started, or with
    ``--multihost``, join the process group first (``init_distributed``).
    A wandb run starts on rank 0 where ``wandb`` is importable; without a
    network, set ``WANDB_MODE=disabled``."""
    if launched():  # torchrun: the group exists before the run dir is picked
        init_distributed()
    args = parser()
    config = ConfigParser.from_args(args, OPTIONS, argv)
    if config.get("multihost"):
        init_distributed()
        config.finalize_run_dir()
    parsed = args.parse_args(argv)
    if _HAS_WANDB and is_main():
        wandb.init(config=parsed)
        wandb.run.name = config["name"]
        wandb.run.save()
    return main(config, device)


if __name__ == "__main__":
    cli()
