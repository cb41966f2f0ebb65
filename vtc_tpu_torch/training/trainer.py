"""Trainer: the epoch loop with the reference's monitor / early-stop /
checkpoint semantics (``trainer/base_trainer.py:9-219``,
``trainer/trainer.py:56-186``), the port of ``vtc_tpu/training/trainer.py:
356-900``.

* Each step is ``step.train_step`` (``trainer.accum_steps`` > 1: the exact
  GradCache accumulation) on batches that ``data.loader.prefetch_to_device``
  has put on the card ahead of it, token arrays cut to one EOT bucket.
* One step stays in flight: step N's loss is read (``.item()``) only after
  step N+1 has been dispatched, so the host does not wait on the card at
  every step.
* The random draws (adapter skip, comment masking) come from a generator
  seeded per step from ``(seed, (epoch − 1)·fold_stride + batch_idx)``, so a
  run is reproducible and a resumed run draws what the first would have.
* Validation runs the model in eval mode without a graph, on
  ``branch_to_adapt_val``; ``RecallAtK`` ranks the epoch's features.
* Checkpoints are the reference's ``.pth`` (``training.checkpoints``);
  resume restores the epoch pointer, ``monitor_best``, the parameters (held
  to the warm-start key patterns), the optimizer state unless its type or
  lr changed, and the schedule's step.
* ``trainer.profile_dir`` writes a ``torch.profiler`` trace of epoch 1.
* Under a process group (``torchrun``) the model steps inside
  ``DistributedDataParallel`` (``parallel.mesh.data_parallel``) on this
  rank's rows, the token bucket is the ranks' common one, and validation
  runs each rank's rows and merges them (``step.eval_step`` gathers the
  features, so the loss and ``RecallAtK`` are the global batch's). Every
  rank therefore holds the same log, ``monitor_best`` and early stop; only
  rank 0 logs below a warning, writes TensorBoard, the profiler trace and
  the ``.pth`` files, which have a single card's keys (the module's state
  dict). Every rank resumes from the same checkpoint. A model split over
  the model axis (``parallel.tensor``) gathers its parameters and Adam
  moments into the single-card layout before rank 0 writes them, and
  takes its part of them on resume.
* ``fsdp`` in the config (ZeRO-3, as ``vtc_tpu``'s ``Trainer`` reads it)
  takes a model that ``parallel.mesh.fully_shard_model`` sharded over the
  data axis before its optimizer was built (``train.main`` does both). Its
  checkpoints are gathered into the single-card ``.pth`` on every rank, as
  the model axis's; a single-card checkpoint resumes into the shards, and
  an fsdp run's into a single card. Validation runs every rank on its rows
  of the same global batches, so every rank runs the same forwards; the
  probe's strided split runs on the gathered parameters
  (``parallel.mesh.gathered_parameters``).

The loader's epoch counter is not restored on resume, as in the JAX package:
a resumed run's first shuffle is that of ``seed + 1``.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..data.loader import prefetch_to_device
from ..device import resolve_device
from ..parallel.mesh import active, data_parallel, is_fully_sharded
from ..parallel.tensor import (
    full_optimizer_state,
    full_state_dict,
    full_tensors,
    load_full_state_dict,
    split_optimizer_state,
)
from ..utils import TensorboardWriter, inf_loop, is_image_like_batch
from ..utils.util import barrier, is_main, world
from .checkpoints import (
    assert_warm_start_keys,
    graft_params,
    load_checkpoint,
    save_checkpoint,
    schedule_step,
)
from .metrics import LossMetric, MetricTracker
from .step import MOE_AUX_LOSS_WEIGHT, eval_step, global_truncate_tokens, train_step

try:  # optional third sink (reference logs to wandb, trainer/trainer.py:92,120)
    import wandb as _wandb
except ImportError:  # pragma: no cover
    _wandb = None

logger = logging.getLogger(__name__)


def _wandb_log(payload: dict) -> None:
    if _wandb is not None and getattr(_wandb, "run", None) is not None:
        _wandb.log(payload)


def flatten_data(data):
    """Flatten one level of tuple nesting (the audio-with-comments case,
    ``dataset_loaders.py:1039``)."""
    flat = []
    for d in data:
        if isinstance(d, (tuple, list)):
            flat.extend(d)
        else:
            flat.append(d)
    return tuple(flat)


def step_seed(seed: int, index: int) -> int:
    """The seed of step ``index``'s generator: JAX's ``fold_in(seed, index)``
    made with numpy's ``SeedSequence``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


class Trainer:
    """Reference Trainer + BaseTrainer merged. ``model`` is moved to
    ``device`` (default: the card; raises without one); ``optimizer`` and
    ``scheduler`` are ``build_optimizer``'s over its parameters."""

    def __init__(
        self,
        model: torch.nn.Module,
        criterion: Callable,
        metrics,
        optimizer,
        scheduler,
        config,
        data_loader,
        valid_data_loader=None,
        len_epoch: Optional[int] = None,
        seed: int = 1023,
        probe_fn: Optional[Callable] = None,
        branch_to_adapt_val: Optional[str] = None,
        arch_name: str = "model",
        device=None,
    ):
        self.device = resolve_device(device)
        self.fsdp = bool(config.get("fsdp", False))
        if self.fsdp and active() and not is_fully_sharded(model):
            raise ValueError("fsdp: shard the model with parallel.mesh.fully_shard_model "
                             "before its optimizer is built")
        self.model = model.to(self.device)
        # the step's model: DistributedDataParallel under a process group
        self.ddp = data_parallel(self.model, self.device)
        self.criterion = criterion
        self.metrics = metrics
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.config = config
        self.seed = seed
        self.probe_fn = probe_fn
        self.branch_to_adapt_val = branch_to_adapt_val
        self.arch_name = arch_name

        cfg_trainer = config["trainer"]
        self.epochs = cfg_trainer["epochs"]
        self.save_period = cfg_trainer.get("save_period", 1)
        self.accum_steps = int(cfg_trainer.get("accum_steps", 1))
        # the MoE load-balance weight (read only where the model has MoE layers)
        self.moe_aux_loss_weight = float(config.get("moe_aux_loss_weight",
                                                    MOE_AUX_LOSS_WEIGHT))
        self.profile_dir = cfg_trainer.get("profile_dir")
        self.monitor = cfg_trainer.get("monitor", "off")
        self.checkpoint_dir = config.save_dir
        self.logger = (
            config.get_logger("trainer", cfg_trainer.get("verbosity", 2))
            if hasattr(config, "get_logger")
            else logger
        )

        if self.monitor == "off":
            self.mnt_mode = "off"
            self.mnt_best = 0
        else:
            self.mnt_mode, self.mnt_metric = self.monitor.split()
            if self.mnt_mode not in ("min", "max"):
                raise ValueError(f"monitor mode {self.mnt_mode!r}: expected min or max")
            self.mnt_best = np.inf if self.mnt_mode == "min" else -np.inf
            self.early_stop = cfg_trainer.get("early_stop", np.inf)
            if self.early_stop <= 0:
                self.early_stop = np.inf

        self.start_epoch = 1
        self.tensorboard = bool(cfg_trainer.get("tensorboard", False))
        self.writer = TensorboardWriter(
            config.log_dir if hasattr(config, "log_dir") else ".",
            self.logger,
            self.tensorboard and is_main(),
        )

        self.data_loader = data_loader
        self._persistent_batches = None
        self._inf_mode = len_epoch is not None
        if len_epoch is None:
            self.len_epoch = len(data_loader)
        else:
            self.data_loader = inf_loop(data_loader)
            self.len_epoch = len_epoch
        self.valid_data_loader = valid_data_loader
        self.do_validation = valid_data_loader is not None
        self.log_step = max(int(np.sqrt(getattr(data_loader, "batch_size", 32))), 1)

        self.train_metrics = MetricTracker(*[m for m in metrics if m.is_train])
        self.train_metrics.add_metric(LossMetric())
        self.train_metrics.set_writer(self.writer)
        self.valid_metrics = MetricTracker(*[m for m in metrics if m.is_val])
        self.valid_metrics.add_metric(LossMetric())
        self.valid_metrics.set_writer(self.writer)

        if getattr(config, "resume", None) is not None:
            self._resume_checkpoint(config.resume)

    # ------------------------------------------------------------------ #

    def _batches(self, loader, truncate: bool = True):
        """Batches on the device, put there up to 2 ahead of their step.
        Training cuts the token arrays to one EOT bucket (exact for the
        causal, EOT-pooled text tower); the meta keeps its arrays."""

        def gen():
            for *data, meta in loader:
                data = flatten_data(data)
                if truncate:
                    data = tuple(global_truncate_tokens(data, multihost=world() > 1))
                yield data, {k: v for k, v in meta.items() if hasattr(v, "shape")}

        yield from prefetch_to_device(gen(), self.device, size=2)

    def _step_generator(self, index: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(step_seed(self.seed, index))

    def _train_epoch(self, epoch: int) -> dict:
        self.model.train()
        self.train_metrics.reset()
        batch_tic = time.time()
        hz_list = []

        profiler = None
        if self.profile_dir and epoch == 1 and is_main():
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()

        # one step in flight: step N's loss is read only after step N+1 has
        # been dispatched; each batch is still flushed on its own
        pending = None  # (batch_idx, loss_dev, out, meta, batch_size, grid)

        def _flush(entry):
            nonlocal batch_tic, hz_list
            b_idx, loss_dev, out, meta_f, bsz, grid = entry
            loss = loss_dev.item()
            self.writer.set_step((epoch - 1) * self.len_epoch + b_idx)
            self.train_metrics.update(loss, out, meta_f)
            toc = time.time() - batch_tic
            hz = bsz / toc
            hz_list = (hz_list + [hz])[-1000:]
            batch_tic = time.time()
            if b_idx % self.log_step == 0:
                _wandb_log({"loss": loss})
                self.logger.debug(
                    "Train Epoch: %d [%d/%d] Loss: %.6f Speed: %.2fHz (av %.2fHz)",
                    epoch, b_idx, self.len_epoch, loss,
                    hz, float(np.mean(hz_list[-500:])),
                )
                if grid is not None:
                    self.writer.add_image("input", make_grid(grid, nrow=8))

        # in len_epoch (inf_loop) mode the prefetch chain persists across
        # epochs: rebuilding it would drop its buffered batches of the
        # shared endless stream at every boundary
        if self._inf_mode:
            if self._persistent_batches is None:
                self._persistent_batches = self._batches(self.data_loader)
            batch_iter = self._persistent_batches
        else:
            batch_iter = self._batches(self.data_loader)

        # in len_epoch mode an epoch runs len_epoch + 1 batches (the break
        # below keeps the reference's batch_idx == len_epoch quirk), so the
        # stride is len_epoch + 1 and no two steps share a seed
        fold_stride = self.len_epoch + 1 if self._inf_mode else self.len_epoch
        for batch_idx, (data, meta) in enumerate(batch_iter):
            batch_size = data[0].shape[0]
            generator = self._step_generator((epoch - 1) * fold_stride + batch_idx)
            loss, out = train_step(self.ddp, self.criterion, self.optimizer,
                                   self.scheduler, data, meta, generator,
                                   accum_steps=self.accum_steps,
                                   moe_aux_loss_weight=self.moe_aux_loss_weight)
            grid = None
            if (batch_idx % self.log_step == 0 and self.writer.writer is not None
                    and is_image_like_batch(data[0])):
                grid = data[0].cpu().numpy()
            if pending is not None:
                _flush(pending)
            pending = (batch_idx, loss, out, meta, batch_size, grid)
            if batch_idx == self.len_epoch:
                break
        if pending is not None:
            _flush(pending)

        if profiler is not None:
            profiler.stop()
            Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
            trace = Path(self.profile_dir) / "trace.json"
            profiler.export_chrome_trace(str(trace))
            self.logger.info("Wrote profiler trace to %s", trace)

        log = self.train_metrics.result()

        if self.do_validation:
            val_log = self._valid_epoch(epoch)
            log.update(**{"val_" + k: v for k, v in val_log.items()})
            _wandb_log({"val_" + k: v for k, v in val_log.items()})
        return log

    def _valid_epoch(self, epoch: int) -> dict:
        self.logger.debug("Starting validation")
        self.valid_metrics.reset()
        n_batches = 0
        for batch_idx, (data, meta) in enumerate(
                self._batches(self.valid_data_loader, truncate=False)):
            loss, out = eval_step(self.model, self.criterion, data, meta,
                                  branch_override=self.branch_to_adapt_val)
            self.writer.set_step(
                (epoch - 1) * len(self.valid_data_loader) + batch_idx, "valid"
            )
            self.valid_metrics.update(loss.item(), out, meta)
            n_batches += 1
        if n_batches == 0:
            # a drop_last validation loader with fewer items than a batch
            # yields nothing: the val metrics come back empty and monitoring
            # turns off downstream, so name the root cause
            n_items = len(getattr(self.valid_data_loader, "dataset", []))
            self.logger.warning(
                "Validation loader yielded ZERO batches (val dataset of %s "
                "items: smaller than batch_size, so drop_last discards "
                "everything): val metrics are empty and monitoring will be "
                "disabled. Reduce batch_size or grow the validation split.",
                n_items,
            )

        # per-epoch retrieval probe, normal + adapter-skip
        # (trainer/trainer.py:152-182)
        if self.probe_fn is not None:
            try:
                probe = self.probe_fn(self, branch_override=None)
                for k, v in probe.items():
                    self.writer.add_scalar(f"probe_{k}", v)
                probe_skip = self.probe_fn(self, branch_override="skip")
                for k, v in probe_skip.items():
                    self.writer.add_scalar(f"probe_skipadapt_{k}", v)
            except FileNotFoundError as e:
                self.logger.warning("Skipping retrieval probe: %s", e)
                self.probe_fn = None

        # per-parameter histograms (trainer/trainer.py:185-186) of the
        # single-card parameters: ZeRO-3's shards and the model axis's parts
        # are gathered on every rank (collectives), rank 0 writes
        if self.tensorboard:
            params = full_tensors(self.model, {n: p.detach()
                                               for n, p in self.model.named_parameters()})
            if self.writer.writer is not None:
                for name, p in params.items():
                    self.writer.add_histogram(name, p.cpu().numpy(), bins="auto")

        return self.valid_metrics.result()

    # ------------------------------------------------------------------ #

    def train(self) -> dict:
        not_improved_count = 0
        log: dict = {}
        for epoch in range(self.start_epoch, self.epochs + 1):
            result = self._train_epoch(epoch)
            log = {"epoch": epoch}
            log.update(result)

            for key, value in log.items():
                self.logger.info("    %15s: %s", str(key), value)

            best = False
            if self.mnt_mode != "off":
                try:
                    improved = (
                        self.mnt_mode == "min"
                        and log[self.mnt_metric] <= self.mnt_best
                    ) or (
                        self.mnt_mode == "max"
                        and log[self.mnt_metric] >= self.mnt_best
                    )
                except KeyError:
                    self.logger.warning(
                        "Metric '%s' not found; disabling monitoring.",
                        self.mnt_metric,
                    )
                    self.mnt_mode = "off"
                    improved = False

                if improved:
                    self.mnt_best = log[self.mnt_metric]
                    not_improved_count = 0
                    best = True
                else:
                    not_improved_count += 1

                if not_improved_count > self.early_stop:
                    self.logger.info(
                        "Validation performance didn't improve for %s epochs. "
                        "Training stops.", self.early_stop,
                    )
                    break

            if epoch % self.save_period == 0:
                self._save_checkpoint(epoch, save_best=best)
        return log

    # ------------------------------------------------------------------ #

    def _save_checkpoint(self, epoch: int, save_best: bool = False):
        """Rank 0 writes; no rank goes on before the files exist. The
        model's and the optimizer's state are gathered on every rank
        first, where the model is split over the model axis."""
        state = (full_state_dict(self.model),
                 full_optimizer_state(self.model, self.optimizer))
        if is_main():
            self._write_checkpoints(epoch, save_best, *state)
        barrier()

    def _write_checkpoints(self, epoch: int, save_best: bool, state_dict, optimizer_state):
        cfg = self.config.config if hasattr(self.config, "config") else self.config
        names = [f"checkpoint-epoch{epoch}"] + (["model_best"] if save_best else [])
        for name in names:
            path = save_checkpoint(
                self.checkpoint_dir, name, arch=self.arch_name, epoch=epoch,
                state_dict=state_dict, optimizer=optimizer_state,
                lr_scheduler=self.scheduler, monitor_best=self.mnt_best, config=cfg,
            )
            self.logger.info("Saving %s: %s ...",
                             "current best" if name == "model_best" else "checkpoint",
                             path)

    def _set_schedule_step(self, step: int) -> None:
        """Put the schedule (and each group's lr) at optimizer step ``step``."""
        self.scheduler.last_epoch = step
        for group, base, fn in zip(self.optimizer.param_groups,
                                   self.scheduler.base_lrs, self.scheduler.lr_lambdas):
            group["lr"] = base * fn(step)

    def _resume_checkpoint(self, resume_path):
        self.logger.info("Loading checkpoint: %s ...", resume_path)
        ckpt = load_checkpoint(resume_path)
        self.start_epoch = int(ckpt.get("epoch", 0)) + 1
        self.mnt_best = float(ckpt.get("monitor_best", self.mnt_best))

        if ckpt.get("arch") and ckpt["arch"] != self.arch_name:
            self.logger.warning(
                "Checkpoint architecture %s differs from config %s.",
                ckpt["arch"], self.arch_name,
            )

        state_dict, missing, unexpected = graft_params(
            full_state_dict(self.model), ckpt["state_dict"]
        )
        if missing:
            self.logger.warning("%d missing checkpoint keys", len(missing))
        if unexpected:
            self.logger.warning("%d unexpected checkpoint keys", len(unexpected))
        assert_warm_start_keys(missing, unexpected)
        load_full_state_dict(self.model, state_dict)

        restored_opt = ckpt.get("optimizer")
        # the reference does not resume the optimizer state when the
        # optimizer type or lr changed (base_trainer.py:178-194): stale Adam
        # moments under a new lr change the run's dynamics
        ckpt_opt = dict((ckpt.get("config") or {}).get("optimizer") or {})
        live_opt = dict(self.config.get("optimizer") or {})
        if restored_opt is not None and ckpt_opt and live_opt:
            t_old, t_new = ckpt_opt.get("type"), live_opt.get("type")
            lr_old = (ckpt_opt.get("args") or {}).get("lr")
            lr_new = (live_opt.get("args") or {}).get("lr")
            type_changed = t_old and t_new and t_old != t_new
            lr_changed = (
                lr_old is not None and lr_new is not None
                and float(lr_old) != float(lr_new)
            )
            if type_changed or lr_changed:
                self.logger.warning(
                    "Optimizer %s changed (checkpoint %s -> config %s); "
                    "optimizer state not resumed.",
                    "type" if type_changed else "lr",
                    t_old if type_changed else lr_old,
                    t_new if type_changed else lr_new,
                )
                restored_opt = None
        if restored_opt is not None and not (missing or unexpected):
            try:
                self.optimizer.load_state_dict(
                    split_optimizer_state(self.model, self.optimizer, restored_opt))
            except ValueError as e:
                # the groups changed: the moments cannot be mapped, but the
                # step can, so the schedule resumes at its decayed position
                # (fresh moments re-warm within tens of steps)
                step = schedule_step(ckpt)
                if step is not None:
                    self._set_schedule_step(step)
                    self.logger.warning(
                        "Optimizer state layout changed (%s): moments reset, "
                        "lr schedule resumed at step %d.", e, step,
                    )
                else:
                    self.logger.warning(
                        "Optimizer state layout changed (%s); not resuming it.", e
                    )
            else:
                if ckpt.get("lr_scheduler") is not None:
                    self.scheduler.load_state_dict(ckpt["lr_scheduler"])
        self.logger.info(
            "Checkpoint loaded. Resume training from epoch %d", self.start_epoch
        )


def make_grid(images: np.ndarray, nrow: int = 8, normalize: bool = True):
    """Tile a [b, 3, h, w] (or [b, h, w, 3]: the uint8 path ships HWC) batch
    into one [3, H, W] image for TensorBoard (the torchvision
    ``make_grid`` use at ``trainer/trainer.py:103-106``)."""
    if images.shape[-1] == 3 and images.shape[1] != 3:
        images = np.transpose(images, (0, 3, 1, 2))
    images = images.astype(np.float32)
    b, c, h, w = images.shape
    ncol = min(nrow, b)
    nrows = (b + ncol - 1) // ncol
    if normalize:
        lo, hi = images.min(), images.max()
        images = (images - lo) / max(float(hi - lo), 1e-6)
    grid = np.zeros((c, nrows * h, ncol * w), dtype=np.float32)
    for i in range(b):
        r, col = divmod(i, ncol)
        grid[:, r * h : (r + 1) * h, col * w : (col + 1) * w] = images[i]
    return grid
