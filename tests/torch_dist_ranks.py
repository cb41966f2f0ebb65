"""What each rank of ``tests/test_torch_dist.py`` (and of the other
spawned-rank files: ``test_torch_tp.py``, ``test_torch_fsdp.py``,
``test_torch_ep.py``, ``test_torch_pipeline.py``) runs, in a process of its
own: a module the spawned children import (they cannot unpickle a test's
closure), with no JAX, as on the card's machine.

``spawn(fn, world, tmp, *args)`` starts ``world`` processes with the
``spawn`` method (``join=False`` returns at once: ``wait`` joins them); each sets ``torchrun``'s variables, runs torch on one
thread, joins a gloo group through a file in ``tmp`` (no port for pytest's
workers to race for) and calls ``fn(rank, world, tmp, *args)``. The ranks
hand their results back through ``torch.save`` files in ``tmp``."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

TINY = "test-tiny"
OPT = {"type": "Adam", "args": {"lr": 1e-3, "weight_decay": 1e-4, "amsgrad": True}}
SCHED = {"type": "StepLR", "args": {"step_size": 1, "gamma": 0.5}}
STEP_KW = dict(steps_per_epoch=2, adapter_lr=1e-2, fc_lr=2e-3)


def spawn(fn, world: int, tmp, *args, join: bool = True):
    """Run ``fn`` on ``world`` ranks; with ``join`` False return at once
    with the processes' context, whose ``join()`` the caller loops on."""
    import torch.multiprocessing as mp

    return mp.start_processes(_entry, args=(fn, world, str(tmp), args), nprocs=world,
                              join=join, start_method="spawn")


def wait(context, timeout=None) -> None:
    """Block until every rank of ``spawn(..., join=False)`` has ended;
    a rank's error is raised here. Past ``timeout`` seconds (a rank that
    waits in a collective its peers never join) the ranks are killed and
    ``TimeoutError`` raised."""
    import time

    deadline = None if timeout is None else time.monotonic() + timeout
    while not context.join(timeout=None if deadline is None else 1.0):
        if deadline is not None and time.monotonic() > deadline:
            for process in context.processes:
                process.kill()
            raise TimeoutError(f"the ranks did not end within {timeout} s")


def _entry(rank, fn, world, tmp, args):
    import torch.distributed as dist

    from vtc_tpu_torch.utils.util import init_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      WANDB_MODE="disabled")
    torch.set_num_threads(1)
    init_distributed("gloo", f"file://{tmp}/rendezvous")
    try:
        fn(rank, world, Path(tmp), *args)
    finally:
        dist.destroy_process_group()


# ---- the train step --------------------------------------------------------------

def flagship_port(state_dict, **kwargs):
    """The test-tiny flagship on ``state_dict``, its frozen branches without
    gradients as ``create_model`` leaves them."""
    from vtc_tpu_torch.models import frozen_predicate
    from vtc_tpu_torch.models.retrieval import PretrainedCLIP_finaltf

    model = PretrainedCLIP_finaltf(model_type=TINY, **kwargs)
    model.load_state_dict(state_dict, strict=True)
    frozen = frozen_predicate(model.freeze)
    for name, p in model.named_parameters():
        p.requires_grad_(not frozen(name))
    return model


def step_case(case: dict) -> dict:
    """``case["steps"]`` train steps of the flagship (``case["model_kw"]``)
    on this process's rows of the global batch ``case["data"]``: DDP under
    a process group, the plain module without one. ``case["draws"]`` holds
    each step's draws of the global batch (one dict per microbatch with
    ``accum``), or None: drawn from a generator seeded ``seed + step`` on
    every rank. Returns each loss, the step-1 gradients (the optimizer's
    view), the parameters and buffers after, the last output's shapes and
    each MoE layer's last routing."""
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.parallel.expert import moe_layers, shard_experts
    from vtc_tpu_torch.parallel.mesh import data_parallel, fully_shard_model, shard_batch
    from vtc_tpu_torch.parallel.tensor import full_tensors, shard_model
    from vtc_tpu_torch.training import build_optimizer, train_step

    # on case["device"] (the CPU by default), split over the model or expert
    # axis where the rank's mesh has one, then ZeRO-3 over its data axis
    # where the case asks
    device = torch.device(case.get("device", "cpu"))
    model = flagship_port(case["state_dict"], **case.get("model_kw", {})).to(device)
    model = shard_experts(shard_model(model))
    if case.get("fsdp"):
        fully_shard_model(model, device)
    optimizer, scheduler = build_optimizer(model, case.get("opt", OPT), SCHED, **STEP_KW)
    grads = {}

    def first(opt, args, kwargs):
        if not grads:
            grads.update({n: None if p.grad is None else p.grad.detach().clone()
                          for n, p in model.named_parameters()})

    optimizer.register_step_pre_hook(first)
    ddp = data_parallel(model, device)
    data = [torch.from_numpy(np.ascontiguousarray(shard_batch(a))).to(device)
            for a in case["data"]]
    losses, shapes = [], None
    for step in range(case["steps"]):
        draws = case["draws"][step] if case.get("draws") else None
        gen = torch.Generator(device).manual_seed(case.get("seed", 0) + step)
        loss, out = train_step(ddp, clip_loss, optimizer, scheduler, data, {},
                               generator=gen, draws=draws,
                               accum_steps=case.get("accum", 1))
        losses.append(float(loss))
        shapes = [tuple(o.shape) for o in out]
    return {"losses": losses, "grads": full_tensors(model, grads), "shapes": shapes,
            "params": full_tensors(model, {n: p.detach().clone()
                                           for n, p in model.named_parameters()}),
            "local_params": {n: _local(p).detach().clone() for n, p in model.named_parameters()},
            "storage": {n: _local(p).untyped_storage().nbytes()
                        for n, p in model.named_parameters()},
            "local_moments": {n: {k: tuple(_local(v).shape) for k, v in optimizer.state[p].items()
                                  if torch.is_tensor(v) and v.dim()}
                              for n, p in model.named_parameters() if p in optimizer.state},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "routing": [tuple(t.clone() for t in m.routing) for m in moe_layers(model)]}


def _local(t):
    """This rank's shard of a ``DTensor`` (ZeRO-3), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def run_dist(rank, world, tmp):
    """Every check of ``tests/test_torch_dist.py`` in one spawn: the step
    cases and small collectives of ``tmp/steps`` (``run_steps``), the
    evaluations of ``tmp/evals`` (``run_evals``), the CLI of ``tmp/cli``
    (``run_cli``), then the step cases on JAX's draws, which the test
    process writes to ``tmp/steps/jax_cases.pt`` once its JAX runs end."""
    import time

    out = run_steps(rank, world, tmp / "steps")
    run_evals(rank, world, tmp / "evals")
    run_cli(rank, world, tmp / "cli")
    later = tmp / "steps" / "jax_cases.pt"
    deadline = time.monotonic() + 600
    while not later.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{later} was not written")
        time.sleep(0.2)
    out["cases"].update({name: step_case(case)
                         for name, case in torch.load(later, weights_only=False).items()})
    torch.save(out, tmp / "steps" / f"steps_rank{rank}.pt")


def run_steps(rank, world, tmp):
    """Every case of ``tmp/steps.pt`` through ``step_case``, then the small
    collectives: the token bucket, ``allgather_varlen``, the BatchNorm of
    the global batch, ``recall_at_k_sharded``, and the MoE model's step,
    which routes over both ranks' tokens. Returns the results."""
    from vtc_tpu_torch.models.layers import TorchBatchNorm
    from vtc_tpu_torch.ops.retrieval import recall_at_k_sharded
    from vtc_tpu_torch.parallel.mesh import all_gather_rows, shard_batch
    from vtc_tpu_torch.training.step import global_truncate_tokens
    from vtc_tpu_torch.utils.util import allgather_varlen

    spec = torch.load(tmp / "steps.pt", weights_only=False)
    out = {"cases": {name: step_case(case) for name, case in spec["cases"].items()}}

    # the token bucket: each rank's rows reach a different EOT
    tokens = [shard_batch(a) for a in spec["tokens"]]
    out["bucket"] = [t.shape for t in global_truncate_tokens(tokens, multihost=True)]
    out["local_bucket"] = [t.shape for t in global_truncate_tokens(tokens)]

    # allgather_varlen: rank r holds spec["varlen"][r] rows, none on one rank
    out["varlen"] = allgather_varlen(spec["varlen"][rank])

    # a TorchBatchNorm in training on the rank's rows of a [8, 4, 3] batch
    bn = TorchBatchNorm(4)
    bn.load_state_dict(spec["bn"]["state"])
    x = torch.from_numpy(shard_batch(spec["bn"]["x"])).requires_grad_()
    y = bn.train()(x)
    full = all_gather_rows(y)
    (full * torch.from_numpy(spec["bn"]["c"])).sum().backward()
    out["bn"] = {"y": full.detach(), "x_grad": x.grad / world,
                 "running": (bn.running_mean.clone(), bn.running_var.clone())}

    # ranking with the query axis split over the ranks
    r = spec["recall"]
    out["recall"] = recall_at_k_sharded(r["a"], r["b"], r["k"], targets=r["targets"],
                                        device="cpu")

    out["moe"] = step_case(spec["moe"])
    return out


# ---- the evaluations and the train CLI --------------------------------------------

class EvalArgs:
    def __init__(self, num_irrelevant_comments=0):
        self.num_irrelevant_comments = num_irrelevant_comments


def run_evals(rank, world, tmp):
    """The ``eval.py`` twin's ``main`` and ``retrieval_evaluation`` on this
    rank's share, from the files the test wrote in ``tmp``; the result file
    and the CSV go to ``tmp/evalrun``, the working directory."""
    from vtc_tpu_torch.config import ConfigParser
    from vtc_tpu_torch.evaluation import eval as port_eval
    from vtc_tpu_torch.evaluation.retrieval_eval import retrieval_evaluation

    import json
    import types

    spec = torch.load(tmp / "evals.pt", weights_only=False)
    os.chdir(tmp / "evalrun")
    written = []  # the result files this process writes
    port_eval.json = types.SimpleNamespace(
        dump=lambda obj, f: (written.append(f.name), json.dump(obj, f)))
    recalls = port_eval.main(ConfigParser(spec["config"]), EvalArgs(), spec["ckpt"],
                             device="cpu")
    model = flagship_port(spec["state_dict"]).eval()
    table = retrieval_evaluation(model, "synthetic", "test", dataset=spec["videos"],
                                 frame_stride=4, out_csv=str(tmp / "evalrun" / "table.csv"),
                                 device="cpu")
    torch.save({"recalls": recalls, "table": table.to_numpy(), "written": written},
               tmp / f"evals_rank{rank}.pt")


def run_cli(rank, world, tmp):
    """The train twin's CLI at ``--n_devices 2``: 2 epochs, then a resume
    from the first epoch's checkpoint for its second; each epoch's
    parameters and the run dirs each process saw."""
    from vtc_tpu_torch import train as twin
    from vtc_tpu_torch.training import trainer as trainer_mod

    epochs = []
    run_epoch = trainer_mod.Trainer._train_epoch

    def record(self, epoch):
        log = run_epoch(self, epoch)
        epochs.append({n: p.detach().clone() for n, p in self.model.named_parameters()})
        return log

    trainer_mod.Trainer._train_epoch = record
    argv = ["-c", str(tmp / "cli_config.json"), "--n_devices", str(world)]
    first = twin.cli(argv, device="cpu")
    ckpt = first.checkpoint_dir / "checkpoint-epoch1.pth"
    resumed = twin.cli(["-r", str(ckpt), "--n_devices", str(world)], device="cpu")
    torch.save({"epochs": epochs, "dirs": [str(first.checkpoint_dir),
                                           str(resumed.checkpoint_dir)],
                "start": resumed.start_epoch},
               tmp / f"cli_rank{rank}.pt")


# ---- the model axis (tests/test_torch_tp.py) --------------------------------------

def run_tp(rank, world, tmp):
    """A ``create_mesh(world // 2, 2)`` mesh: every step case of
    ``tmp/tp.pt`` through ``step_case``; where the spec has them, the
    ``eval.py`` twin and ``retrieval_evaluation`` on the mesh, and the train
    twin at ``--n_model 2`` with a resume, recording each epoch's gathered
    parameters and the state the resume restored."""

    from vtc_tpu_torch.parallel.mesh import create_mesh, current_mesh
    from vtc_tpu_torch.parallel.tensor import shard_model

    create_mesh(world // 2, 2, device="cpu")
    spec = torch.load(tmp / "tp.pt", weights_only=False)
    out = {"cases": {name: step_case(case) for name, case in spec["cases"].items()}}
    if "evals" in spec:
        import json
        import types

        from vtc_tpu_torch.config import ConfigParser
        from vtc_tpu_torch.evaluation import eval as port_eval
        from vtc_tpu_torch.evaluation.retrieval_eval import retrieval_evaluation

        ev = spec["evals"]
        os.chdir(tmp / "evalrun")
        written = []
        port_eval.json = types.SimpleNamespace(
            dump=lambda obj, f: (written.append(f.name), json.dump(obj, f)))
        out["recalls"] = port_eval.main(ConfigParser(ev["config"]), EvalArgs(), ev["ckpt"],
                                        device="cpu")
        out["written"] = written
        model = shard_model(flagship_port(ev["state_dict"])).eval()
        out["table"] = retrieval_evaluation(
            model, "synthetic", "test", dataset=ev["videos"], frame_stride=4,
            out_csv=str(tmp / "evalrun" / "table.csv"), mesh=current_mesh(),
            device="cpu").to_numpy()
    if "cli" in spec:
        out.update(_twin_cli(tmp, ["--n_devices", str(world // 2), "--n_model", "2"]))
    torch.save(out, tmp / f"tp_rank{rank}.pt")


def _twin_cli(tmp, axes):
    """The train twin on ``tmp/cli_config.json`` with the mesh flags
    ``axes``: its epochs, then a resume of the first epoch's checkpoint for
    a second; each epoch's gathered state, the state the resume restored,
    the run dirs and this rank's parameters after."""
    from vtc_tpu_torch import train as twin
    from vtc_tpu_torch.parallel.tensor import full_optimizer_state, full_state_dict
    from vtc_tpu_torch.training import trainer as trainer_mod

    epochs, resumed = [], []
    run_epoch = trainer_mod.Trainer._train_epoch
    resume = trainer_mod.Trainer._resume_checkpoint

    def copied(tree):
        if torch.is_tensor(tree):
            return tree.detach().clone()
        if isinstance(tree, dict):
            return {k: copied(v) for k, v in tree.items()}
        return tree

    def record(self, epoch):
        log = run_epoch(self, epoch)
        epochs.append(copied(full_state_dict(self.model)))
        return log

    def record_resume(self, path):
        resume(self, path)
        resumed.append((copied(full_state_dict(self.model)),
                        copied(full_optimizer_state(self.model, self.optimizer))))

    trainer_mod.Trainer._train_epoch = record
    trainer_mod.Trainer._resume_checkpoint = record_resume
    first = twin.cli(["-c", str(tmp / "cli_config.json")] + axes, device="cpu")
    ckpt = first.checkpoint_dir / "checkpoint-epoch1.pth"
    again = twin.cli(["-r", str(ckpt), "--epochs", "2"] + axes, device="cpu")
    return {"epochs": epochs, "resumed": resumed, "start": again.start_epoch,
            "dirs": [str(first.checkpoint_dir), str(again.checkpoint_dir)],
            "local": {n: p.detach().clone() for n, p in again.model.named_parameters()}}


def run_embeddings(rank, world, tmp, argv):
    """The embedding script's ``main(argv)`` on this rank: the rows it
    encoded and the merged embeddings it returned."""
    from vtc_tpu_torch.scripts import get_clip_vit_embeddings as script

    encoded = []
    encode = script.Thumbnails.__getitem__

    def count(self, i):
        encoded.append(i)
        return encode(self, i)

    script.Thumbnails.__getitem__ = count
    stacked = script.main(argv)
    torch.save({"rows": len(encoded), "stacked": stacked}, tmp / f"emb_rank{rank}.pt")


# ---- ZeRO-3 (tests/test_torch_fsdp.py) ----------------------------------------------

def run_fsdp(rank, world, tmp):
    """A ``create_mesh(world // n_model, n_model)`` mesh on the CPU: every
    step case of ``tmp/fsdp.pt`` through ``step_case``; where the spec has
    them, the checkpoint round trip of ``fsdp_round_trip``, the train twin
    at ``--fsdp 1`` (one epoch, then a resume of a single-card ``.pth``),
    and the strided evaluations of a sharded model."""
    from vtc_tpu_torch.parallel.mesh import create_mesh

    spec = torch.load(tmp / "fsdp.pt", weights_only=False)
    create_mesh(world // spec["n_model"], spec["n_model"], device="cpu")
    out = {"cases": {name: step_case(case) for name, case in spec["cases"].items()}}
    if "round_trip" in spec:
        out["round_trip"] = fsdp_round_trip(spec["round_trip"], tmp, rank)
    if "cli" in spec:
        out["cli"] = _fsdp_cli(tmp, world, spec["evals"]["videos"])
    if "evals" in spec:
        out["evals"] = _fsdp_evals(spec["evals"], tmp)
    torch.save(out, tmp / f"fsdp_rank{rank}.pt")


def _copied(tree):
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copied(v) for k, v in tree.items()}
    return tree


def fsdp_round_trip(spec, tmp, rank):
    """The flagship (``spec["state_dict"]``) sharded over the data axis takes
    the single-card checkpoint ``spec["ckpt"]`` (parameters, Adam moments, schedule); its
    gathered state right after, then a step on this rank's rows and the
    gathered state that rank 0 writes as ``tmp/fsdp_step.pth``, then one
    more step: each loss, and the shapes of this rank's shards."""
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.parallel.mesh import fully_shard_model, shard_batch
    from vtc_tpu_torch.parallel.tensor import (
        full_optimizer_state,
        full_state_dict,
        load_full_state_dict,
        split_optimizer_state,
    )
    from vtc_tpu_torch.training import build_optimizer, save_checkpoint, train_step

    ckpt = torch.load(spec["ckpt"], weights_only=True)
    # built on the weights before the checkpoint's step: the load must move them
    model = fully_shard_model(flagship_port(spec["state_dict"]), torch.device("cpu"))
    optimizer, scheduler = build_optimizer(model, OPT, SCHED, **STEP_KW)
    load_full_state_dict(model, ckpt["state_dict"])
    optimizer.load_state_dict(split_optimizer_state(model, optimizer, ckpt["optimizer"]))
    scheduler.load_state_dict(ckpt["lr_scheduler"])
    out = {"loaded": (_copied(full_state_dict(model)),
                      _copied(full_optimizer_state(model, optimizer)))}
    data = [torch.from_numpy(np.ascontiguousarray(shard_batch(a))) for a in spec["data"]]
    losses = []
    for step in range(2):
        loss, _ = train_step(model, clip_loss, optimizer, scheduler, data, {},
                             draws=spec["draws"][step])
        losses.append(float(loss))
        if step == 0:
            state = (full_state_dict(model), full_optimizer_state(model, optimizer))
            if rank == 0:
                save_checkpoint(tmp, "fsdp_step", arch="PretrainedCLIP_finaltf", epoch=1,
                                state_dict=state[0], optimizer=state[1],
                                lr_scheduler=scheduler)
    out["losses"] = losses
    emb = dict(model.named_parameters())["model.token_embedding.weight"]
    out["shards"] = {"param": tuple(emb.to_local().shape),
                     "moments": {k: tuple(v.to_local().shape)
                                 for k, v in optimizer.state[emb].items() if v.dim()}}
    return out


def _fsdp_cli(tmp, world, videos):
    """The train twin at ``--fsdp 1 --n_devices world``: one epoch, then a
    run that resumes the single-card ``tmp/single/single.pth`` for its second;
    each epoch's gathered state and the state each resume restored. The
    trainer's per-epoch probe runs ``retrieval_evaluation`` of the sharded
    model over ``videos`` (an odd number: the ranks' shares differ), as
    ``train._make_probe``'s does over MSRVTT; each probe's table."""
    from vtc_tpu_torch import train as twin
    from vtc_tpu_torch.evaluation.retrieval_eval import retrieval_evaluation
    from vtc_tpu_torch.parallel.mesh import current_mesh
    from vtc_tpu_torch.parallel.tensor import full_optimizer_state, full_state_dict
    from vtc_tpu_torch.training import trainer as trainer_mod

    epochs, resumed, probes = [], [], []

    def make_probe(config):
        def probe(trainer, branch_override=None):
            trainer.model.eval()
            table = retrieval_evaluation(trainer.model, "synthetic", "test", dataset=videos,
                                         frame_stride=4, branch_override=branch_override,
                                         mesh=current_mesh(), device=trainer.device)
            probes.append((branch_override, table.to_numpy()))
            return {}
        return probe

    twin._make_probe = make_probe
    run_epoch = trainer_mod.Trainer._train_epoch
    resume = trainer_mod.Trainer._resume_checkpoint

    def record(self, epoch):
        log = run_epoch(self, epoch)
        epochs.append(_copied(full_state_dict(self.model)))
        return log

    def record_resume(self, path):
        resume(self, path)
        resumed.append((_copied(full_state_dict(self.model)),
                        _copied(full_optimizer_state(self.model, self.optimizer)),
                        self.scheduler.last_epoch))

    trainer_mod.Trainer._train_epoch = record
    trainer_mod.Trainer._resume_checkpoint = record_resume
    argv = ["-c", str(tmp / "cli_config.json"), "--n_devices", str(world), "--fsdp", "1"]
    first = twin.cli(argv, device="cpu")
    again = twin.cli(argv + ["-r", str(tmp / "single" / "single.pth"), "--epochs", "2"],
                     device="cpu")
    return {"epochs": epochs, "resumed": resumed, "probes": probes, "start": again.start_epoch,
            "dirs": [str(first.checkpoint_dir), str(again.checkpoint_dir)],
            "sharded": all(type(p).__name__ == "DTensor"
                           for p in again.model.parameters() if p.dim())}


def _fsdp_evals(ev, tmp):
    """The ``eval.py`` twin of an fsdp run's config (the whole model on each
    data rank) and ``retrieval_evaluation`` of the flagship sharded over the
    data axis, each over an odd number of items split over the ranks."""
    import json
    import types

    from vtc_tpu_torch.config import ConfigParser
    from vtc_tpu_torch.evaluation import eval as port_eval
    from vtc_tpu_torch.evaluation.retrieval_eval import retrieval_evaluation
    from vtc_tpu_torch.parallel.mesh import current_mesh, fully_shard_model

    os.chdir(tmp / "evalrun")
    written = []
    port_eval.json = types.SimpleNamespace(
        dump=lambda obj, f: (written.append(f.name), json.dump(obj, f)))
    recalls = port_eval.main(ConfigParser(ev["config"]), EvalArgs(), ev["ckpt"], device="cpu")
    model = fully_shard_model(flagship_port(ev["state_dict"]), torch.device("cpu")).eval()
    table = retrieval_evaluation(model, "synthetic", "test", dataset=ev["videos"],
                                 frame_stride=4, mesh=current_mesh(), device="cpu")
    return {"recalls": recalls, "written": written, "table": table.to_numpy(),
            "sharded_after": all(type(p).__name__ == "DTensor"
                                 for p in model.parameters() if p.dim())}


# ---- the MoE adapter across ranks (tests/test_torch_ep.py) ----------------------------

def _make_mesh(axis, n_data, n_second, device="cpu"):
    """``axis``'s mesh creator; ranks on a card share card 0 (a ``DeviceMesh``
    on CUDA takes its card from ``LOCAL_RANK``)."""
    from vtc_tpu_torch.parallel.expert import create_ep_mesh
    from vtc_tpu_torch.parallel.mesh import create_mesh
    from vtc_tpu_torch.parallel.pipeline import create_pipeline_mesh

    if torch.device(device).type == "cuda":
        os.environ["LOCAL_RANK"] = "0"
    make = {"model": create_mesh, "expert": create_ep_mesh, "pipe": create_pipeline_mesh}
    return make[axis](n_data, n_second, device=device)


def moe_layer_case(case: dict) -> dict:
    """A ``MoEMLP`` (``case["params"]``, split over the expert axis where the
    mesh has one) on this data rank's rows of ``case["x"]`` [B, L, E] under
    ``global_routing``, then the backward of ``sum(y · c)`` over its rows:
    its rows of the output and of the input's gradient, the global routing
    and aux loss, the parameter gradients in the single-card layout and
    the shapes this rank holds."""
    from vtc_tpu_torch.parallel.expert import MoEMLP, global_routing, shard_experts
    from vtc_tpu_torch.parallel.mesh import shard_batch
    from vtc_tpu_torch.parallel.tensor import full_tensors

    layer = MoEMLP(*case["layer"])
    layer.load_state_dict({n: torch.tensor(v) for n, v in case["params"].items()})
    shard_experts(layer)
    x = torch.from_numpy(np.ascontiguousarray(shard_batch(case["x"]))).requires_grad_()
    with global_routing():
        y = layer(x)
    (y * torch.from_numpy(np.ascontiguousarray(shard_batch(case["c"])))).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "aux": float(layer.aux_loss.detach()),
            "routing": layer.routing,
            "grads": full_tensors(layer, {n: p.grad for n, p in layer.named_parameters()}),
            "local": {n: tuple(p.shape) for n, p in layer.named_parameters()}}


def run_ep(rank, world, tmp):
    """Each mesh of ``tmp/ep.pt`` in turn (``(name, (axis, n_data,
    n_second), cases)``), every case on it: a ``MoEMLP`` layer
    (``moe_layer_case``) or a train step (``step_case``); where the spec has
    them, the strided evaluations of a model split over the expert axis and
    the train twin at ``--ep 2`` with a resume."""
    spec = torch.load(tmp / "ep.pt", weights_only=False)
    out = {}
    for name, mesh, cases in spec["meshes"]:
        _make_mesh(*mesh, device=spec.get("device", "cpu"))
        for case_name, case in cases.items():
            out[name, case_name] = moe_layer_case(case) if "layer" in case else step_case(case)
    if "evals" in spec:
        out["evals"] = _ep_evals(spec["evals"])
    if "cli" in spec:
        out["cli"] = _twin_cli(tmp, ["--n_devices", "1", "--ep", "2"])
    torch.save(out, tmp / f"ep_rank{rank}.pt")


def _ep_evals(ev):
    """``retrieval_evaluation`` of the MoE flagship split over the expert
    axis of the current mesh, over an odd number of videos split over the
    data ranks (each rank's share routes its own tokens, on the experts
    gathered whole), twice, and whether the stacks are split again after."""
    from vtc_tpu_torch.evaluation.retrieval_eval import retrieval_evaluation
    from vtc_tpu_torch.parallel.expert import moe_layers, shard_experts
    from vtc_tpu_torch.parallel.mesh import current_mesh

    model = shard_experts(flagship_port(ev["state_dict"], **ev["model_kw"])).eval()
    tables = [retrieval_evaluation(model, "synthetic", "test", dataset=ev["videos"],
                                   frame_stride=4, mesh=current_mesh(),
                                   device="cpu").to_numpy() for _ in range(2)]
    return {"tables": tables,
            "split_after": all(m.whole is None and m.w_fc.shape[0] * 2 == m.n_experts
                               for m in moe_layers(model))}


# ---- the pipe axis (tests/test_torch_pipeline.py) --------------------------------------

def stack_forward(fwd: dict) -> dict:
    """One stack (``fwd["kind"]``: a ``layers.Transformer`` or the
    TimeSformer's, built from ``fwd["args"]`` with ``fwd["state_dict"]``) on
    the whole ``fwd["x"]`` on every data place, then the backward of
    ``sum(y · c)`` and ``pipeline.sync_gradients``: the output, the input's
    gradient and the parameter gradients."""
    from vtc_tpu_torch.models.layers import Transformer
    from vtc_tpu_torch.models.timesformer import TimeSformerTransformer
    from vtc_tpu_torch.parallel.pipeline import sync_gradients

    cls = {"transformer": Transformer, "timesformer": TimeSformerTransformer}[fwd["kind"]]
    stack = cls(*fwd["args"], **fwd.get("kwargs", {}))
    stack.load_state_dict({n: torch.as_tensor(v) for n, v in fwd["state_dict"].items()})
    x = torch.from_numpy(fwd["x"]).requires_grad_()
    y = stack(x, fwd["extra"])
    (y * torch.from_numpy(fwd["c"])).sum().backward()
    sync_gradients(stack)
    return {"y": y.detach(), "x_grad": x.grad,
            "grads": {n: p.grad for n, p in stack.named_parameters()}}


def run_pp(rank, world, tmp):
    """A ``create_pipeline_mesh(world // 2, 2)`` mesh with the stacks'
    pipeline on (``n_micro`` of the spec): each stack forward of
    ``tmp/pp.pt`` (``stack_forward``) and each train step case
    (``step_case``), each with the stack counts of its run; where the spec
    has it, the train twin at ``--pp 2`` with a resume."""
    from vtc_tpu_torch.parallel.stack import (
        reset_stack_counts,
        set_stack_parallel,
        stack_counts,
    )

    spec = torch.load(tmp / "pp.pt", weights_only=False)
    mesh = _make_mesh("pipe", world // 2, 2, spec.get("device", "cpu"))
    set_stack_parallel("pipe", mesh, spec["n_micro"])
    out = {}
    for name, fwd in spec["forwards"].items():
        reset_stack_counts()
        out[name] = dict(stack_forward(fwd), counts=stack_counts())
    for name, case in spec["cases"].items():
        reset_stack_counts()
        out[name] = dict(step_case(case), counts=stack_counts())
    if "cli" in spec:
        out["cli"] = _twin_cli(tmp, ["--n_devices", str(world // 2), "--pp", "2",
                                     "--n_micro", str(spec["n_micro"])])
    torch.save(out, tmp / f"pp_rank{rank}.pt")
