"""One dp×tp train step at the real ViT-B/32 widths, the twin of
``scripts/dryrun_fullsize.py``:

    python -m vtc_tpu_torch.scripts.dryrun_fullsize [tp] [n_data] [--bf16] [--device cpu]

The flagship (``PretrainedCLIP_finaltf``, ViT-B/32 + CAM) at full width is
built on every rank from one seed, split over the model axis of
``create_mesh(n_data, tp)`` (``parallel.tensor``: the 12- and 8-head
splits, the 49,408-row vocabulary table, the 3072-wide MLP), and takes one
``train_step`` at batch 8 (a 224² image and a 16-token title with one
comment per row; Adam with amsgrad at lr 1e-5, ``adapter_lr`` 1e-4,
StepLR(10, 0.1)) through DDP over the data axis. It checks that the loss is
finite and that a split ``in_proj_weight`` moved, and prints both.

Under ``torchrun`` (``n_data·tp`` processes) it runs in the launched ranks;
otherwise it spawns them: on the card over NCCL where the machine has a
card for each rank, else over gloo with every rank on card 0 (NCCL takes
one rank per card); on the CPU (``--device cpu``) over gloo, each rank on
one thread. ``--bf16`` runs the activations in bf16 over fp32 weights.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

SOS, EOS = 49406, 49407


def _tokens(rng, lead, ntoks):
    t = np.zeros(lead + (ntoks,), np.int32)
    t[..., 0] = SOS
    t[..., 1:4] = rng.integers(1, SOS - 1, lead + (3,))
    t[..., 4] = EOS
    return t


def step_once(device: torch.device, batch: int = 8, ntoks: int = 16, ncomms: int = 1,
              dtype: str = "fp32", model_type: str = "ViT-B/32") -> dict:
    """On a rank of a process group with ``create_mesh`` done: build, split
    and step the flagship once; -> ``{"loss", "moved", "finite", ...}``."""
    from ..models import create_model
    from ..models.clip_model import CLIP_VARIANTS
    from ..ops.losses import clip_loss
    from ..parallel.mesh import data_parallel, model_world, shard_batch
    from ..parallel.tensor import shard_model
    from ..training import build_optimizer, train_step

    tic = time.perf_counter()
    model = shard_model(create_model("PretrainedCLIP_finaltf", model_type=model_type, seed=0,
                                     dtype=dtype, device=device))
    init_s = time.perf_counter() - tic
    optimizer, scheduler = build_optimizer(
        model, {"type": "Adam", "args": {"lr": 1e-5, "amsgrad": True}},
        {"type": "StepLR", "args": {"step_size": 10, "gamma": 0.1}}, steps_per_epoch=10,
        adapter_lr=1e-4)
    rng = np.random.default_rng(0)
    size = CLIP_VARIANTS[model_type].input_resolution
    data = [rng.normal(size=(batch, 3, size, size)).astype(np.float32),
            _tokens(rng, (batch,), ntoks), _tokens(rng, (batch, ncomms), ntoks)]
    data = [torch.from_numpy(np.ascontiguousarray(shard_batch(a))).to(device) for a in data]
    weight = model.model.visual.transformer.resblocks[0].attn.in_proj_weight
    before = weight.detach().clone()
    tic = time.perf_counter()
    loss, _ = train_step(data_parallel(model, device), clip_loss, optimizer, scheduler, data, {},
                         generator=torch.Generator(device).manual_seed(0))
    loss = float(loss)
    step_s = time.perf_counter() - tic
    return {"loss": loss, "finite": bool(np.isfinite(loss) and torch.isfinite(weight).all()),
            "moved": not torch.equal(before, weight.detach()),
            "split_rows": int(weight.shape[0]), "tp": model_world(), "init_s": init_s,
            "step_s": step_s}


def _rank(rank: int, world: int, tp: int, init: str, device_type: str, kw: dict, out: str):
    from ..parallel.mesh import create_mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if device_type == "cpu":
        torch.set_num_threads(1)
    nccl = device_type == "cuda" and torch.cuda.device_count() >= world
    if nccl:
        torch.cuda.set_device(rank)
    device = torch.device("cuda", rank if nccl else 0) if device_type == "cuda" \
        else torch.device("cpu")
    dist.init_process_group("nccl" if nccl else "gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        create_mesh(world // tp, tp, device=device)
        result = step_once(device, **kw)
        result["backend"] = dist.get_backend()
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def run(tp: int = 2, n_data: int = 1, device=None, **kw) -> dict:
    """The step on ``n_data·tp`` ranks (spawned here, or the ``torchrun``
    group this process is a rank of); -> rank 0's result (every rank's
    under torchrun is its own)."""
    from ..device import resolve_device
    from ..parallel.mesh import create_mesh
    from ..utils.util import init_distributed, launched

    device = resolve_device(device)
    if launched():
        init_distributed()
        create_mesh(None, tp, device=device)
        return step_once(device, **kw)
    import torch.multiprocessing as mp

    world = n_data * tp
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "result.pt")
        mp.start_processes(_rank, args=(world, tp, f"file://{tmp}/rendezvous", device.type,
                                        kw, out), nprocs=world, start_method="spawn")
        return torch.load(out, weights_only=False)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tp", nargs="?", type=int, default=2)
    ap.add_argument("n_data", nargs="?", type=int, default=1)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    tic = time.perf_counter()
    result = run(args.tp, args.n_data, args.device, dtype="bf16" if args.bf16 else "fp32")
    if not (result["finite"] and result["moved"]):
        raise RuntimeError(f"fullsize dp{args.n_data}xtp{args.tp}: {result}")
    print(f"fullsize dp{args.n_data}xtp{args.tp} ok: loss={result['loss']:.4f}, a split "
          f"in_proj_weight ({result['split_rows']} rows a rank) moved; "
          f"{result.get('backend', '')} init {result['init_s']:.1f}s, step "
          f"{result['step_s']:.1f}s, {time.perf_counter() - tic:.1f}s in all")
    return result


if __name__ == "__main__":
    main()
