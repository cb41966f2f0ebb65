"""The multi-chip dry run at test-tiny on N ranks, the twin of
``__graft_entry__.dryrun_multichip``:

    python -m vtc_tpu_torch.scripts.dryrun_multichip N [--device cpu]

The JAX function's mesh arithmetic (``n_model`` 2 for an even N, else 1;
``n_data = N // n_model``), inputs and checks, in its order and at its
limits:

1. the TimeSformer flagship (``PretrainedCLIP_TimeSformer_finaltf``,
   test-tiny, 4 frames at 32², batch ``2·n_data``, 77-token random titles
   and 3 comments from ``default_rng(0)``; Adam with amsgrad at lr 1e-3,
   StepLR(10, 0.1), ``adapter_lr`` 1e-2, ``time_lr`` 1e-4) takes one
   ``train_step`` split over ``create_mesh(n_data, n_model)``
   (``parallel.tensor.shard_model``, DDP over data): its loss is finite and
   the CAM's ``final_transformer.resblocks.0.mlp.c_proj.weight`` moved;
2. the same step under ZeRO-3 (``parallel.mesh.fully_shard_model``): the
   loss within rtol 2e-5 of step 1's, the token embedding's local shard at
   most ``1/(n_data·n_model)`` of the table before and after;
3. at N % 4 == 0 the same step on ``create_mesh(N // 4, 2, n_replica=2)``:
   the loss within rtol 2e-5;
4. ``ops.retrieval.recall_at_k_sharded`` over the data group: R@1 = 1 on
   self-retrieval;
5. the text stack's blocks pipelined on ``create_pipeline_mesh(N // 2, 2)``
   (``n_micro`` 2) and on the ring of ``create_sp_mesh(N // 2, 2)``
   (``parallel.stack``), each within atol 2e-5 of the sequential stack;
6. a ``MoEMLP`` (2 experts, top 2, capacity factor 2) split over
   ``create_ep_mesh(N // 2, 2)`` within atol 2e-5 of the whole layer;
7. at N >= 4: the flagship step on the pipe and seq meshes against step 1's
   loss (rtol 2e-5); the MoE flagship (``freeze="all"``, the text branch
   adapted, 2 experts, top 2) on the expert mesh against its one-rank step
   (``parallel.mesh.as_one_process``); the accumulating step (``accum_steps``
   2, adapter skip off) against the plain step on the dp×tp mesh.

It prints ``dryrun_multichip(N) ok: mesh=..., loss=..., eval R@1=1.00``
with the JAX function's notes. ``checks`` is the rank function: callable in
any process group of N ranks (the spawn here, ``torchrun``'s, or a caller's
own), it leaves ``parallel.mesh``'s current mesh and ``parallel.stack``'s
switch as it found them and returns its numbers (each loss, each max
|diff|, R@1, the shard sizes, each check's kernel launches). It takes the
flagship's weights (``models.from_jax.state_dict_from_jax`` of JAX's) and
the global batch's adapter-skip draws, so that a test can hold step 1
against JAX's step.

Under ``torchrun`` (N processes) it runs in the launched ranks; otherwise
it spawns them: on the card over NCCL where the machine has a card for each
rank, else over gloo with every rank on card 0; on the CPU (``--device
cpu``) over gloo, each rank on one thread. Without a card and without
``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import copy
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

NFRAMES = 4
RTOL = 2e-5  # the losses against step 1's (the JAX function's limits)
ATOL = 2e-5  # the stacks and the MoE layer against their sequential twins
MODEL_KERNELS = ("layernorm", "add_layernorm", "fused_mha", "fused_attention")
OPTIMIZER = {"type": "Adam", "args": {"lr": 1e-3, "amsgrad": True}}
SCHEDULER = {"type": "StepLR", "args": {"step_size": 10, "gamma": 0.1}}
CAM_PROBE = "final_transformer.resblocks.0.mlp.c_proj.weight"


def mesh_shape(n_devices: int) -> tuple:
    """``(n_data, n_model)`` of N ranks, as the JAX function lays them."""
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // n_model, n_model


def _launches() -> dict:
    from .. import ops

    counts = ops.launch_counts()
    return {k: counts[k] for k in MODEL_KERNELS}


class _Checks:
    """The state the checks share: the device, the inputs, the weights and
    draws handed in, each check's numbers and launches."""

    def __init__(self, device, n_devices, state_dict, draws):
        self.device, self.n = device, n_devices
        self.state_dict, self.draws = state_dict, draws
        self.n_data, self.n_model = mesh_shape(n_devices)
        self.batch = 2 * self.n_data
        self.rng = np.random.default_rng(0)
        b = self.batch
        self.data = [self.rng.normal(size=(b, NFRAMES, 3, 32, 32)).astype(np.float32),
                     self.rng.integers(1, 49405, size=(b, 77)).astype(np.int32),
                     self.rng.integers(1, 49405, size=(b, 3, 77)).astype(np.int32)]
        self.out = {"launches": {}}

    def counted(self, name, fn):
        """``fn()``, its launches of the four model kernels kept under
        ``name`` (a difference of the counters: a caller's count goes on)."""
        before = _launches()
        result = fn()
        self.out["launches"][name] = {k: v - before[k] for k, v in _launches().items()}
        return result

    def flagship(self, arch="PretrainedCLIP_TimeSformer_finaltf", **kwargs):
        from ..models import create_model

        if arch == "PretrainedCLIP_TimeSformer_finaltf":
            kwargs["nframes"] = NFRAMES
        model = create_model(arch, model_type="test-tiny", seed=0, device=self.device,
                             **kwargs)
        if self.state_dict is not None and arch == "PretrainedCLIP_TimeSformer_finaltf":
            model.load_state_dict(self.state_dict, strict=True)
        return model

    def step(self, model, data, optimizer=OPTIMIZER, scheduler=SCHEDULER, draws=None,
             accum_steps=1, **opt_kw) -> float:
        """One ``train_step`` of ``model`` (split as it is) on this data rank's
        rows of ``data``, DDP over the data group where the model is not
        sharded; -> the loss."""
        from ..ops.losses import clip_loss
        from ..parallel.mesh import data_parallel, shard_batch
        from ..training import build_optimizer, train_step

        optimizer, scheduler = build_optimizer(model, optimizer, scheduler,
                                               steps_per_epoch=4, **opt_kw)
        local = [torch.from_numpy(np.ascontiguousarray(shard_batch(a))).to(self.device)
                 for a in data]
        gen = torch.Generator(self.device).manual_seed(0)
        loss, _ = train_step(data_parallel(model, self.device), clip_loss, optimizer,
                             scheduler, local, {}, generator=gen, draws=draws,
                             accum_steps=accum_steps)
        return float(loss)

    def flagship_step(self, model=None) -> float:
        """The TimeSformer flagship's step (``model``, else a fresh one split
        over the current mesh's model axis where it has one)."""
        from ..parallel.tensor import shard_model

        model = shard_model(self.flagship()) if model is None else model
        return self.step(model, self.data, draws=self.draws, adapter_lr=1e-2, time_lr=1e-4)


def _close(what: str, got: float, want: float, rtol: float = RTOL) -> None:
    if not abs(got - want) <= rtol * abs(want):
        raise AssertionError(f"{what}: loss {got!r} against {want!r} (rtol {rtol:g})")


def _max_diff(what: str, got: torch.Tensor, want: torch.Tensor, atol: float = ATOL) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not err <= atol:
        raise AssertionError(f"{what}: max |diff| {err:.3g} > atol {atol:g}")
    return err


def checks(device, n_devices=None, state_dict=None, draws=None) -> dict:
    """The dry run's checks on this rank of a process group of
    ``n_devices`` (default: the group's size) ranks on ``device`` (the
    module docstring); -> its numbers, every rank alike but for the
    launches. ``state_dict``: the TimeSformer flagship's weights (the
    port's seeded init without); ``draws``: the global batch's
    ``{"adapter_skip": [B, 1]}`` (drawn from a generator seeded 0 on every
    rank without)."""
    from ..parallel.mesh import kept_mesh
    from ..parallel.stack import set_stack_parallel

    device = torch.device(device)
    c = _Checks(device, n_devices or dist.get_world_size(), state_dict, draws)
    with kept_mesh():
        set_stack_parallel(None)
        _run(c)
    return c.out


def _run(c: _Checks) -> None:
    from ..models.layers import Transformer
    from ..ops.retrieval import recall_at_k_sharded
    from ..parallel.expert import MoEMLP, create_ep_mesh, global_routing, shard_experts
    from ..parallel.mesh import (
        as_one_process,
        create_mesh,
        data_group,
        fully_shard_model,
        kept_mesh,
        shard_batch,
        shard_rows,
    )
    from ..parallel.pipeline import create_pipeline_mesh
    from ..parallel.sequence import create_sp_mesh
    from ..parallel.stack import reset_stack_counts, set_stack_parallel, stack_counts
    from ..parallel.tensor import local_part, shard_model

    out, n, device = c.out, c.n, c.device
    if dist.get_world_size() != n:
        raise ValueError(f"dryrun_multichip({n}) in a group of {dist.get_world_size()} ranks")
    mesh = create_mesh(c.n_data, c.n_model, device=device)
    out["mesh"] = repr(mesh)

    # 1. the dp x tp step: finite, and the CAM's c_proj moved
    model = shard_model(c.flagship())
    probe = dict(model.named_parameters())[CAM_PROBE]
    before = probe.detach().clone()
    out["loss"] = c.counted("dp_tp", lambda: c.flagship_step(model))
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"the dp x tp step's loss is {out['loss']}")
    if torch.equal(before, probe.detach()):
        raise AssertionError(f"the dp x tp step left {CAM_PROBE} where it was")
    del model, probe, before

    # 2. ZeRO-3 on the same mesh: the loss, and the token embedding's shard
    # at most 1/(n_data·n_model) of the table before and after the step
    model = c.flagship()
    table = model.model.token_embedding.weight.numel()
    fully_shard_model(shard_model(model), device)
    emb = model.model.token_embedding.weight
    out["emb_shard"] = (local_part(emb).numel(), table)
    out["fsdp_loss"] = c.counted("fsdp", lambda: c.flagship_step(model))
    _close("the ZeRO-3 step", out["fsdp_loss"], out["loss"])
    after = local_part(model.model.token_embedding.weight).numel()
    if not (out["emb_shard"][0] == after and after * c.n_data * c.n_model <= table):
        raise AssertionError(f"the token embedding's shard holds {out['emb_shard'][0]} then "
                             f"{after} of {table} entries")
    del model, emb
    note = f", fsdp loss exact ({c.n_data}x state shards)"

    # 3. multi-slice: the step on a ("replica", "data", "model") mesh
    if n >= 4 and n % 4 == 0:
        with kept_mesh():
            create_mesh(n // 4, 2, n_replica=2, device=device)
            out["slices_loss"] = c.counted("slices", c.flagship_step)
        _close("the multi-slice step", out["slices_loss"], out["loss"])
        note += ", multislice (replica2) loss exact"

    # 4. the sharded recall over the data group: self-retrieval
    feats = c.rng.normal(size=(4 * n, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    out["recalls"] = recall_at_k_sharded(feats, feats, (1, 5), group=data_group(),
                                         device=device)
    if dict(out["recalls"])[1] != 1.0:
        raise AssertionError(f"self-retrieval R@1 {out['recalls']}")

    # 5-6. the text stack pipelined and on the ring; the split MoE layer
    if n >= 2:
        whole = c.flagship()
        v = whole.variant
        stack = Transformer(v.text_width, v.text_layers, v.text_heads).to(device)
        stack.load_state_dict({k[len("model.transformer."):]: t for k, t in
                               whole.state_dict().items()
                               if k.startswith("model.transformer.")})
        del whole
        x = torch.from_numpy(c.rng.normal(size=(4, 8, v.text_width)).astype(np.float32)
                             ).to(device)
        with torch.no_grad():
            seq_out = c.counted("stack", lambda: stack(x, True))
            for mode, make, key in (("pipe", create_pipeline_mesh, "pp"),
                                    ("seq", create_sp_mesh, "sp")):
                with kept_mesh():
                    stack_mesh = make(n // 2, 2, device=device)
                    out[f"{key}_mesh"] = repr(stack_mesh)
                    set_stack_parallel(mode, stack_mesh, n_micro=2)
                    reset_stack_counts()
                    got = c.counted(f"{key}_stack", lambda: stack(x, True))
                    ran = dict(stack_counts())
                want = {"pipe": {"pipelined": 1}, "seq": {"ring": 1}}[mode]
                if ran != want:
                    raise AssertionError(f"the {key}2 text stack ran {ran}, not {want}")
                out[f"{key}_stack_err"] = _max_diff(f"the {key}2 text stack", got, seq_out)
        note += f", pp2 text stack exact on {out['pp_mesh']}, sp2 ring attention exact"

        moe = MoEMLP(v.text_width, 2, top_k=2, capacity_factor=2.0).to(device)
        gen = torch.Generator().manual_seed(2)
        with torch.no_grad():
            moe.router.copy_(0.02 * torch.randn(moe.router.shape, generator=gen))
            for p in (moe.w_fc, moe.w_proj):  # lecun_normal per expert
                p.copy_(p.shape[1] ** -0.5 * torch.randn(p.shape, generator=gen))
            xt = x.reshape(-1, v.text_width)
            want = moe(xt)
            with kept_mesh():
                create_ep_mesh(n // 2, 2, device=device)
                split = shard_experts(copy.deepcopy(moe))
                with global_routing():
                    got = c.counted("ep_layer", lambda: split(shard_batch(xt)))
                want = want[shard_rows(xt.shape[0])]
            out["ep_layer_err"] = _max_diff("the ep2 MoE layer", got, want)
        note += ", ep2 MoE exact"

    # 7. the full flagship step pipelined and on the ring, the MoE flagship on
    # an expert mesh, the accumulating step on the dp x tp mesh
    if n >= 4 and n % 2 == 0:
        for mode, make, key in (("pipe", create_pipeline_mesh, "pp"),
                                ("seq", create_sp_mesh, "sp")):
            with kept_mesh():
                set_stack_parallel(mode, make(n // 2, 2, device=device), n_micro=2)
                out[f"{key}_loss"] = c.counted(key, c.flagship_step)
            _close(f"the flagship's {key}2 step", out[f"{key}_loss"], out["loss"])
        note += ", full-flagship pp2/sp2 train-step loss exact"

        img = c.rng.normal(size=(c.batch, 3, 32, 32)).astype(np.float32)
        moe_kw = dict(freeze="all", branch_to_adapt="text", branch_to_adapt_val="text",
                      moe_experts=2, moe_top_k=2)
        moe_data = [img] + c.data[1:]
        moe_opt = {"type": "Adam", "args": {"lr": 1e-3}}
        with as_one_process():
            out["moe_ref_loss"] = c.step(c.flagship("PretrainedCLIP_finaltf", **moe_kw),
                                         moe_data, moe_opt, None)
        with kept_mesh():
            create_ep_mesh(n // 2, 2, device=device)
            split = shard_experts(c.flagship("PretrainedCLIP_finaltf", **moe_kw))
            out["moe_ep_loss"] = c.counted("moe_ep", lambda: c.step(
                split, moe_data, moe_opt, None))
        _close("the MoE flagship's ep2 step", out["moe_ep_loss"], out["moe_ref_loss"])
        note += ", MoE-flagship ep2 train-step loss exact"

        for key, accum in (("plain", 1), ("accum", 2)):
            det = shard_model(c.flagship(random_skip_adapter=False))
            out[f"{key}_loss"] = c.counted(key, lambda: c.step(
                det, c.data, {"type": "Adam", "args": {"lr": 1e-3}}, None,
                accum_steps=accum))
        _close("the accumulating step", out["accum_loss"], out["plain_loss"])
        note += ", accum2 loss exact on the dp mesh"

    out["line"] = (f"dryrun_multichip({n}) ok: mesh={out['mesh']}, loss={out['loss']:.4f}, "
                   f"eval R@1={dict(out['recalls'])[1]:.2f}{note}")


def _rank(rank: int, world: int, init: str, device_type: str, out: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if device_type == "cpu":
        torch.set_num_threads(1)
    nccl = device_type == "cuda" and torch.cuda.device_count() >= world
    if device_type == "cuda":  # gloo: every rank on card 0
        os.environ["LOCAL_RANK"] = str(rank if nccl else 0)
        torch.cuda.set_device(rank if nccl else 0)
    device = torch.device("cuda", rank if nccl else 0) if device_type == "cuda" \
        else torch.device("cpu")
    dist.init_process_group("nccl" if nccl else "gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        result = checks(device, world)
        result["backend"] = dist.get_backend()
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def run(n_devices: int = 4, device=None) -> dict:
    """The checks on ``n_devices`` ranks (spawned here, or the ``torchrun``
    group this process is a rank of); -> rank 0's numbers (every rank's
    under torchrun is its own)."""
    from ..device import resolve_device
    from ..utils.util import init_distributed, launched

    device = resolve_device(device)
    if launched():
        init_distributed()
        return checks(device, n_devices)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "result.pt")
        mp.start_processes(_rank, args=(n_devices, f"file://{tmp}/rendezvous", device.type,
                                        out), nprocs=n_devices, start_method="spawn")
        return torch.load(out, weights_only=False)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    tic = time.perf_counter()
    result = run(args.n_devices, args.device)
    print(f"{result['line']}; {result.get('backend', '')} {time.perf_counter() - tic:.1f}s")
    return result


if __name__ == "__main__":
    main()
