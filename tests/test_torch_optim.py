"""The port's optimizer, schedules, parameter classes and config builds
(vtc_tpu_torch.training, vtc_tpu_torch.models.create_model) against the
JAX package's.

* ``param_labels`` on every parameter equals JAX's label of the same leaf.
  The leaf behind each of the port's names is found by filling every JAX
  leaf with its own index and carrying the tree across with
  ``state_dict_from_jax``.
* ``torch.optim`` with the port's groups against ``FusedOptimizer`` over 5
  steps of the same gradients: Adam and AdamW, amsgrad on and off, StepLR
  and the periodic cosine, one branch frozen (the model's ``freeze``
  against JAX's ``branch_to_freeze``); fp32 rounding apart
  (atol 1e-6, rtol 1e-6, as tests/test_optim_parity.py holds the fused
  optimizer to the optax chain).
* The refusals: unknown options, the accumulating step's divisibility and
  BatchNorm refusals, the loader's ``shard_by_process`` and multihost
  token truncation.
* Every ``configs/*.jsonc`` ``arch`` block builds at ``test-tiny`` on the
  CPU, the audio MLP and the MoE adapter included, and takes one train
  step (the loss finite, every trainable parameter moved by the update);
  the frozen branches have ``requires_grad=False`` where
  ``frozen_predicate`` says. The audio and MoE configs' labels and
  optimizer steps are held to JAX's as the flagship's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.training import optim as jax_optim
from vtc_tpu_torch.data import DataLoader, synthetic_tokens
from vtc_tpu_torch.models import create_model, frozen_predicate, state_dict_from_jax
from vtc_tpu_torch.training import (
    build_optimizer,
    global_truncate_tokens,
    make_lr_schedule,
    param_labels,
    train_step,
)
from vtc_tpu_torch.ops.losses import LOSSES
from vtc_tpu_torch.utils import jsonc

TINY = "test-tiny"
CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs").glob("*.jsonc"))
NOT_PORTED = {}
ARCHS = {"flagship": ("PretrainedCLIP_finaltf", {}),
         "video": ("PretrainedCLIP_TimeSformer_finaltf", {"nframes": 4}),
         "audio": ("PretrainedCLIP_finaltf", {"init_audio_model": True}),
         "moe": ("PretrainedCLIP_finaltf", {"moe_experts": 4, "moe_top_k": 2})}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def jax_model(request):
    """(arch kwargs, numpy params) of a JAX test-tiny model."""
    arch, kw = ARCHS[request.param]
    _, variables = jax_create_model(arch, model_type=TINY, seed=0, **kw)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    variables["params"])
    return (arch, kw), params


def _port(arch_kw, params, **kwargs):
    (arch, kw) = arch_kw
    model = create_model(arch, model_type=TINY, device="cpu", **kw, **kwargs)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _leaf_paths(tree):
    return [jax_optim._path_str(path)
            for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("freeze", [False, "visual", "text", "all", "finaltf"])
def test_param_labels_match_jax(jax_model, freeze):
    arch_kw, params = jax_model
    paths = _leaf_paths(params)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    indexed = treedef.unflatten([np.full(x.shape, i, np.float32)
                                 for i, x in enumerate(leaves)])
    jax_labels = dict(zip(paths, jax.tree_util.tree_leaves(
        jax_optim.param_labels(params, freeze))))
    model = _port(arch_kw, params)
    sd = state_dict_from_jax(indexed)
    ours = param_labels(model, freeze)
    assert sorted(ours) == sorted(n for n, _ in model.named_parameters())
    groups = set()
    for name, label in ours.items():
        path = paths[int(sd[name].flatten()[0])]
        assert label == jax_labels[path], (name, path)
        groups.add(label)
    if not freeze:
        time = {"time_decay", "time_nodecay"} if "TimeSformer" in arch_kw[0] else set()
        assert groups == {"rest_decay", "rest_nodecay", "adapter_decay",
                          "adapter_nodecay", "fc_decay"} | time


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), params)


SCHEDULES = {
    "steplr": {"type": "StepLR", "args": {"step_size": 1, "gamma": 0.5}},
    # T_max of 2 epochs at 1 step per epoch: 5 steps reach past T_max, where
    # torch's cosine rises again
    "cosine": {"type": "CosineAnnealingLR", "args": {"T_max": 2, "eta_min": 1e-4}},
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("opt_type,amsgrad", [
    ("Adam", True), ("Adam", False), ("AdamW", True), ("AdamW", False),
])
def test_optimizer_matches_fused_optimizer(jax_model, opt_type, amsgrad, schedule):
    arch_kw, params = jax_model
    cfg = {"type": opt_type, "args": {"lr": 1e-2, "weight_decay": 1e-2,
                                      "amsgrad": amsgrad}}
    spe = 2 if schedule == "steplr" else 1
    kw = dict(steps_per_epoch=spe, fc_lr=5e-3, time_lr=2e-3, adapter_lr=3e-2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_optim.build_optimizer(jparams, cfg, SCHEDULES[schedule],
                                   branch_to_freeze="text", **kw)
    state = tx.init(jparams)
    model = _port(arch_kw, params, freeze="text")
    optimizer, scheduler = build_optimizer(model, cfg, SCHEDULES[schedule], **kw)
    named = dict(model.named_parameters())
    for step in range(5):
        g = _grads(params, step)
        jparams, state = tx.apply(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        for name, grad in state_dict_from_jax(g).items():
            if name in named and named[name].requires_grad:  # not the BN buffers
                named[name].grad = grad
        optimizer.step()
        scheduler.step()
        optimizer.zero_grad(set_to_none=True)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    frozen = frozen_predicate("text")
    for name, p in named.items():
        assert p.requires_grad != frozen(name)
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    assert any(frozen(n) for n in named)


@pytest.mark.parametrize("cfg", [
    None,
    {"type": "StepLR", "args": {"step_size": 3, "gamma": 0.5}},
    {"type": "CosineAnnealingLR", "args": {"T_max": 4}},
    {"type": "CosineAnnealingLR", "args": {"T_max": 3, "eta_min": 0.01}},
    {"type": "ConstantLR"},
])
def test_lr_schedule_matches_jax(cfg):
    ours = make_lr_schedule(0.1, cfg, 10)
    ref = jax_optim.make_lr_schedule(0.1, cfg, 10)
    for step in (0, 9, 10, 29, 30, 40, 60, 79, 80, 123):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-9)


def test_lambda_lr_follows_the_schedule_per_group():
    """Each group's lr at step k (before the k-th update) is its own
    schedule at k, as ``FusedOptimizer`` reads it at its pre-increment
    count."""
    model = create_model("PretrainedCLIP_finaltf", model_type=TINY, device="cpu")
    sched_cfg = {"type": "StepLR", "args": {"step_size": 1, "gamma": 0.1}}
    optimizer, scheduler = build_optimizer(
        model, {"type": "Adam", "args": {"lr": 1e-3}}, sched_cfg,
        steps_per_epoch=3, adapter_lr=1e-2)
    for step in range(7):
        for g in optimizer.param_groups:
            base = 1e-2 if g["name"].startswith("adapter") else 1e-3
            assert g["lr"] == pytest.approx(make_lr_schedule(base, sched_cfg, 3)(step))
        optimizer.step()
        scheduler.step()


def test_unknown_or_unported_options_raise():
    model = create_model("PretrainedCLIP", model_type=TINY, device="cpu")
    with pytest.raises(ValueError, match="branch_to_freeze"):
        frozen_predicate("vissual")
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        build_optimizer(model, {"type": "SGD"})
    with pytest.raises(ValueError, match="Unknown lr_scheduler"):
        make_lr_schedule(0.1, {"type": "OneCycleLR"}, 1)
    with pytest.raises(ValueError, match="moments_dtype"):
        build_optimizer(model, {"type": "Adam", "args": {"moments_dtype": "int8"}})
    optimizer, scheduler = build_optimizer(model, {"type": "Adam"})
    data = [torch.zeros(6, 32), torch.zeros(6, 77, dtype=torch.int32)]
    with pytest.raises(ValueError, match="accum_steps=4 must divide the batch"):
        train_step(model, None, optimizer, scheduler, data, accum_steps=4)
    bn = create_model("PretrainedCLIP_finaltf", model_type=TINY, device="cpu",
                      residual_activation="bn")
    optimizer, scheduler = build_optimizer(bn, {"type": "Adam"})
    with pytest.raises(ValueError, match="BatchNorm running stats"):
        train_step(bn, None, optimizer, scheduler, data, accum_steps=2)
    with pytest.raises(NotImplementedError, match="shard_by_process"):
        DataLoader([0, 1], batch_size=1, shard_by_process=True)
    with pytest.raises(NotImplementedError, match="multihost"):
        global_truncate_tokens([np.zeros((2, 77), np.int32)], multihost=True)


@pytest.mark.parametrize("config", CONFIGS, ids=lambda p: p.stem)
def test_every_config_arch_builds(config):
    """Each config's ``arch`` block at ``test-tiny`` on the CPU; the frozen
    branches have ``requires_grad=False`` where ``frozen_predicate`` says;
    one train step moves trainable parameters only."""
    arch = jsonc.read_json(config)["arch"]
    args = dict(arch["args"], model_type=TINY)
    assert not NOT_PORTED
    model = create_model(arch["type"], device="cpu", **args)
    frozen = frozen_predicate(args.get("freeze", False))
    assert all(p.requires_grad != frozen(n) for n, p in model.named_parameters())
    for key in ("random_comment_masking", "random_skip_adapter"):
        if key in args:
            assert getattr(model, key) == args[key]
    if args.get("freeze"):
        assert any(frozen(n) for n, _ in model.named_parameters())
    # one train step with the config's optimizer and loss
    cfg = jsonc.read_json(config)
    rng = np.random.default_rng(0)
    b = 4
    if "TimeSformer" in arch["type"]:
        vis = rng.normal(size=(b, int(args.get("nframes", 8)), 3, 32, 32))
    else:
        vis = rng.normal(size=(b, 3, 32, 32))
    data = [torch.from_numpy(vis.astype(np.float32)),
            torch.from_numpy(synthetic_tokens((b,), 77, 10, rng))]
    if arch["type"] != "PretrainedCLIP" or args.get("comment_fusion") == "averaging":
        data.append(torch.from_numpy(synthetic_tokens((b, 5), 77, 10, rng)))
    if args.get("init_audio_model"):
        data.append(torch.from_numpy(rng.normal(size=(b, 5, 512)).astype(np.float32)))
    optimizer, scheduler = build_optimizer(model, cfg["optimizer"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, _ = train_step(model, LOSSES[cfg["loss"]], optimizer, scheduler, data,
                         generator=torch.Generator().manual_seed(0),
                         moe_aux_loss_weight=cfg.get("moe_aux_loss_weight", 0.01))
    assert np.isfinite(float(loss))
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    assert moved and all(not frozen(n) for n in moved)
