"""The port's training loop (vtc_tpu_torch) against the JAX package's, on the
same weights and inputs, on the CPU, at ``test-tiny``.

* The accumulating step (GradCache, ``accum_steps = 4``) against
  ``make_step_fns(accum_steps=4)`` over 2 steps, JAX's per-microbatch
  adapter-skip draws read from its output and fed to the port, at the
  tolerances of ``test_three_train_steps_match_jax``; and against the
  port's plain step on one batch (loss at 1e-6, gradients at 2e-5 of each
  parameter's largest with rtol 1e-4, as the flagship's gradient test), with
  its refusals.
* bf16 moments against ``FusedOptimizer(moments_dtype="bfloat16")`` over 5
  steps: parameters at atol 1e-6 / rtol 1e-6 (as
  ``test_optimizer_matches_fused_optimizer``), each stored moment within
  one bf16 ulp.
* ``normalize_uint8_images`` bit for bit; the loader's batches, collation
  and worker errors; the retrieval metrics with ties and a gallery smaller
  than ``k``; ``RecallAtK``/``MetricTracker``; ``ConfigParser``'s overrides
  and run layout; checkpoints across the two packages.
* The ``Trainer`` against JAX's ``Trainer`` over 2 epochs (each epoch's
  loss within 1e-5, R@K keys and values equal, the same best epoch, final
  parameters within Adam's bound of ``lr`` per step), and the port's
  Trainer alone: resume round trips, the optimizer-state guards,
  ``len_epoch`` mode, the zero-batch validation warning, two runs bitwise
  equal, the profiler trace and the probe hook.

The JAX compiles sit in module-scoped fixtures.
"""

import argparse
import copy
import logging
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.models.retrieval import PretrainedCLIP_finaltf as JaxFlagship
from vtc_tpu.ops import losses as jax_losses
from vtc_tpu_torch.config import ConfigParser, CustomArgs
from vtc_tpu_torch.data import (
    DataLoader,
    default_collate,
    extract_patches,
    normalize_uint8_images,
    prefetch_to_device,
    synthetic_tokens,
)
from vtc_tpu_torch.models import create_model, frozen_predicate, state_dict_from_jax
from vtc_tpu_torch.models.retrieval import PretrainedCLIP_finaltf
from vtc_tpu_torch.ops import losses
from vtc_tpu_torch.ops import retrieval as ret
from vtc_tpu_torch.training import (
    MetricTracker,
    RecallAtK,
    Trainer,
    assert_warm_start_keys,
    build_optimizer,
    graft_params,
    load_checkpoint,
    save_checkpoint,
    train_step,
)

TINY = "test-tiny"
DIM = 32
ATOL, RTOL = 2e-5, 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """test-tiny runs thousands of small ops, which lose to intra-op threads
    that the test runner's other workers are competing for: one thread per
    op while this module runs, the setting restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def flagship():
    """numpy params of the test-tiny flagship with the CAM moved off its
    zero-init, so its gradients are not trivially zero."""
    _, variables = jax_create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=0)
    params = _np_tree(variables["params"])
    rng = np.random.default_rng(0)
    params["cam"] = jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), params["cam"])
    return params


def _port(params, batch_stats=None, **kwargs):
    """The port's flagship on ``params``, its frozen branches without
    gradients as ``create_model`` leaves them."""
    model = PretrainedCLIP_finaltf(model_type=TINY, **kwargs)
    model.load_state_dict(state_dict_from_jax(params, batch_stats), strict=True)
    frozen = frozen_predicate(model.freeze)
    for name, p in model.named_parameters():
        p.requires_grad_(not frozen(name))
    return model


def _inputs(batch=8, seed=0, ntoks=16):
    """bench.py's recipe at test-tiny: uint8 patches, a title and 5
    comments, one comment empty."""
    rng = np.random.default_rng(seed)
    vis = extract_patches(rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8), 8)
    title = synthetic_tokens((batch,), ntoks, 14, rng)
    comments = synthetic_tokens((batch, 5), ntoks, 14, rng)
    comments[0, 4] = 0
    comments[0, 4, :2] = (49406, 49407)
    return vis, title, comments


def _skipped_rows(feats_text_train, feats_title):
    """JAX's adapter-skip draw, read from its output: a skipped row is the
    normalized title feature itself."""
    diff = np.abs(np.asarray(feats_text_train) - np.asarray(feats_title)).max(-1)
    skip = diff < 1e-4
    assert np.all((diff < 1e-4) | (diff > 1e-2)), diff
    return torch.from_numpy(skip[:, None])


def _microbatch_draws(draws, k):
    """Batch-order draws -> one dict per microbatch (rows i, i+k, ...)."""
    rows = {"adapter_skip": lambda d, i: d[i::k], "comment_mask": lambda d, i: d[:, i::k]}
    return [{n: rows[n](d, i) for n, d in draws.items()} for i in range(k)]


def _first_grads(optimizer, model):
    """Record the gradients the optimizer sees at its first step."""
    grads = {}

    def hook(opt, args, kwargs):
        if not grads:
            grads.update({n: None if p.grad is None else p.grad.detach().clone()
                          for n, p in model.named_parameters()})

    optimizer.register_step_pre_hook(hook)
    return grads


# ---- the accumulating step ----------------------------------------------------

OPT = {"type": "Adam", "args": {"lr": 1e-3, "weight_decay": 1e-4, "amsgrad": True}}
SCHED = {"type": "StepLR", "args": {"step_size": 1, "gamma": 0.5}}
STEP_KW = dict(steps_per_epoch=2, adapter_lr=1e-2, fc_lr=2e-3)


@pytest.fixture(scope="module")
def jax_accum_run(flagship):
    """Two steps of ``make_step_fns(accum_steps=4)`` on a batch of 8: each
    step's loss, the adapter-skip rows it drew (read from its output) and the
    final params."""
    from vtc_tpu.training.optim import build_optimizer as jax_build_optimizer
    from vtc_tpu.training.trainer import TrainState, make_step_fns

    module = JaxFlagship(model_type=TINY)
    params = _j(flagship)
    tx = jax_build_optimizer(params, OPT, SCHED, **STEP_KW)
    step, evaluate = make_step_fns(module, jax_losses.clip_loss, tx, donate=False,
                                   accum_steps=4)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), batch_stats={})
    data = tuple(jnp.asarray(a) for a in _inputs(seed=1))
    losses_j, skips = [], []
    for k in range(2):
        title = evaluate(state, data, {}, branch_override="skip")[1][1]
        state, loss, out = step(state, data, {}, jax.random.PRNGKey(k))
        losses_j.append(float(loss))
        skips.append(_skipped_rows(out[1], title))
    return losses_j, skips, _np_tree(state.params)


def test_accumulating_step_matches_jax(flagship, jax_accum_run):
    """``train_step(accum_steps=4)`` against ``make_step_fns``' accumulating
    step with the fused 4-group Adam (amsgrad, L2 decay, StepLR): each
    step's loss, then every parameter within Adam's bound of ``lr`` per
    step, and most of them far closer."""
    losses_j, skips, params_j = jax_accum_run
    assert 0 < int(sum(s.sum() for s in skips)) < 16  # both kinds of row
    port = _port(flagship)
    optimizer, scheduler = build_optimizer(port, OPT, SCHED, **STEP_KW)
    data = [torch.from_numpy(a) for a in _inputs(seed=1)]
    for k in range(2):
        draws = _microbatch_draws({"adapter_skip": skips[k]}, 4)
        loss, out = train_step(port, losses.clip_loss, optimizer, scheduler, data, {},
                               draws=draws, accum_steps=4)
        np.testing.assert_allclose(_np(loss), losses_j[k], atol=1e-5, rtol=1e-5)
        assert out[2].shape == (8, 8)
        assert all(p.grad is None for p in port.parameters())
    ref = state_dict_from_jax(params_j)
    lr = {id(p): g["initial_lr"] for g in optimizer.param_groups for p in g["params"]}
    rel = []
    for name, p in port.named_parameters():
        d = np.abs(_np(p) - _np(ref[name])) / lr[id(p)]
        assert d.max() <= 2 * 2, (name, d.max())  # each step moves at most lr
        rel.append(d.ravel())
    assert np.quantile(np.concatenate(rel), 0.99) < 1e-2  # the bulk: 1% of lr


@pytest.mark.parametrize("k,masking", [(2, False), (4, False), (4, True)])
def test_accumulating_step_matches_plain_step(flagship, k, masking):
    """The exact large-batch InfoNCE: the accumulating step's loss, output
    and every gradient equal the plain step's on the same batch with the same
    draws (the batch's draws split as its microbatches), which a mean of
    per-microbatch losses would not; ``logit_scale`` takes its gradient once."""
    data = [torch.from_numpy(a) for a in _inputs(seed=3)]
    gen = torch.Generator().manual_seed(k)
    draws = {"adapter_skip": torch.rand((8, 1), generator=gen) > 0.5}
    if masking:
        draws["comment_mask"] = torch.randint(0, 2, (5, 8, 1), generator=gen)
    runs = []
    for accum in (1, k):
        port = _port(flagship, random_comment_masking=masking)
        optimizer, scheduler = build_optimizer(port, OPT, SCHED, **STEP_KW)
        grads = _first_grads(optimizer, port)
        loss, out = train_step(port, losses.clip_loss, optimizer, scheduler, data, {},
                               draws=draws if accum == 1 else _microbatch_draws(draws, k),
                               accum_steps=accum)
        runs.append((loss, out, grads))
    (loss_p, out_p, grads_p), (loss_a, out_a, grads_a) = runs
    np.testing.assert_allclose(_np(loss_a), _np(loss_p), atol=1e-6)
    for a, p in zip(out_a, out_p):
        np.testing.assert_allclose(_np(a), _np(p), atol=3e-4)
    assert sorted(grads_a) == sorted(grads_p)
    for name, g in grads_p.items():
        assert (grads_a[name] is None) == (g is None), name
        if g is None:
            continue
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(_np(grads_a[name]), _np(g), atol=ATOL * scale,
                                   rtol=RTOL, err_msg=name)
    assert float(grads_a["model.logit_scale"].abs()) > 0


@pytest.mark.parametrize("case", ["batchnorm", "divisibility", "draws"])
def test_accumulating_step_refusals(flagship, case):
    """A model with BatchNorm running stats (the CAM's ``bn``/``sub_mean``),
    a batch that ``k`` does not divide, and draws not one per microbatch
    raise ``ValueError``, as ``accum_train_step`` does."""
    kwargs = {"residual_activation": "bn"} if case == "batchnorm" else {}
    stats = {"cam": {"mean": np.zeros(DIM, np.float32), "var": np.ones(DIM, np.float32)}}
    port = _port(flagship, stats if case == "batchnorm" else None, **kwargs)
    optimizer, scheduler = build_optimizer(port, OPT)
    data = [torch.from_numpy(a) for a in _inputs()]
    k = 3 if case == "divisibility" else 2
    draws = [{}] if case == "draws" else None
    match = {"batchnorm": "BatchNorm", "divisibility": "must divide",
             "draws": "one dict of draws per microbatch"}[case]
    with pytest.raises(ValueError, match=match):
        train_step(port, losses.clip_loss, optimizer, scheduler, data, {},
                   draws=draws, accum_steps=k)


# ---- bf16 optimizer moments --------------------------------------------------

def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (normal numbers)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("opt_type,amsgrad", [
    ("Adam", True), ("Adam", False), ("AdamW", True), ("AdamW", False),
])
def test_bf16_moments_match_fused_optimizer(flagship, opt_type, amsgrad):
    from vtc_tpu.training import optim as jax_optim

    cfg = {"type": opt_type, "args": {"lr": 1e-2, "weight_decay": 1e-2,
                                      "amsgrad": amsgrad, "moments_dtype": "bfloat16"}}
    kw = dict(steps_per_epoch=2, fc_lr=5e-3, adapter_lr=3e-2)
    jparams = _j(flagship)
    tx = jax_optim.build_optimizer(jparams, cfg, SCHED, **kw)
    state = tx.init(jparams)
    model = _port(flagship)
    optimizer, scheduler = build_optimizer(model, cfg, SCHED, **kw)
    named = dict(model.named_parameters())
    for step in range(5):
        rng = np.random.default_rng(100 + step)
        g = jax.tree_util.tree_map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), flagship)
        jparams, state = tx.apply(_j(g), state, jparams)
        for name, grad in state_dict_from_jax(g).items():
            named[name].grad = grad
        optimizer.step()
        scheduler.step()
        optimizer.zero_grad(set_to_none=True)
    ref = state_dict_from_jax(_np_tree(jparams))
    moments = {"exp_avg": state.mu, "exp_avg_sq": state.nu}
    if amsgrad:
        moments["max_exp_avg_sq"] = state.nu_max
    moments = {k: state_dict_from_jax(_np_tree(v)) for k, v in moments.items()}
    for name, p in named.items():
        np.testing.assert_allclose(_np(p), _np(ref[name]), atol=1e-6, rtol=1e-6,
                                   err_msg=name)
        st = optimizer.state[p]
        assert sorted(st) == sorted(["step"] + list(moments))
        for key, tree in moments.items():
            assert st[key].dtype == torch.bfloat16
            ours, theirs = _np(st[key]), _np(tree[name])
            tol = _bf16_ulp(np.maximum(np.abs(ours), np.abs(theirs)))
            assert np.all(np.abs(ours - theirs) <= tol), (name, key)


def test_moments_dtype_refuses_unknown():
    model = create_model("PretrainedCLIP", model_type=TINY, device="cpu")
    with pytest.raises(ValueError, match="moments_dtype"):
        build_optimizer(model, {"type": "Adam", "args": {"moments_dtype": "float16"}})


# ---- preprocessing, loader, metrics, config ------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((2, 4, 8, 8, 3), np.uint8), ((3, 8, 8, 3), np.uint8),
    ((2, 16, 192), np.uint8), ((2, 3, 8, 8), np.float32), ((2, 8, 8, 3), np.float32),
])
def test_normalize_uint8_images_matches_jax(shape, dtype):
    from vtc_tpu.data.preprocess import normalize_uint8_images as jax_normalize

    rng = np.random.default_rng(7)
    x = (rng.integers(0, 256, shape) if dtype == np.uint8
         else rng.normal(size=shape)).astype(dtype)
    ref = np.asarray(jax_normalize(jnp.asarray(x)))
    ours = normalize_uint8_images(torch.from_numpy(x))
    assert ours.dtype == torch.from_numpy(ref).dtype and tuple(ours.shape) == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)


class _ItemDataset:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"item {i} is broken")
        return (np.full(3, i, np.int32), (i, float(i) / 2)), {"id": i, "name": f"x{i}"}


def _same_batches(ours, ref):
    assert type(ours) is type(ref)
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            _same_batches(ours[k], ref[k])
    elif isinstance(ref, tuple):
        assert len(ours) == len(ref)
        for o, r in zip(ours, ref):
            _same_batches(o, r)
    elif isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    else:
        assert ours == ref


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_match_jax(num_workers, drop_last):
    """The same batches as JAX's loader over 2 epochs: the shuffle of
    ``seed + epoch``, ``drop_last``, and ``default_collate`` of nested
    tuples, dicts and strings."""
    from vtc_tpu.data.loader import DataLoader as JaxDataLoader

    ds = _ItemDataset(22)
    kw = dict(batch_size=5, shuffle=True, drop_last=drop_last, num_workers=num_workers,
              seed=11)
    ours, ref = DataLoader(ds, **kw), JaxDataLoader(ds, **kw)
    assert len(ours) == len(ref)
    for _ in range(2):
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == len(ref)
        for x, y in zip(a, b):
            _same_batches(x, y)
    assert a[0][0][0].shape == (5, 3) and a[0][1]["name"][0].startswith("x")


def test_default_collate_matches_jax():
    from vtc_tpu.data.loader import default_collate as jax_collate

    items = [((np.arange(2) + i, (i, 0.5 * i)), {"id": i, "tag": f"t{i}",
                                                   "arr": np.ones((2, 2)) * i})
             for i in range(3)]
    _same_batches(default_collate(items), jax_collate(items))


def test_loader_worker_error_surfaces():
    loader = DataLoader(_ItemDataset(20, fail_at=7), batch_size=4, num_workers=2)
    with pytest.raises(KeyError, match="item 7 is broken"):
        list(loader)
    # without a process group, each process's slice is the whole stream
    sharded = DataLoader(_ItemDataset(4), batch_size=2, shard_by_process=True)
    assert len(sharded) == 2 and sharded.process_count == 1


def test_prefetch_to_device_on_the_cpu():
    """Arrays become tensors in order, strings pass through; no device means
    the card, which raises here."""
    batches = [((np.full((2, 3), i), np.arange(2)), {"id": np.arange(2) + i,
                                                    "name": ["a", "b"]})
               for i in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu", size=2))
    assert len(out) == 5
    for i, ((x, y), meta) in enumerate(out):
        assert isinstance(x, torch.Tensor) and int(x[0, 0]) == i
        assert torch.equal(meta["id"], torch.arange(2) + i) and meta["name"] == ["a", "b"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(prefetch_to_device(iter(batches)))


def _retrieval_cases():
    rng = np.random.default_rng(5)
    g = rng.normal(size=(12, 16)).astype(np.float32)
    g[5] = g[2]
    g[9] = g[2]  # duplicated gallery rows: ties, lower index first
    q = g + rng.normal(0, 0.3, g.shape).astype(np.float32)
    q[5] = g[2]  # query 5's target ties with items 2 and 9
    small = g[:4]
    ragged = g.copy()
    ragged[7] = -np.inf  # a padded row ranks last
    return {
        "ties": (g, q, None),
        "gallery smaller than k": (small, q[:4], None),
        "targets": (small, q, np.arange(12) % 4),
        "non-finite": (ragged, q, None),
    }


@pytest.mark.parametrize("case", sorted(_retrieval_cases()))
def test_retrieval_metrics_match_jax(case):
    from vtc_tpu.ops import retrieval as jax_ret

    gallery, queries, targets = _retrieval_cases()[case]
    k_vals = (1, 2, 5, 10)
    ref = jax_ret.recall_at_k(gallery, queries, k_vals, targets)
    assert ret.recall_at_k(gallery, queries, k_vals, targets, device="cpu") == ref
    assert ret.recall_at_k(torch.from_numpy(gallery), torch.from_numpy(queries),
                           k_vals, targets) == ref
    np.testing.assert_array_equal(
        ret.ranks_of_targets(gallery, queries, targets, device="cpu"),
        jax_ret.ranks_of_targets(gallery, queries, targets))
    assert (ret.retrieval_metrics(gallery, queries, k_vals, targets, device="cpu")
            == jax_ret.retrieval_metrics(gallery, queries, k_vals, targets))
    if case == "ties":
        assert dict(ref)[1] < 1.0  # the tie costs query 5 its hit at 1


def test_recall_metric_and_tracker_match_jax():
    from vtc_tpu.training.metrics import LossMetric as JaxLossMetric
    from vtc_tpu.training.metrics import MetricTracker as JaxTracker
    from vtc_tpu.training.metrics import RecallAtK as JaxRecall
    from vtc_tpu_torch.training import LossMetric

    rng = np.random.default_rng(9)
    batches = [(rng.normal(size=(6, 8)).astype(np.float32),
                rng.normal(size=(6, 8)).astype(np.float32)) for _ in range(3)]
    ours = MetricTracker(RecallAtK("visual", "titles", [1, 5]), LossMetric())
    ref = JaxTracker(JaxRecall("visual", "titles", [1, 5]), JaxLossMetric())
    for i, (a, b) in enumerate(batches):
        ours.update(0.5 * i, (torch.from_numpy(a), torch.from_numpy(b)), {})
        ref.update(0.5 * i, (a, b), {})
    result = ours.result()
    assert result == ref.result()
    assert "titles_from_visual-recall_at_5" in result and result["loss"] == 0.5
    ours.reset()
    assert ours.result() == {"loss": 0.0}


def _config(save_dir, epochs=2, **trainer):
    return {
        "name": "slice",
        "batch_size": 8,
        "arch": {"type": "PretrainedCLIP_finaltf",
                 "args": {"model_type": TINY, "random_skip_adapter": False}},
        "optimizer": {"type": "Adam", "args": {"lr": 1e-3, "weight_decay": 0,
                                               "amsgrad": True}},
        "loss": "clip_loss",
        "metrics": [{"type": "RecallAtK", "args": {"name_a": "visual", "name_b": "titles",
                                                    "k_vals": [1, 10]}}],
        "lr_scheduler": {"type": "StepLR", "args": {"step_size": 1, "gamma": 0.5}},
        "trainer": dict({
            "epochs": epochs, "save_dir": str(save_dir), "save_period": 1,
            "verbosity": 2, "monitor": "max val_titles_from_visual-recall_at_10",
            "early_stop": 10, "tensorboard": False,
        }, **trainer),
    }


def test_config_parser_matches_jax(tmp_path, monkeypatch):
    """The same ``;``-path overrides, run-dir layout and saved config as
    JAX's ``ConfigParser``, from a dict and from the command line (with a
    resume that re-reads the run's config); ``init_obj`` builds from a
    section; a multihost config made before its process group exists
    defers its run dir to ``finalize_run_dir``, as JAX's does."""
    from vtc_tpu.config import ConfigParser as JaxConfigParser
    from vtc_tpu.utils import read_json as jax_read_json

    mod = {"trainer;epochs": 5, "optimizer;args;lr": 0.5, "batch_size": None}
    made = {}
    for name, cls in (("port", ConfigParser), ("jax", JaxConfigParser)):
        cfg = _config(tmp_path / name)
        first = cls(copy.deepcopy(cfg), modification=mod)
        second = cls(copy.deepcopy(cfg))
        made[name] = (first, second)
        for c in (first, second):
            assert c.save_dir.parent == tmp_path / name / "models" / "slice"
            assert re.fullmatch(r"\d{3}_[A-Za-z]{3}\d{2}_\d{2}:\d{2}", c.save_dir.name)
            assert c.log_dir == c.save_dir
        assert (first.save_dir.name[:3], second.save_dir.name[:3]) == ("001", "002")
    (port, _), (jax_cfg, _) = made["port"], made["jax"]

    def same_but_save_dir(a, b):
        a, b = copy.deepcopy(a), copy.deepcopy(b)
        assert a["trainer"].pop("save_dir") != b["trainer"].pop("save_dir")
        assert a == b

    same_but_save_dir(port.config, jax_cfg.config)
    assert port["trainer"]["epochs"] == 5 and port["batch_size"] == 8
    same_but_save_dir(jax_read_json(port.save_dir / "config.json"),
                      jax_read_json(jax_cfg.save_dir / "config.json"))
    opt = port.init_obj("optimizer", torch.optim, [torch.nn.Parameter(torch.zeros(1))])
    assert isinstance(opt, torch.optim.Adam) and opt.defaults["lr"] == 0.5
    assert port.get_logger("x", 0).level == logging.WARNING

    ckpt = port.save_dir / "checkpoint-epoch1.pth"
    options = [CustomArgs(["--lr", "--learning_rate"], float, "optimizer;args;lr")]
    for name, cls in (("port", ConfigParser), ("jax", JaxConfigParser)):
        parser = argparse.ArgumentParser()
        parser.add_argument("-c", "--config", default=None)
        parser.add_argument("-r", "--resume", default=None)
        monkeypatch.setattr(sys, "argv", ["train", "-r", str(ckpt), "--lr", "0.25"])
        parsed = cls.from_args(parser, options)
        assert parsed.resume == ckpt and parsed["optimizer"]["args"]["lr"] == 0.25
        made[name] = parsed
    assert made["port"].config == made["jax"].config
    deferred = {}
    for name, cls in (("port", ConfigParser), ("jax", JaxConfigParser)):
        deferred[name] = cls(dict(_config(tmp_path / "mh" / name), multihost=1))
        with pytest.raises(RuntimeError, match="finalize_run_dir"):
            deferred[name].save_dir
        assert not (tmp_path / "mh" / name).exists()
    # the port's finalize_run_dir without a group is one process's (JAX's
    # needs jax.distributed)
    run_dir = deferred["port"].finalize_run_dir()
    assert deferred["port"].save_dir == run_dir and (run_dir / "config.json").exists()
    assert deferred["port"].finalize_run_dir() == run_dir  # once


# ---- checkpoints across the packages -----------------------------------------

def test_port_checkpoint_loads_in_jax(flagship, tmp_path):
    """The port's ``.pth`` (with its optimizer and schedule) reads in
    ``vtc_tpu.training.checkpoints.load_checkpoint`` as the JAX tree it came
    from, leaf for leaf."""
    from vtc_tpu.training.checkpoints import load_checkpoint as jax_load

    port = _port(flagship)
    optimizer, scheduler = build_optimizer(port, OPT, SCHED, **STEP_KW)
    path = save_checkpoint(tmp_path, "checkpoint-epoch3", arch="PretrainedCLIP_finaltf",
                           epoch=3, state_dict=port.state_dict(), optimizer=optimizer,
                           lr_scheduler=scheduler, monitor_best=0.75, config=OPT)
    assert path.name == "checkpoint-epoch3.pth"
    ckpt = jax_load(path)
    assert (ckpt["arch"], int(ckpt["epoch"]), float(ckpt["monitor_best"])) == (
        "PretrainedCLIP_finaltf", 3, 0.75)
    ours = jax.tree_util.tree_leaves_with_path(ckpt["params"])
    ref = jax.tree_util.tree_leaves_with_path(flagship)
    assert [p for p, _ in ours] == [p for p, _ in ref]
    for (path_, a), (_, b) in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path_))


def test_jax_torch_checkpoint_resumes_in_port(flagship, tmp_path):
    """JAX's ``save_torch_checkpoint`` output loads strictly into the port
    and resumes a ``Trainer``: epoch pointer, ``monitor_best``, every
    parameter; it holds no optimizer state, which starts fresh."""
    from vtc_tpu.models.torch_export import save_torch_checkpoint

    path = tmp_path / "model_best.pth"
    save_torch_checkpoint(path, flagship, arch="PretrainedCLIP_finaltf", epoch=4,
                          monitor_best=0.625, config={"optimizer": OPT})
    PretrainedCLIP_finaltf(model_type=TINY).load_state_dict(
        load_checkpoint(path)["state_dict"], strict=True)
    cfg = ConfigParser(_config(tmp_path / "run", epochs=6), resume=path)
    model = create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=5, device="cpu")
    optimizer, scheduler = build_optimizer(model, OPT)
    trainer = Trainer(model, losses.clip_loss, [], optimizer, scheduler, cfg,
                      DataLoader(_PatchDataset(8), 4), arch_name="PretrainedCLIP_finaltf",
                      device="cpu")
    assert trainer.start_epoch == 5 and trainer.mnt_best == 0.625
    ref = state_dict_from_jax(flagship)
    for name, p in model.named_parameters():
        assert torch.equal(p, ref[name]), name
    assert not optimizer.state and scheduler.last_epoch == 0


def test_warm_start_image_to_video():
    """Image CAM state dict -> TimeSformer video model, as
    ``test_warm_start_image_to_video``: with the surgery nothing is missing or
    unexpected; without it only time/temporal keys are missing, which the
    guard accepts, and it rejects anything else."""
    from vtc_tpu_torch.models.clip_model import CLIP_VARIANTS
    from vtc_tpu_torch.models.timesformer import timesformer_params_from_clip_visual

    image = create_model("PretrainedCLIP_finaltf", model_type=TINY, device="cpu")
    video = create_model("PretrainedCLIP_TimeSformer_finaltf", model_type=TINY,
                         nframes=4, seed=1, device="cpu")
    img_sd, vid_sd = image.state_dict(), video.state_dict()
    prefix = "model.visual."
    surgery = timesformer_params_from_clip_visual(
        {k[len(prefix):]: v for k, v in img_sd.items() if k.startswith(prefix)},
        CLIP_VARIANTS[TINY], nframes=4)
    warm = {k: v for k, v in img_sd.items() if not k.startswith(prefix)}
    warm.update({prefix + k: v for k, v in surgery.items()})
    merged, missing, unexpected = graft_params(vid_sd, warm)
    assert missing == [] and unexpected == []
    video.load_state_dict(merged, strict=True)
    assert torch.equal(video.model.token_embedding.weight, image.model.token_embedding.weight)
    merged, missing, unexpected = graft_params(vid_sd, img_sd)
    assert missing and unexpected == []
    assert_warm_start_keys(missing, unexpected)
    assert_warm_start_keys(
        ["model.visual.temporal_embed", "model.visual.transformer.resblocks.0.timeattn.in_proj_weight"],
        ["final_linear.weight", "mask_embedding"],
    )
    with pytest.raises(AssertionError):
        assert_warm_start_keys(["model.visual.conv1.weight"], [])
    with pytest.raises(AssertionError):
        assert_warm_start_keys([], ["model.token_embedding.weight"])
    with pytest.raises(ValueError, match="shape mismatch"):
        graft_params(vid_sd, {"model.logit_scale": torch.zeros(2)})


# ---- the Trainer ----------------------------------------------------------------

class _PatchDataset:
    """uint8 patches, a 77-token title (14 real tokens) and 5 comments, and
    ``{"id": i}``, made with numpy from a seed: ``tests/test_trainer.py``'s
    ``_FeatureCommentDataset`` with the patch input."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.vis = extract_patches(rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8), 8)
        self.title = synthetic_tokens((n,), 77, 14, rng)
        self.comments = synthetic_tokens((n, 5), 77, 14, rng)

    def __len__(self):
        return len(self.vis)

    def __getitem__(self, i):
        return self.vis[i], self.title[i], self.comments[i], {"id": i}


N_TRAIN, N_VAL, BATCH, LOADER_SEED = 32, 16, 8, 3


def _record_epochs(trainer):
    """Keep each epoch's log (``train`` returns the last one only)."""
    logs = []
    run_epoch = trainer._train_epoch

    def record(epoch):
        logs.append(run_epoch(epoch))
        return logs[-1]

    trainer._train_epoch = record
    return logs


@pytest.fixture(scope="module")
def jax_trainer_run(flagship, tmp_path_factory):
    """JAX's Trainer, 2 epochs: each epoch's log, the best epoch and the final
    params."""
    from vtc_tpu.config import ConfigParser as JaxConfigParser
    from vtc_tpu.data.loader import DataLoader as JaxDataLoader
    from vtc_tpu.training.checkpoints import load_checkpoint as jax_load
    from vtc_tpu.training.metrics import RecallAtK as JaxRecall
    from vtc_tpu.training.optim import build_optimizer as jax_build_optimizer
    from vtc_tpu.training.trainer import Trainer as JaxTrainer

    cfg = JaxConfigParser(_config(tmp_path_factory.mktemp("jax")))
    module = JaxFlagship(model_type=TINY, random_skip_adapter=False)
    loader = JaxDataLoader(_PatchDataset(N_TRAIN), BATCH, shuffle=True, drop_last=True,
                           num_workers=0, seed=LOADER_SEED)
    val = JaxDataLoader(_PatchDataset(N_VAL, seed=1), N_VAL, num_workers=0)
    params = _j(flagship)
    tx = jax_build_optimizer(params, cfg["optimizer"], cfg["lr_scheduler"],
                             steps_per_epoch=len(loader))
    trainer = JaxTrainer(module, {"params": params}, jax_losses.clip_loss,
                         [JaxRecall("visual", "titles", [1, 10])], tx, cfg, loader, val,
                         arch_name="PretrainedCLIP_finaltf")
    logs = _record_epochs(trainer)
    trainer.train()
    best = int(jax_load(cfg.save_dir / "model_best")["epoch"])
    return logs, best, _np_tree(trainer.state.params)


def _port_trainer(params, save_dir, epochs=2, train=None, val=None, len_epoch=None,
                  optimizer_cfg=None, config_kw=None, resume=None, model_kw=None, **kw):
    cfg = _config(save_dir, epochs, **(config_kw or {}))
    if optimizer_cfg is not None:
        cfg["optimizer"] = optimizer_cfg
    cfg = ConfigParser(cfg, resume=resume)
    model = _port(params, **dict({"random_skip_adapter": False}, **(model_kw or {})))
    train = train or DataLoader(_PatchDataset(N_TRAIN), BATCH, shuffle=True,
                                drop_last=True, num_workers=0, seed=LOADER_SEED)
    optimizer, scheduler = build_optimizer(
        model, cfg["optimizer"], cfg["lr_scheduler"],
        steps_per_epoch=len_epoch + 1 if len_epoch else len(train))
    return Trainer(model, losses.clip_loss, [RecallAtK("visual", "titles", [1, 10])],
                   optimizer, scheduler, cfg, train, val, len_epoch=len_epoch,
                   arch_name="PretrainedCLIP_finaltf", device="cpu", **kw)


def test_trainer_matches_jax_trainer(flagship, jax_trainer_run, tmp_path):
    logs_j, best_j, params_j = jax_trainer_run
    val = DataLoader(_PatchDataset(N_VAL, seed=1), N_VAL, num_workers=0)
    trainer = _port_trainer(flagship, tmp_path, val=val)
    logs = _record_epochs(trainer)
    trainer.train()
    assert len(logs) == len(logs_j) == 2
    for ours, ref in zip(logs, logs_j):
        assert sorted(ours) == sorted(ref)
        np.testing.assert_allclose(ours["loss"], ref["loss"], atol=1e-5)
        np.testing.assert_allclose(ours["val_loss"], ref["val_loss"], atol=1e-5)
        recall = {k: v for k, v in ref.items() if "recall" in k}
        assert len(recall) == 4 and {k: ours[k] for k in recall} == recall
    assert int(load_checkpoint(trainer.checkpoint_dir / "model_best.pth")["epoch"]) == best_j
    steps = 2 * (N_TRAIN // BATCH)
    ref = state_dict_from_jax(params_j)
    lr = {id(p): g["initial_lr"] for g in trainer.optimizer.param_groups
          for p in g["params"]}
    for name, p in trainer.model.named_parameters():
        d = np.abs(_np(p) - _np(ref[name])) / lr[id(p)]
        assert d.max() <= 2 * steps, (name, d.max())


@pytest.mark.parametrize("moments_dtype,accum_steps", [(None, 1), ("bfloat16", 2)])
def test_trainer_resume_round_trip(flagship, tmp_path, moments_dtype, accum_steps):
    """A fresh Trainer resumed from epoch 1's checkpoint holds what the first
    saved, bit for bit: the epoch pointer, ``monitor_best``, every
    parameter, every optimizer moment and the schedule's step."""
    opt = {"type": "Adam", "args": dict(OPT["args"], moments_dtype=moments_dtype)}
    val = DataLoader(_PatchDataset(N_VAL, seed=1), N_VAL, num_workers=0)
    first = _port_trainer(flagship, tmp_path / "a", epochs=1, val=val, optimizer_cfg=opt,
                          config_kw={"accum_steps": accum_steps})
    first.train()
    path = first.checkpoint_dir / "checkpoint-epoch1.pth"
    rng = np.random.default_rng(1)
    other = jax.tree_util.tree_map(lambda x: x + np.float32(rng.normal()), flagship)
    second = _port_trainer(other, tmp_path / "b", epochs=3, val=val, optimizer_cfg=opt,
                           resume=path)
    assert second.start_epoch == 2 and second.mnt_best == first.mnt_best
    assert np.isfinite(second.mnt_best)
    for (n, a), (_, b) in zip(first.model.named_parameters(),
                              second.model.named_parameters()):
        assert torch.equal(a, b), n
    params = list(first.model.parameters())
    params2 = list(second.model.parameters())
    n_moments = 0
    for p, p2 in zip(params, params2):
        sa, sb = first.optimizer.state[p], second.optimizer.state[p2]
        assert sorted(sa) == sorted(sb)
        for key in sa:
            assert sa[key].dtype == sb[key].dtype and torch.equal(sa[key], sb[key])
            n_moments += key != "step"
    assert n_moments > 0
    assert second.scheduler.last_epoch == first.scheduler.last_epoch == N_TRAIN // BATCH
    assert ([g["lr"] for g in second.optimizer.param_groups]
            == [g["lr"] for g in first.optimizer.param_groups])
    second.train()  # epochs 2 and 3 from the resumed state
    assert second.scheduler.last_epoch == 3 * (N_TRAIN // BATCH)


@pytest.mark.parametrize("change", ["layout", "lr"])
def test_trainer_resume_optimizer_guards(flagship, tmp_path, change):
    """A changed group layout resets the moments and keeps the schedule's
    step; a changed lr drops the optimizer state and the schedule."""
    first = _port_trainer(flagship, tmp_path / "a", epochs=1, config_kw={"monitor": "off"})
    first.train()
    path = first.checkpoint_dir / "checkpoint-epoch1.pth"
    opt = copy.deepcopy(first.config["optimizer"])
    model_kw = {}
    if change == "layout":
        model_kw["freeze"] = "text"  # fewer parameters in the groups
    else:
        opt["args"]["lr"] = 5e-4
    second = _port_trainer(flagship, tmp_path / "b", epochs=2, optimizer_cfg=opt,
                           resume=path, model_kw=model_kw, config_kw={"monitor": "off"})
    assert not second.optimizer.state
    steps = N_TRAIN // BATCH
    want = steps if change == "layout" else 0
    assert second.scheduler.last_epoch == want
    base = opt["args"]["lr"]
    for g in second.optimizer.param_groups:
        assert g["lr"] == pytest.approx(base * 0.5 ** (want // steps))


def test_trainer_len_epoch_mode_profile_and_probe(flagship, tmp_path):
    """``len_epoch`` over ``inf_loop``: an epoch runs ``len_epoch + 1``
    batches (the reference's quirk) from one persistent stream; epoch 1
    writes a ``torch.profiler`` trace; the probe runs in both modes."""
    calls = []

    def probe(trainer, branch_override=None):
        calls.append(branch_override)
        return {"r1": 0.5}

    val = DataLoader(_PatchDataset(N_VAL, seed=1), N_VAL, num_workers=0)
    trainer = _port_trainer(flagship, tmp_path, epochs=2, val=val, len_epoch=5,
                            config_kw={"profile_dir": str(tmp_path / "trace")},
                            probe_fn=probe)
    assert trainer.len_epoch == 5
    trainer.train()
    assert trainer.scheduler.last_epoch == 2 * 6
    assert trainer._persistent_batches is not None
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert calls == [None, "skip", None, "skip"]


def test_trainer_warns_on_empty_validation(flagship, tmp_path):
    val = DataLoader(_PatchDataset(N_VAL, seed=1), N_VAL + 1, drop_last=True,
                     num_workers=0)
    assert len(val) == 0
    trainer = _port_trainer(flagship, tmp_path, epochs=1, val=val)
    records = []

    class _Collect(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = _Collect(level=logging.WARNING)
    trainer.logger.addHandler(handler)
    try:
        log = trainer.train()
    finally:
        trainer.logger.removeHandler(handler)
    assert any("ZERO batches" in r and "drop_last" in r for r in records), records
    assert any("not found; disabling monitoring" in r for r in records), records
    assert "loss" in log and trainer.mnt_mode == "off"


def test_trainer_runs_are_bitwise_reproducible(flagship, tmp_path):
    """Two runs with the random adapter skip and comment masking drawn from
    the per-step generators, accumulating, end bitwise equal."""
    runs = []
    for name in ("a", "b"):
        trainer = _port_trainer(
            flagship, tmp_path / name, epochs=1, config_kw={"accum_steps": 2},
            model_kw={"random_skip_adapter": True, "random_comment_masking": True})
        trainer.train()
        runs.append(trainer.model.state_dict())
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
    untrained = state_dict_from_jax(flagship)
    assert not torch.equal(runs[0]["mask_embedding"], untrained["mask_embedding"])
