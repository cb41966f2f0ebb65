"""Tensor parallelism of the port (``vtc_tpu_torch.parallel.tensor`` on the
``("data", "model")`` mesh of ``parallel.mesh.create_mesh``) on the CPU:
ranks of a gloo group, each a process spawned from
``tests/torch_dist_ranks.py`` (torch on one thread), against the port's
single-process step at the global batch and against ``vtc_tpu``'s step on
``create_mesh(dp, 2)`` of the 8-device CPU mesh.

* The train step of the flagship at test-tiny, the CAM off its zero-init,
  on dp1×tp2 (2 ranks) and dp2×tp2 (4 ranks), plain and at ``accum_steps``
  2, and with the CAM's ``bn`` residual: the loss within 2e-6 of one
  process's, the step-1 gradients within ``GRAD_RTOL`` of each parameter's
  largest |gradient|, the replicated parameters equal bit for bit on every
  rank and each split part on its data peers; against JAX's dp×tp step
  (the adapter skip off on both sides) the loss at rtol 2e-5, as
  ``tests/test_parallel.py:48``.
* The split itself: the parameters split are exactly those that
  ``vtc_tpu.parallel.mesh.tree_pspecs`` puts on ``"model"``, for the
  flagship, the video CAM model and the audio CAM model; the split and the
  gather round-trip; a degree that does not divide a head count raises
  before anything is split; a MoE adapter's expert stacks stay whole.
* The train twin at ``--n_model 2`` (dp1×tp2): rank 0's ``.pth`` loads into
  a single-process model with ``strict=True``, and a dp×tp resume restores
  its parameters and Adam moments bit for bit.
* The ``eval.py`` twin and ``retrieval_evaluation(mesh=...)`` at dp1×tp2:
  the single-process recalls, one result file.
* The full-size dry run twin (``-m slow``).

The spawns start before the JAX compiles, which run beside them.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_ranks as R
from test_torch_dist import (
    LOSS_ATOL,
    LOSS_RTOL_JAX,
    _bn_state,
    _case,
    _inputs,
    _videos,
    _write_corpus,
    flagship,  # noqa: F401  (the module fixture)
)
from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.models.retrieval import PretrainedCLIP_finaltf as JaxFlagship
from vtc_tpu.ops import losses as jax_losses
from vtc_tpu_torch.models import create_model, state_dict_from_jax
from vtc_tpu_torch.parallel import tensor as tp

TINY = R.TINY
# the step-1 gradients of a split model against one process, of each
# parameter's largest |gradient|: every GEMM of a split layer sums its inner
# dimension in two parts and the all-reduce adds them, where one process sums
# it in one pass (fp32 rounding: see test_torch_dist.GRAD_RTOL for the data axis)
GRAD_RTOL = 1e-5
# with the CAM's bn residual, whose batch statistics over 8 rows divide the
# residual by its spread and so magnify that rounding: up to 2.87e-5 (the
# CAM's ln_1.bias), and its running stats within 1e-6 of one process's
BN_GRAD_RTOL = 5e-5
BN_STATS_ATOL = 1e-6


def _jax_tp_run(params, data, accum, n_data, steps=2):
    """``make_step_fns``' step on ``create_mesh(n_data, 2)`` with the params
    laid out by ``tree_shardings``, the adapter skip off (the data axis's
    draws are held in tests/test_torch_dist.py): each step's loss."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vtc_tpu.parallel.mesh import DATA_AXIS, create_mesh, tree_shardings
    from vtc_tpu.training.optim import build_optimizer as jax_build_optimizer
    from vtc_tpu.training.trainer import TrainState, make_step_fns

    module = JaxFlagship(model_type=TINY, random_skip_adapter=False)
    mesh = create_mesh(n_data, 2, devices=jax.devices()[:2 * n_data])
    try:
        params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params),
                                tree_shardings(params, mesh))
        tx = jax_build_optimizer(params, R.OPT, R.SCHED, **R.STEP_KW)
        step, _ = make_step_fns(module, jax_losses.clip_loss, tx, donate=False,
                                accum_steps=accum)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats={})
        # the whole state laid out, so that the second step reuses the first's compile
        state = jax.device_put(state, tree_shardings(state, mesh))
        sharded = tuple(jax.device_put(a, NamedSharding(mesh, P(DATA_AXIS))) for a in data)
        losses = []
        with mesh:
            for k in range(steps):
                state, loss, _ = step(state, sharded, {}, jax.random.PRNGKey(k))
                losses.append(float(loss))
    finally:
        from vtc_tpu.models import layers as jax_layers

        jax_layers.set_tp_qkv(False)  # the JAX package's trace flag, back to one chip
    return losses


def _jax_pair(params, n_data):
    return [_jax_tp_run(params, _inputs(seed=1), accum, n_data) for accum in (1, 2)]


def _jax_runs(params) -> dict:
    """``_jax_tp_run`` at dp1×tp2 and dp2×tp2, plain and accumulating: each
    mesh's two compiles in a process of its own, the two side by side."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        pairs = {n: pool.submit(_jax_pair, params, n) for n in (1, 2)}
        return {(n, accum): run for n, pair in pairs.items()
                for accum, run in zip((1, 2), pair.result())}


def _cases(sd):
    gen = torch.Generator().manual_seed(3)
    skip = {"adapter_skip": torch.rand((8, 1), generator=gen) > 0.5}
    return {
        "plain": _case(sd, _inputs(seed=2), [skip]),
        "accum": _case(sd, _inputs(seed=2), [skip], accum=2),
        "bn": _case(_bn_state(sd), _inputs(seed=2), [skip],
                    model_kw=dict(residual_activation="bn")),
    }


def _jax_cases(sd):
    """The steps on JAX's inputs, the adapter skip off."""
    kw = dict(model_kw=dict(random_skip_adapter=False))
    return {"jax_plain": _case(sd, _inputs(seed=1), **kw),
            "jax_accum": _case(sd, _inputs(seed=1), accum=2, **kw)}


def _cli_config(tmp):
    csv, root = _write_corpus(tmp / "cli")
    cfg = {
        "name": "tp_twin", "n_gpu": 1, "batch_size": 4, "num_workers": 0,
        "arch": {"type": "PretrainedCLIP_finaltf",
                 "args": {"model_type": TINY, "freeze": "all", "branch_to_adapt": "text",
                          "branch_to_adapt_val": "text"}},
        "dataset": {"type": "ImTextDataset",
                    "args": {"root": str(root), "csv_file": str(csv),
                             "add_comments": "always", "comment_sampling": "random",
                             "num_comms": 2, "image_size": 32}},
        "optimizer": {"type": "Adam", "args": {"lr": 0.001, "weight_decay": 0.01,
                                               "amsgrad": True}},
        "loss": "clip_loss", "loss_args": {},
        "metrics": [{"type": "RecallAtK", "args": {"name_a": "visual", "name_b": "titles",
                                                   "k_vals": [1, 10]}}],
        "lr_scheduler": {"type": "StepLR", "args": {"step_size": 10, "gamma": 0.1}},
        "trainer": {"epochs": 1, "save_dir": str(tmp / "saved"), "save_period": 1,
                    "verbosity": 2, "monitor": "max val_titles_from_visual-recall_at_10",
                    "early_stop": 10, "tensorboard": False},
    }
    (tmp / "cli_config.json").write_text(json.dumps(cfg))
    return cfg


def _eval_spec(sd, tmp):
    from vtc_tpu_torch.training import save_checkpoint

    csv, root = _write_corpus(tmp)
    ckpt = save_checkpoint(tmp, "model_best", arch="PretrainedCLIP_finaltf", epoch=1,
                           state_dict=sd)
    config = {
        "name": "eval_tp", "n_gpu": 1, "n_devices": 1, "n_model": 2, "batch_size": 3,
        "num_workers": 0,
        "arch": {"type": "PretrainedCLIP_finaltf",
                 "args": {"model_type": TINY, "freeze": "all", "branch_to_adapt": "text",
                          "branch_to_adapt_val": "text"}},
        "dataset": {"type": "ImTextDataset",
                    "args": {"root": str(root), "csv_file": str(csv), "add_comments": "always",
                             "comment_sampling": "random", "num_comms": 2, "image_size": 32}},
        "trainer": {"save_dir": str(tmp / "saved")},
    }
    (tmp / "evalrun").mkdir()
    return {"config": config, "ckpt": str(ckpt), "state_dict": sd, "videos": _videos()}


@pytest.fixture(scope="module")
def tp_runs(flagship, tmp_path_factory):
    """The spawns of dp1×tp2 (steps, the CLI, the evaluations) and dp2×tp2
    (steps), started before the JAX dp×tp runs, which run beside them;
    returns (the specs, the JAX runs, each spawn's ranks' results)."""
    sd = state_dict_from_jax(flagship)
    specs, contexts = {}, {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"tp{world}")
        spec = {"cases": dict(_cases(sd), **_jax_cases(sd))}
        if world == 2:
            spec["evals"] = _eval_spec(sd, tmp)
            spec["cli"] = _cli_config(tmp)
        torch.save(spec, tmp / "tp.pt")
        specs[world] = (spec, tmp)
        contexts[world] = R.spawn(R.run_tp, world, tmp, join=False)
    jax_runs = _jax_runs(flagship)
    ranks = {}
    for world, context in contexts.items():
        R.wait(context)
        tmp = specs[world][1]
        ranks[world] = [torch.load(tmp / f"tp_rank{r}.pt", weights_only=False)
                        for r in range(world)]
    return specs, jax_runs, ranks


MESHES = {"dp1xtp2": 2, "dp2xtp2": 4}
_SINGLE = {}


def _single(spec_cases, case):
    """The port's single-process run of a case (the same on both meshes)."""
    if case not in _SINGLE:
        _SINGLE[case] = R.step_case(spec_cases[case])
    return _SINGLE[case]


@pytest.mark.parametrize("case", ["plain", "accum", "bn", "jax_plain"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_split_step_matches_the_single_process_step(tp_runs, mesh, case):
    specs, _, ranks = tp_runs
    world = MESHES[mesh]
    spec = specs[world][0]["cases"][case]
    single = _single(specs[world][0]["cases"], case)
    ours = ranks[world][0]["cases"][case]
    np.testing.assert_allclose(ours["losses"], single["losses"], atol=LOSS_ATOL, rtol=0)
    assert ours["shapes"] == single["shapes"]
    assert sorted(ours["grads"]) == sorted(single["grads"])
    rtol = BN_GRAD_RTOL if case == "bn" else GRAD_RTOL
    for name, g in single["grads"].items():
        assert (ours["grads"][name] is None) == (g is None), name
        if g is None:
            continue
        scale = float(g.abs().max())
        err = float((ours["grads"][name] - g).abs().max())
        assert err <= rtol * scale, (name, err, scale)
    split = set(tp.split_names(R.flagship_port(spec["state_dict"], **spec.get("model_kw", {}))))
    for r, other in enumerate(ranks[world]):
        got = other["cases"][case]
        assert got["losses"] == ours["losses"], r
        for name, p in got["params"].items():
            assert torch.equal(p, ours["params"][name]), (r, name)  # the whole parameter
        for name, p in got["local_params"].items():
            peer = ranks[world][r % 2]["cases"][case]["local_params"][name]
            if name in split:  # a part, equal on its data peers
                assert torch.equal(p, peer), (r, name)
            else:  # replicated: bit for bit on every rank
                assert torch.equal(p, ours["local_params"][name]), (r, name)
    for name, b in single["buffers"].items():
        if case == "bn" and b.is_floating_point():
            torch.testing.assert_close(ours["buffers"][name], b, atol=BN_STATS_ATOL, rtol=0)
        else:
            assert torch.equal(ours["buffers"][name], b), name


@pytest.mark.parametrize("case", ["plain", "accum"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_split_step_matches_jax_on_a_dp_tp_mesh(tp_runs, mesh, case):
    _, jax_runs, ranks = tp_runs
    world = MESHES[mesh]
    losses_j = jax_runs[(world // 2, 1 if case == "plain" else 2)]
    ours = ranks[world][0]["cases"][f"jax_{case}"]
    np.testing.assert_allclose(ours["losses"], losses_j, rtol=LOSS_RTOL_JAX)
    assert ours["shapes"][2] == (8, 8)  # the global batch's similarity


ARCHS = {"flagship": ("PretrainedCLIP_finaltf", {}),
         "video": ("PretrainedCLIP_TimeSformer_finaltf", {"nframes": 4}),
         "audio": ("PretrainedCLIP_finaltf", {"init_audio_model": True})}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_split_parameters_are_tree_pspecs_model_leaves(arch):
    """Each JAX leaf filled with 1 where ``tree_pspecs`` names ``"model"``
    (else 0) and carried across with ``state_dict_from_jax``: the port's
    split parameters are the ones that read 1; the split and the gather
    round-trip, and each part has the shape of 1/2 of its dimension."""
    from vtc_tpu.parallel.mesh import MODEL_AXIS, tree_pspecs

    name, kw = ARCHS[arch]
    # the tree's names and shapes are all the check reads: traced, not run
    variables = jax.eval_shape(
        lambda: jax_create_model(name, model_type=TINY, seed=0, **kw)[1])
    params = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), variables)
    specs = tree_pspecs(params["params"])
    marked = jax.tree_util.tree_map(
        lambda x, s: np.full(x.shape, float(MODEL_AXIS in tuple(s)), np.float32),
        params["params"], specs, is_leaf=lambda x: isinstance(x, np.ndarray))
    model = create_model(name, model_type=TINY, device="cpu", **kw)
    names = dict(model.named_parameters())
    sd = state_dict_from_jax(marked, params.get("batch_stats")) if arch == "audio" \
        else state_dict_from_jax(marked)
    want = sorted(n for n, t in sd.items() if n in names and bool(t.all()))
    assert sorted(tp.split_names(model)) == want
    assert not any(bool(t.any()) for n, t in sd.items() if n in names and n not in want)
    assert any("timeattn" in n for n in want) == (arch == "video")
    assert any(n.startswith("final_transformer.") for n in want)
    full = model.state_dict()
    parts = [tp.split_state_dict(full, r, 2) for r in (0, 1)]
    for n in want:
        rule = tp.split_rule(n)
        dim = 0 if rule == "qkv" else rule
        assert parts[0][n].shape[dim] * 2 == full[n].shape[dim], n
        # in storage of its own: a view of the whole tensor would hold all of it
        assert parts[0][n].untyped_storage().nbytes() == parts[0][n].numel() * 4, n
        assert torch.equal(tp.join_tensors([p[n] for p in parts], rule), full[n]), n
    if "model.visual.transformer.resblocks.0.attn.in_proj_weight" in want:
        w = full["model.visual.transformer.resblocks.0.attn.in_proj_weight"]
        e = w.shape[1]  # rank 1 holds the second half of each of q, k and v
        assert torch.equal(parts[1]["model.visual.transformer.resblocks.0.attn.in_proj_weight"],
                           torch.cat([w[j * e + e // 2:(j + 1) * e] for j in range(3)]))


def test_degrees_that_do_not_fit_raise_before_the_split():
    model = create_model("PretrainedCLIP_finaltf", model_type=TINY, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="degree 3 does not divide the head count 8"):
        tp.shard_model(model, tp.ModelAxis(None, 0, 3))
    with pytest.raises(ValueError, match="does not divide the head count"):
        tp.shard_model(model, tp.ModelAxis(None, 0, 8))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    assert tp.model_axis(model) is None
    with pytest.raises(ValueError, match="does not divide dim 0"):
        tp.split_state_dict({"model.token_embedding.weight": torch.zeros(10, 4)}, 0, 3)
    # a MoE adapter: tree_pspecs names c_fc/c_proj, so the expert stacks stay
    # whole on every model rank
    moe = create_model("PretrainedCLIP_finaltf", model_type=TINY, device="cpu",
                       moe_experts=4)
    stacks = {n: p.detach().clone() for n, p in moe.named_parameters() if ".mlp_moe." in n}
    tp.shard_model(moe, tp.ModelAxis(None, 0, 2))
    assert stacks and not set(stacks) & set(tp.split_names(moe))
    for n, p in moe.named_parameters():
        if n in stacks:
            assert torch.equal(p, stacks[n]), n
    whole = create_model("PretrainedCLIP_finaltf", model_type=TINY, device="cpu")
    assert tp.shard_model(whole, tp.ModelAxis(None, 0, 1)) is whole
    assert tp.model_axis(whole) is None


def test_train_twin_checkpoints_at_dp1_tp2(tp_runs):
    """Rank 0's ``.pth`` has a single card's keys and loads into one
    process with ``strict=True``; it holds the gathered parameters of its
    epoch, and the resume restores them and the Adam moments bit for bit on
    both ranks; the CAM's split parameters trained and took decay."""
    from vtc_tpu_torch.training import load_checkpoint

    specs, _, ranks = tp_runs
    out = ranks[2]
    assert out[0]["dirs"] == out[1]["dirs"] and out[0]["start"] == out[1]["start"] == 2
    first = Path(out[0]["dirs"][0])
    ckpt = load_checkpoint(first / "checkpoint-epoch1.pth")
    model = R.flagship_port(ckpt["state_dict"])  # strict: a single card's keys
    for r in (0, 1):
        state, opt = out[r]["resumed"][0]
        assert len(out[r]["epochs"]) == 2  # epoch 1, then the resumed epoch 2
        for n, p in model.state_dict().items():
            assert torch.equal(p, ckpt["state_dict"][n]), n
            assert torch.equal(state[n], p), (r, n)
            assert torch.equal(out[r]["epochs"][0][n], p), (r, n)
        assert opt["state"].keys() == ckpt["optimizer"]["state"].keys()
        for i, entry in ckpt["optimizer"]["state"].items():
            for k, v in entry.items():
                assert torch.equal(opt["state"][i][k], v), (r, i, k)
    split = set(tp.split_names(model))
    moved = [n for n in split if n.startswith("final_transformer.")
             and not torch.equal(out[0]["epochs"][1][n], out[0]["epochs"][0][n])]
    assert moved
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for n in split:  # the resumed model holds its parts
        rule = tp.split_rule(n)
        dim = 0 if rule == "qkv" else rule
        assert out[0]["local"][n].shape[dim] * 2 == shapes[n][dim], n


def test_evaluations_at_dp1_tp2(tp_runs, flagship, tmp_path, monkeypatch):
    """The ``eval.py`` twin at ``--n_model 2`` and ``retrieval_evaluation``
    on the mesh give the single-process recalls and table; rank 0 alone
    writes."""
    from vtc_tpu_torch.config import ConfigParser
    from vtc_tpu_torch.evaluation import eval as port_eval
    from vtc_tpu_torch.evaluation.retrieval_eval import retrieval_evaluation

    specs, _, ranks = tp_runs
    spec, tmp = specs[2]
    ev = spec["evals"]
    assert [Path(f).name for f in ranks[2][0]["written"]] == [
        "model_best.pth_res_adapted_text_2_comms.json"]
    assert ranks[2][1]["written"] == []
    assert ranks[2][0]["recalls"] == ranks[2][1]["recalls"]
    cfg = dict(ev["config"], n_model=1)
    cfg["trainer"] = {"save_dir": str(tmp_path / "saved")}
    monkeypatch.chdir(tmp_path)
    single = port_eval.main(ConfigParser(cfg), R.EvalArgs(), ev["ckpt"], device="cpu")
    assert ranks[2][0]["recalls"] == single
    model = R.flagship_port(ev["state_dict"]).eval()
    table = retrieval_evaluation(model, "synthetic", "test", dataset=ev["videos"],
                                 frame_stride=4, device="cpu")
    for out in ranks[2]:
        np.testing.assert_array_equal(out["table"], table.to_numpy())
    assert [p.name for p in (tmp / "evalrun").glob("*.csv")] == ["table.csv"]


def test_dryrun_twin_at_test_tiny():
    """The dry run twin's ranks, mesh and step on 2 gloo ranks at test-tiny's
    widths (the full widths under ``-m slow``)."""
    from vtc_tpu_torch.scripts import dryrun_fullsize

    result = dryrun_fullsize.run(tp=2, n_data=1, device="cpu", model_type=TINY)
    assert np.isfinite(result["loss"]) and result["moved"] and result["finite"]
    assert result["tp"] == 2 and result["split_rows"] == 3 * 64 // 2
    assert result["backend"] == "gloo"


@pytest.mark.slow
def test_fullsize_dryrun_twin():
    """One dp1×tp2 step of the flagship at ViT-B/32's widths on 2 gloo ranks
    (``python -m vtc_tpu_torch.scripts.dryrun_fullsize 2``): a finite loss
    and a split ``in_proj_weight`` that moved."""
    from vtc_tpu_torch.scripts import dryrun_fullsize

    result = dryrun_fullsize.run(tp=2, n_data=1, device="cpu")
    assert np.isfinite(result["loss"]) and result["moved"]
