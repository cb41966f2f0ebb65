"""Data parallelism of the port (``vtc_tpu_torch.parallel.mesh``, the train
step, the loader, the evaluations, the CLI) on the CPU: 2 ranks of a gloo
group, each a process spawned from ``tests/torch_dist_ranks.py``, against
``vtc_tpu`` on a dp=2 mesh of the 8-device CPU mesh and against the port's
single-process run at the global batch.

* The train step, flagship at test-tiny, adapter-skip draws on (JAX's own
  draws, read from its output, fed to the port for the global batch): 2
  steps against ``make_step_fns``' step on ``create_mesh(2, 1)``, plain and
  at ``accum_steps`` 2 (losses at rtol 2e-5, as ``tests/test_parallel.py``;
  parameters within Adam's bound of ``lr`` per step, as
  ``tests/test_torch_training.py``, and 99% of the entries at atol 1e-5, as
  ``tests/test_parallel.py`` holds its parameters). A parameter without a
  gradient (``final_linear`` beside ``init_from_avg``) is stepped with a zero
  gradient by both optimizers, so under this test's weight decay both move
  it alike (``vtc_tpu_torch/training/optim.py``); each entry lies within one
  ``lr`` a step of JAX's (0.35 lr at most after the 2 steps).
* Against the port's own single-process step at the global batch: the
  loss within 2e-6, the step-1 gradients within ``GRAD_RTOL`` (1e-5) of
  each parameter's largest |gradient|, above fp32's reordering floor of
  this model (see below); plain, accumulating, with the draws
  drawn from the per-step generator (so the same on 1 and 2 ranks), and
  with the CAM's ``bn`` residual: its running stats equal bit for bit; both
  ranks' parameters equal after the steps.
* The token bucket over ranks of unequal coverage; ``allgather_varlen``
  with a rank of 0 rows; a ``TorchBatchNorm`` on the global batch;
  ``recall_at_k_sharded`` against ``vtc_tpu``'s; the MoE model's step on
  2 ranks against one process's (the expert axis:
  ``tests/test_torch_ep.py``); the loader's ``shard_by_process`` order and ``len`` against the
  JAX loader with its process index and count patched.
* The ``eval.py`` twin and ``retrieval_evaluation`` on 2 processes: the
  single-process recalls and the JAX package's, one result file.
* The ``train.py`` twin on 2 ranks (``--n_devices 2``) over a tiny corpus:
  one run dir, checkpoints written by rank 0 and loadable by a
  single-process run, equal parameters on both ranks, a resume on both.

A spawn costs about 7 s, so the ranks run every check of the file in one
spawn (``torch_dist_ranks.run_dist``), started before the two JAX dp=2 runs,
which run beside it; the step cases on JAX's draws wait in the ranks for
their file. Torch runs on one thread in each rank.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_ranks as R
from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.models.retrieval import PretrainedCLIP_finaltf as JaxFlagship
from vtc_tpu.ops import losses as jax_losses
from vtc_tpu_torch.data import extract_patches, synthetic_tokens
from vtc_tpu_torch.models import state_dict_from_jax
from vtc_tpu_torch.models.layers import TorchBatchNorm

TINY = R.TINY
DIM = 32
LOSS_RTOL_JAX = 2e-5  # tests/test_parallel.py
PARAM_ATOL_JAX = 1e-5
LOSS_ATOL = 2e-6  # against the port's single-process step
# the step-1 gradients of 2 ranks against one process, of each parameter's
# largest |gradient|: the same sums in another order. fp32 rounding alone
# moves them further than 1e-6: one process whose batch has its two halves
# swapped moves by up to 3.06e-6 of the largest at test-tiny, 2 ranks by
# up to 3.6e-6 (4.7e-6 with the bn residual)
GRAD_RTOL = 1e-5
TIMEOUT = 300  # s for the spawn: a rank left in a collective never ends


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def flagship():
    """numpy params of the test-tiny flagship, the CAM off its zero-init."""
    _, variables = jax_create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=0)
    params = _np_tree(variables["params"])
    rng = np.random.default_rng(0)
    params["cam"] = jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), params["cam"])
    return params


def _inputs(batch=8, seed=0, ntoks=16):
    rng = np.random.default_rng(seed)
    vis = extract_patches(rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8), 8)
    title = synthetic_tokens((batch,), ntoks, 14, rng)
    comments = synthetic_tokens((batch, 5), ntoks, 14, rng)
    comments[0, 4] = 0
    comments[0, 4, :2] = (49406, 49407)
    return [vis, title, comments]


def _skipped_rows(feats_text_train, feats_title):
    diff = np.abs(np.asarray(feats_text_train) - np.asarray(feats_title)).max(-1)
    assert np.all((diff < 1e-4) | (diff > 1e-2)), diff
    return torch.from_numpy((diff < 1e-4)[:, None])


def _microbatch_draws(draws, k):
    return [{n: d[i::k] for n, d in draws.items()} for i in range(k)]


def _case(state_dict, data, batch_draws=None, accum=1, **kw):
    """A ``step_case`` spec: ``batch_draws`` holds each step's draws of the
    global batch, split into its microbatches' where ``accum`` > 1."""
    draws = None if batch_draws is None else [
        d if accum == 1 else _microbatch_draws(d, accum) for d in batch_draws]
    return dict(state_dict=state_dict, data=data, batch_draws=batch_draws, draws=draws,
                accum=accum, steps=len(batch_draws or [None, None]), **kw)


def _jax_mesh_run(params, data, accum, steps=2):
    """``make_step_fns``' step on a dp=2 mesh: each step's loss, its
    adapter-skip rows (read from its output), the params after."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vtc_tpu.parallel.mesh import DATA_AXIS, create_mesh
    from vtc_tpu.training.optim import build_optimizer as jax_build_optimizer
    from vtc_tpu.training.trainer import TrainState, make_step_fns

    module = JaxFlagship(model_type=TINY)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_build_optimizer(params, R.OPT, R.SCHED, **R.STEP_KW)
    step, evaluate = make_step_fns(module, jax_losses.clip_loss, tx, donate=False,
                                   accum_steps=accum)
    mesh = create_mesh(2, 1)
    # placed on the mesh, so that the second step's state has the first's
    # layout and reuses its compile
    state = jax.device_put(TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      opt_state=tx.init(params), batch_stats={}),
                           NamedSharding(mesh, P()))
    sharded = tuple(jax.device_put(a, NamedSharding(mesh, P(DATA_AXIS))) for a in data)
    losses, draws = [], []
    with mesh:
        for k in range(steps):
            title = evaluate(state, sharded, {}, branch_override="skip")[1][1]
            state, loss, out = step(state, sharded, {}, jax.random.PRNGKey(k))
            losses.append(float(loss))
            draws.append({"adapter_skip": _skipped_rows(out[1], title)})
    return losses, draws, state_dict_from_jax(_np_tree(state.params))


def _bn_state(sd):
    return dict(sd, **{"mean_center_bn.running_mean": torch.zeros(DIM),
                       "mean_center_bn.running_var": torch.ones(DIM),
                       "mean_center_bn.num_batches_tracked": torch.tensor(0)})


@pytest.fixture(scope="module")
def background(flagship, tmp_path_factory):
    """The one spawn of 2 ranks (``R.run_dist``) over the step cases, the
    collectives, the evaluations and the CLI, started before the JAX
    compiles of ``steps_run`` so that it runs beside them."""
    tmp = tmp_path_factory.mktemp("ranks")
    evals = _start_evals(flagship, tmp / "evals")
    _start_cli(tmp / "cli")
    steps = _steps_spec(flagship, tmp / "steps")
    return {"tmp": tmp, "evals": evals, "steps": steps,
            "context": R.spawn(R.run_dist, 2, tmp, join=False)}


@pytest.fixture(scope="module")
def steps_run(flagship, background):
    """The JAX mesh runs, whose draws make the step cases that the ranks
    wait for; then the ranks' end. Returns (spec, JAX runs, rank 0's and
    rank 1's results)."""
    tmp = background["tmp"] / "steps"
    sd = state_dict_from_jax(flagship)
    data = _inputs(seed=1)
    jax_runs = {"plain": _jax_mesh_run(flagship, data, 1),
                "accum": _jax_mesh_run(flagship, data, 2)}
    later = {"jax_plain": _case(sd, data, jax_runs["plain"][1]),
             "jax_accum": _case(sd, data, jax_runs["accum"][1], accum=2)}
    torch.save(later, tmp / "jax_cases.part")
    os.replace(tmp / "jax_cases.part", tmp / "jax_cases.pt")  # whole when it appears
    R.wait(background["context"], timeout=TIMEOUT)
    spec = background["steps"]
    spec["cases"].update(later)
    ranks = [torch.load(tmp / f"steps_rank{r}.pt", weights_only=False) for r in (0, 1)]
    return spec, jax_runs, ranks


def _steps_spec(flagship, tmp):
    """The step cases that need no JAX run and the collectives' inputs,
    written to ``tmp/steps.pt``."""
    tmp.mkdir()
    sd = state_dict_from_jax(flagship)
    gen = torch.Generator().manual_seed(3)
    skip = {"adapter_skip": torch.rand((8, 1), generator=gen) > 0.5}
    cases = {
        "plain": _case(sd, _inputs(seed=2), [skip]),
        "accum": _case(sd, _inputs(seed=2), [skip], accum=2),
        "generator": _case(sd, _inputs(seed=2), seed=11,
                           model_kw=dict(random_comment_masking=True)),
        # one step: its running stats are one process's bit for bit
        "bn": _case(_bn_state(sd), _inputs(seed=2), [skip],
                    model_kw=dict(residual_activation="bn")),
    }
    rng = np.random.default_rng(5)
    tokens = [synthetic_tokens((8,), 77, 14, rng), synthetic_tokens((8, 5), 77, 14, rng)]
    tokens[0][:4], tokens[1][:4] = 0, 0
    tokens[0][:4, :2] = tokens[1][:4, :, :2] = (49406, 49407)  # rank 0: EOT at 1
    tokens[1][6, 2] = 0  # rank 1: one comment reaches token 41
    tokens[1][6, 2, :41] = [49406] + [500] * 39 + [49407]
    from vtc_tpu_torch.models import create_model

    moe_sd = create_model("PretrainedCLIP_finaltf", model_type=TINY, moe_experts=4,
                          device="cpu").state_dict()
    spec = {
        "cases": cases, "tokens": tokens,
        "varlen": [np.arange(6, dtype=np.float32).reshape(3, 2), np.zeros((0, 2), np.float32)],
        "bn": {"state": TorchBatchNorm(4).state_dict(),
               "x": rng.normal(size=(8, 4, 3)).astype(np.float32),
               "c": rng.normal(size=(8, 4, 3)).astype(np.float32)},
        "recall": {"a": rng.normal(size=(11, 6)).astype(np.float32),
                   "b": rng.normal(size=(11, 6)).astype(np.float32), "k": [1, 3, 5],
                   "targets": rng.integers(0, 11, 11)},
        "moe": dict(state_dict=moe_sd, data=_inputs(seed=2), steps=1,
                    model_kw=dict(moe_experts=4)),
    }
    torch.save(spec, tmp / "steps.pt")
    return spec


@pytest.mark.parametrize("case", ["plain", "accum"])
def test_two_rank_step_matches_jax_on_a_dp2_mesh(steps_run, case):
    spec, jax_runs, ranks = steps_run
    losses_j, draws_j, params_j = jax_runs[case]
    assert 0 < int(sum(d["adapter_skip"].sum() for d in draws_j)) < 16  # both kinds
    ours = ranks[0]["cases"][f"jax_{case}"]
    np.testing.assert_allclose(ours["losses"], losses_j, rtol=LOSS_RTOL_JAX)
    assert ours["shapes"][2] == (8, 8)  # the global batch's similarity
    # Adam moves a parameter by about lr whatever its gradient, so an entry
    # whose gradient sits at rounding level may move either way: each entry
    # within 1 lr per step, 99% within PARAM_ATOL_JAX (1% of the base lr)
    lr = _lrs(spec["cases"][f"jax_{case}"]["state_dict"])
    near = []
    for name, p in ours["params"].items():
        d = np.abs(_np(p) - _np(params_j[name]))
        assert (d / lr[name]).max() <= 1 * 2, (name, d.max())
        near.append(d.ravel() <= PARAM_ATOL_JAX)
    assert np.concatenate(near).mean() >= 0.99


def _lrs(state_dict):
    from vtc_tpu_torch.training import build_optimizer

    model = R.flagship_port(state_dict)
    optimizer, _ = build_optimizer(model, R.OPT, R.SCHED, **R.STEP_KW)
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: g["initial_lr"] for g in optimizer.param_groups for p in g["params"]}


@pytest.mark.parametrize("case", ["plain", "accum", "generator", "bn", "jax_plain"])
def test_two_rank_step_matches_the_single_process_step(steps_run, case):
    spec, _, ranks = steps_run
    single = R.step_case(spec["cases"][case])
    ours, other = ranks[0]["cases"][case], ranks[1]["cases"][case]
    np.testing.assert_allclose(ours["losses"], single["losses"], atol=LOSS_ATOL, rtol=0)
    assert ours["losses"] == other["losses"]
    assert ours["shapes"] == single["shapes"]
    assert sorted(ours["grads"]) == sorted(single["grads"])
    for name, g in single["grads"].items():
        assert (ours["grads"][name] is None) == (g is None), name
        if g is None:
            continue
        scale = float(g.abs().max())
        err = float((ours["grads"][name] - g).abs().max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)
    for name, p in ours["params"].items():
        assert torch.equal(p, other["params"][name]), name  # DDP keeps the ranks equal
    for name, b in single["buffers"].items():
        assert torch.equal(ours["buffers"][name], b), name
    if case == "bn":
        assert not torch.equal(single["buffers"]["mean_center_bn.running_var"],
                               torch.ones(DIM))


def test_collectives_over_two_ranks(steps_run):
    """The token bucket, the varlen gather, a BatchNorm of the global batch
    and the sharded ranking, on both ranks."""
    from vtc_tpu.ops.retrieval import recall_at_k_sharded as jax_sharded
    from vtc_tpu.parallel.mesh import create_mesh
    from vtc_tpu_torch.data.tokenizer import truncate_batch_tokens

    spec, _, ranks = steps_run
    whole = [t.shape for t in truncate_batch_tokens(spec["tokens"])]
    for r, out in enumerate(ranks):
        assert out["bucket"] == [(4, 48), (4, 5, 48)]  # the global coverage, 41
        assert [(4,) + s[1:] for s in whole] == out["bucket"]
    assert ranks[0]["local_bucket"] == [(4, 16), (4, 5, 16)]  # rank 0 alone: EOT at 1
    for out in ranks:
        np.testing.assert_array_equal(out["varlen"], spec["varlen"][0])  # 3 + 0 rows

    bn = TorchBatchNorm(4)
    x = torch.from_numpy(spec["bn"]["x"]).requires_grad_()
    y = bn.train()(x)
    (y * torch.from_numpy(spec["bn"]["c"])).sum().backward()
    for r, out in enumerate(ranks):
        torch.testing.assert_close(out["bn"]["y"], y.detach(), atol=0, rtol=0)
        torch.testing.assert_close(out["bn"]["x_grad"], x.grad[4 * r:4 * r + 4],
                                   atol=1e-6, rtol=1e-5)
        assert torch.equal(out["bn"]["running"][0], bn.running_mean)
        assert torch.equal(out["bn"]["running"][1], bn.running_var)

    rec = spec["recall"]
    ref = jax_sharded(rec["a"], rec["b"], rec["k"], create_mesh(2, 1), targets=rec["targets"])
    for out in ranks:
        assert out["recall"] == [(k, pytest.approx(v, abs=1e-12)) for k, v in ref]
    # the MoE model routes over both ranks' tokens: one process's step
    single = R.step_case(spec["moe"])
    for out in ranks:
        np.testing.assert_allclose(out["moe"]["losses"], single["losses"], atol=LOSS_ATOL,
                                   rtol=0)
        for got, ref in zip(out["moe"]["routing"], single["routing"]):
            assert all(torch.equal(a, b) for a, b in zip(got, ref))


# ---- the loader -------------------------------------------------------------------

class _Index:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.asarray(i, np.int64)


@pytest.mark.parametrize("n, batch, drop_last", [(64, 4, True), (50, 4, True), (50, 3, False)])
def test_shard_by_process_matches_the_jax_loader(monkeypatch, n, batch, drop_last):
    """Each process's batches over 2 epochs and ``len``, against the JAX
    loader with its process index and count patched
    (``tests/test_loader_sharding.py``); ``shard_batches`` gives each rank
    its rows of the single process's batches."""
    from vtc_tpu.data.loader import DataLoader as JaxLoader
    from vtc_tpu_torch.data import loader as port_loader
    from vtc_tpu_torch.parallel import mesh

    for count in (2, 4):
        for index in range(count):
            monkeypatch.setattr(jax, "process_index", lambda: index)
            monkeypatch.setattr(jax, "process_count", lambda: count)
            # the loader reads the data axis of parallel.mesh
            monkeypatch.setattr(mesh, "rank", lambda group=None: index)
            monkeypatch.setattr(mesh, "world", lambda group=None: count)
            kw = dict(batch_size=batch, shuffle=True, seed=7, drop_last=drop_last,
                      num_workers=0, shard_by_process=True)
            ours, ref = port_loader.DataLoader(_Index(n), **kw), JaxLoader(_Index(n), **kw)
            assert len(ours) == len(ref)
            for _ in range(2):
                assert [b.tolist() for b in ours] == [np.asarray(b).tolist() for b in ref]
    monkeypatch.setattr(mesh, "rank", lambda group=None: 1)
    whole = [b.tolist() for b in port_loader.DataLoader(_Index(64), 8, shuffle=True, seed=3)]
    rows = port_loader.DataLoader(_Index(64), 8, shuffle=True, seed=3, shard_batches=True)
    assert len(rows) == len(whole)
    assert [b.tolist() for b in rows] == [b[8 // 4:2 * 8 // 4] for b in whole]


# ---- the evaluations ----------------------------------------------------------------

BASE36 = "0123456789abcdefghijklmnopqrstuvwxyz"


def _write_corpus(tmp_path):
    """``tests/test_cli.py``'s corpus: 72 rows over every split, 48x64
    thumbnails."""
    import pandas as pd
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp_path / "media"
    (root / "vids").mkdir(parents=True)
    rows = []
    for i in range(72):
        rid_str = "ab" + BASE36[(i * 7) % 36] + BASE36[i % 36]
        rid = int(rid_str, 36)
        if any(r["reddit_id"] == rid for r in rows):
            continue
        rows.append({"reddit_id": rid, "video_path": f"results/vids/{rid_str}.mp4",
                     "title": f"a video about topic {i}", "video_length": 10.0,
                     "comments": str([f"this is about topic {i}", f"great {i}"])})
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            root / "vids" / f"{rid_str}.jpg")
    csv = tmp_path / "posts.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    return csv, root


def _videos(n=7, seed=0):
    """Transfer-eval items: float frames, 1-3 captions, 2 comments."""
    from vtc_tpu_torch.data.tokenizer import tokenize

    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(24, 3, 32, 32)).astype(np.float32),
             tokenize([f"unique video number {i} caption {j}" for j in range(1 + i % 3)]),
             tokenize([f"comment about {i}", "more text"]), {}) for i in range(n)]


def _start_evals(flagship, tmp):
    """One ``.pth`` of the flagship, the eval config over the corpus, the
    video items, written to ``tmp`` for the ranks; returns the spec."""
    from vtc_tpu_torch.training import save_checkpoint

    csv, root = _write_corpus(tmp)
    sd = state_dict_from_jax(flagship)
    ckpt = save_checkpoint(tmp, "model_best", arch="PretrainedCLIP_finaltf", epoch=1,
                           state_dict=sd)
    config = {
        "name": "eval_twin", "n_gpu": 1, "n_devices": 2, "batch_size": 3, "num_workers": 0,
        "arch": {"type": "PretrainedCLIP_finaltf",
                 "args": {"model_type": TINY, "freeze": "all", "branch_to_adapt": "text",
                          "branch_to_adapt_val": "text"}},
        "dataset": {"type": "ImTextDataset",
                    "args": {"root": str(root), "csv_file": str(csv), "add_comments": "always",
                             "comment_sampling": "random", "num_comms": 2, "image_size": 32}},
        "trainer": {"save_dir": str(tmp / "saved")},
    }
    (tmp / "evalrun").mkdir()
    spec = {"config": config, "ckpt": str(ckpt), "state_dict": sd, "videos": _videos()}
    torch.save(spec, tmp / "evals.pt")
    return spec


@pytest.fixture(scope="module")
def evals_run(background, steps_run):
    """The 2-rank evaluations' spec, directory and results."""
    spec, tmp = background["evals"], background["tmp"] / "evals"
    return spec, tmp, [torch.load(tmp / f"evals_rank{r}.pt", weights_only=False)
                       for r in (0, 1)]


def test_eval_twin_on_two_processes(evals_run, tmp_path, monkeypatch):
    """The 2-process recalls equal the single-process run's and the JAX
    package's multihost run (its gather patched with rank 1's blocks, as
    ``tests/test_cli.py`` does); rank 0 alone wrote the file; the config's
    run dir is made once."""
    import sys

    from vtc_tpu.config import ConfigParser as JaxConfigParser
    from vtc_tpu.utils import util as jax_util
    from vtc_tpu_torch.config import ConfigParser
    from vtc_tpu_torch.evaluation import eval as port_eval

    spec, tmp, ranks = evals_run
    assert [Path(f).name for f in ranks[0]["written"]] == [
        "model_best.pth_res_adapted_text_2_comms.json"]
    assert ranks[1]["written"] == []
    written = Path(ranks[0]["written"][0])
    assert json.loads(written.read_text()) == ranks[0]["recalls"] == ranks[1]["recalls"]
    assert len(list((tmp / "saved" / "models" / "eval_twin").iterdir())) == 1

    cfg = dict(spec["config"], n_devices=1)
    cfg["trainer"] = {"save_dir": str(tmp_path / "saved")}
    monkeypatch.chdir(tmp_path)
    single = port_eval.main(ConfigParser(cfg), R.EvalArgs(), spec["ckpt"], device="cpu")
    assert ranks[0]["recalls"] == single

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "evaluation"))
    import eval as jax_eval  # evaluation/eval.py

    blocks = []
    monkeypatch.setattr(jax_util, "allgather_varlen",
                        lambda arr: (blocks.append(np.asarray(arr)), np.asarray(arr))[1])
    jax_eval.main(JaxConfigParser(dict(cfg)), R.EvalArgs(), spec["ckpt"],
                  process_index=1, process_count=2)
    rank1 = iter(blocks)
    monkeypatch.setattr(jax_util, "allgather_varlen",
                        lambda arr: np.concatenate([np.asarray(arr), next(rank1)]))
    multi = jax_eval.main(JaxConfigParser(dict(cfg)), R.EvalArgs(), spec["ckpt"],
                          process_index=0, process_count=2)
    assert multi == pytest.approx(ranks[0]["recalls"], abs=1e-12)


def test_transfer_evaluation_on_two_processes(evals_run, flagship, monkeypatch):
    """``retrieval_evaluation`` with the videos split over 2 processes: the
    single-process table bit for bit, and the JAX package's multihost run
    (its gather patched with rank 1's blocks, as
    ``tests/test_transfer_eval_sharded.py`` does); one CSV."""
    from vtc_tpu.evaluation import retrieval_eval as jax_re
    from vtc_tpu_torch.evaluation.retrieval_eval import retrieval_evaluation

    spec, tmp, ranks = evals_run
    model = R.flagship_port(spec["state_dict"]).eval()
    single = retrieval_evaluation(model, "synthetic", "test", dataset=spec["videos"],
                                  frame_stride=4, device="cpu")
    for out in ranks:
        np.testing.assert_array_equal(out["table"], single.to_numpy())
    assert [p.name for p in (tmp / "evalrun").glob("*.csv")] == ["table.csv"]

    module, variables = JaxFlagship(model_type=TINY), {"params": flagship}
    blocks = []
    monkeypatch.setattr(jax_re, "_allgather_varlen",
                        lambda arr: (blocks.append(np.asarray(arr)), np.asarray(arr))[1])
    jax_re.retrieval_evaluation(module, variables, "synthetic", "test", dataset=spec["videos"],
                                frame_stride=4, process_index=1, process_count=2)
    rank1 = iter(blocks)
    monkeypatch.setattr(jax_re, "_allgather_varlen",
                        lambda arr: np.concatenate([np.asarray(arr), next(rank1)]))
    ref = jax_re.retrieval_evaluation(module, variables, "synthetic", "test",
                                      dataset=spec["videos"], frame_stride=4,
                                      process_index=0, process_count=2)
    np.testing.assert_array_equal(ranks[0]["table"], ref.to_numpy())


def _start_cli(tmp):
    """The train twin's config for 2 ranks over the corpus, written to
    ``tmp``: 2 epochs, then a resume."""
    csv, root = _write_corpus(tmp)
    cfg = {
        "name": "cli_twin", "n_gpu": 1, "batch_size": 4, "num_workers": 0,
        "arch": {"type": "PretrainedCLIP_finaltf",
                 "args": {"model_type": TINY, "freeze": "all", "branch_to_adapt": "text",
                          "branch_to_adapt_val": "text"}},
        "dataset": {"type": "ImTextDataset",
                    "args": {"root": str(root), "csv_file": str(csv),
                             "add_comments": "always", "comment_sampling": "random",
                             "num_comms": 2, "image_size": 32}},
        "optimizer": {"type": "Adam", "args": {"lr": 0.001, "weight_decay": 0, "amsgrad": True}},
        "loss": "clip_loss", "loss_args": {},
        "metrics": [{"type": "RecallAtK", "args": {"name_a": "visual", "name_b": "titles",
                                                   "k_vals": [1, 10]}}],
        "lr_scheduler": {"type": "StepLR", "args": {"step_size": 10, "gamma": 0.1}},
        "trainer": {"epochs": 2, "save_dir": str(tmp / "saved"), "save_period": 1,
                    "verbosity": 2, "monitor": "max val_titles_from_visual-recall_at_10",
                    "early_stop": 10, "tensorboard": False},
    }
    (tmp / "cli_config.json").write_text(json.dumps(cfg))


@pytest.fixture(scope="module")
def cli_run(background, steps_run):
    tmp = background["tmp"] / "cli"
    return tmp, [torch.load(tmp / f"cli_rank{r}.pt", weights_only=False) for r in (0, 1)]


def test_train_twin_on_two_ranks(cli_run):
    """One run dir per run, made by rank 0 with its ``config.json``;
    checkpoints of a single card's keys, written once, loadable by one
    process; the ranks' parameters equal after each epoch, the resume's
    too."""
    from vtc_tpu_torch.training import load_checkpoint

    tmp, ranks = cli_run
    assert ranks[0]["dirs"] == ranks[1]["dirs"]
    runs = sorted((tmp / "saved" / "models" / "cli_twin").iterdir())
    assert [str(r) for r in runs] == sorted(ranks[0]["dirs"])
    first, second = (Path(d) for d in ranks[0]["dirs"])
    assert sorted(p.name for p in first.iterdir() if p.suffix == ".pth")[:2] == [
        "checkpoint-epoch1.pth", "checkpoint-epoch2.pth"]
    assert (first / "config.json").exists() and (second / "config.json").exists()
    assert ranks[0]["start"] == ranks[1]["start"] == 2
    assert len(ranks[0]["epochs"]) == 3  # epochs 1 and 2, then the resumed epoch 2
    for a, b in zip(*(r["epochs"] for r in ranks)):
        assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)
    ckpt = load_checkpoint(first / "checkpoint-epoch2.pth")
    model = R.flagship_port(ckpt["state_dict"])  # strict: a single card's keys
    for n, p in model.named_parameters():
        assert torch.equal(p, ranks[0]["epochs"][1][n]), n
    assert any(not torch.equal(ranks[0]["epochs"][0][n], ranks[0]["epochs"][1][n])
               for n in ranks[0]["epochs"][0])  # the CAM trains
