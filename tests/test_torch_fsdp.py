"""ZeRO-3 of the port (``vtc_tpu_torch.parallel.mesh.fully_shard_model``:
FSDP2's ``fully_shard`` over the data axis of ``create_mesh``) on the CPU:
ranks of a gloo group, each a process spawned from
``tests/torch_dist_ranks.py`` (torch on one thread), against the port's
single-process step at the global batch, against its own DDP step and
against ``vtc_tpu``'s fsdp step on ``create_mesh(8, 1)`` of the 8-device
CPU mesh.

* The flagship at test-tiny, the CAM off its zero-init: three fp32 steps at
  dp2, the accumulating step (k = 2) and ``Bf16MomentAdam`` at dp2, one step
  at dp2×tp2 (4 ranks). Against one process: the losses within 2e-6 and
  the step-1 gradients within 1e-5 of each parameter's largest |gradient|
  (``test_torch_dist.GRAD_RTOL``). Against DDP on the same ranks: losses,
  gradients and parameters after the steps bit for bit (at W = 2 the mean
  of the reduce-scatter and of DDP's all-reduce are the same sums). Against
  ``vtc_tpu``'s fsdp step (``tests/test_fsdp.py``'s pattern, every leaf
  sharded): the losses at rtol 2e-5, as ``tests/test_parallel.py``.
* Each rank holds ⌈n/2⌉ rows of the token embedding and of each of its
  Adam moments.
* Checkpoints: a single-card ``.pth`` (parameters, moments, schedule) loads
  into the shards and gathers back bit for bit; the fsdp run's gathered
  ``.pth`` loads into one process, which steps on to the fsdp run's next
  loss; the train twin at ``--fsdp 1`` trains, writes a single-card
  ``.pth`` and resumes a single card's.
* ``retrieval_evaluation`` of a sharded model, alone and as the trainer's
  per-epoch probe, over an odd number of videos (the ranks run different
  numbers of forwards), and the ``eval.py`` twin of an fsdp run's config
  (the whole model on each rank) over an odd number of items: they end,
  under a timeout, with the single process's recalls.
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
    GRAD_RTOL,
    LOSS_ATOL,
    LOSS_RTOL_JAX,
    _case,
    _inputs,
    _videos,
    flagship,  # noqa: F401  (the module fixture)
)
from vtc_tpu.models.retrieval import PretrainedCLIP_finaltf as JaxFlagship
from vtc_tpu.ops import losses as jax_losses
from vtc_tpu_torch.models import state_dict_from_jax

TINY = R.TINY
TIMEOUT = 240  # s for a spawn: a rank left in a gather never ends
BF16_OPT = {"type": "AdamW", "args": {"lr": 1e-3, "weight_decay": 1e-2, "amsgrad": True,
                                      "moments_dtype": "bfloat16"}}
BASE36 = "0123456789abcdefghijklmnopqrstuvwxyz"
CLI_MODEL = {"model_type": TINY, "freeze": "all", "branch_to_adapt": "text",
             "branch_to_adapt_val": "text"}
CLI_OPT = {"type": "Adam", "args": {"lr": 0.001, "weight_decay": 0.01, "amsgrad": True}}
CLI_SCHED = {"type": "StepLR", "args": {"step_size": 10, "gamma": 0.1}}


def _jax_fsdp_run(params, data, steps=2):
    """``make_step_fns``' step on ``create_mesh(8, 1)`` with the state laid
    out by ``tree_shardings(..., fsdp=True)`` and every leaf sharded
    (``FSDP_MIN_SIZE`` 0, as ``tests/test_fsdp.py``), the adapter skip off:
    each step's loss."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vtc_tpu.parallel import mesh as mesh_mod
    from vtc_tpu.training.optim import build_optimizer as jax_build_optimizer
    from vtc_tpu.training.trainer import TrainState, make_step_fns

    module = JaxFlagship(model_type=TINY, random_skip_adapter=False)
    mesh = mesh_mod.create_mesh(8, 1)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_build_optimizer(params, R.OPT, R.SCHED, **R.STEP_KW)
    step, _ = make_step_fns(module, jax_losses.clip_loss, tx, donate=False)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), batch_stats={})
    min_size, mesh_mod.FSDP_MIN_SIZE = mesh_mod.FSDP_MIN_SIZE, 0
    try:
        state = jax.device_put(state, mesh_mod.tree_shardings(state, mesh, fsdp=True))
    finally:
        mesh_mod.FSDP_MIN_SIZE = min_size
    sharded = tuple(jax.device_put(a, NamedSharding(mesh, P(mesh_mod.DATA_AXIS)))
                    for a in data)
    losses = []
    with mesh:
        for k in range(steps):
            state, loss, _ = step(state, sharded, {}, jax.random.PRNGKey(k))
            losses.append(float(loss))
    return losses


def _write_corpus(tmp, n_test=5, n_val=8, n_train=24):
    """A thumbnail corpus whose splits hold ``n_test``, ``n_val`` and
    ``n_train`` rows (the split is the reddit id's last base-36 digit: test
    0-3, val 4-7, train 8-z); an odd test split leaves 2 ranks unequal
    shares."""
    import pandas as pd
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp / "media"
    (root / "vids").mkdir(parents=True)
    rows = []
    for split, n, digits in (("test", n_test, BASE36[:4]), ("val", n_val, BASE36[4:8]),
                             ("train", n_train, BASE36[8:])):
        for i in range(n):
            rid_str = "ab" + BASE36[i] + digits[i % len(digits)]
            rows.append({"reddit_id": int(rid_str, 36),
                         "video_path": f"results/vids/{rid_str}.mp4",
                         "title": f"a {split} video about topic {i}", "video_length": 10.0,
                         "comments": str([f"this is about {split} {i}", f"great {i}"])})
            Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
                root / "vids" / f"{rid_str}.jpg")
    csv = tmp / "posts.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    return csv, root


def _dataset_cfg(csv, root):
    return {"type": "ImTextDataset",
            "args": {"root": str(root), "csv_file": str(csv), "add_comments": "always",
                     "comment_sampling": "random", "num_comms": 2, "image_size": 32}}


def _single_step_ckpt(sd, tmp, data, draws):
    """One single-process step of the flagship from ``sd``, saved with its
    Adam moments and schedule as ``tmp/single_step.pth``."""
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.training import build_optimizer, save_checkpoint, train_step

    model = R.flagship_port(sd)
    optimizer, scheduler = build_optimizer(model, R.OPT, R.SCHED, **R.STEP_KW)
    train_step(model, clip_loss, optimizer, scheduler, [torch.from_numpy(a) for a in data],
               {}, draws=draws)
    return save_checkpoint(tmp, "single_step", arch="PretrainedCLIP_finaltf", epoch=1,
                           state_dict=model.state_dict(), optimizer=optimizer,
                           lr_scheduler=scheduler)


def _cli_spec(tmp):
    """The train twin's config over the corpus (1 epoch) and a single-card
    ``tmp/single/single.pth`` of its model after one step, at epoch 1."""
    from vtc_tpu_torch.models import create_model
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.training import build_optimizer, save_checkpoint, train_step

    csv, root = _write_corpus(tmp / "cli")
    cfg = {
        "name": "fsdp_twin", "n_gpu": 1, "batch_size": 4, "num_workers": 0,
        "arch": {"type": "PretrainedCLIP_finaltf", "args": dict(CLI_MODEL)},
        "dataset": _dataset_cfg(csv, root), "optimizer": CLI_OPT,
        "loss": "clip_loss", "loss_args": {},
        "metrics": [{"type": "RecallAtK", "args": {"name_a": "visual", "name_b": "titles",
                                                   "k_vals": [1, 10]}}],
        "lr_scheduler": CLI_SCHED,
        "trainer": {"epochs": 1, "save_dir": str(tmp / "saved"), "save_period": 1,
                    "verbosity": 2, "monitor": "max val_titles_from_visual-recall_at_10",
                    "early_stop": 10, "tensorboard": False},
    }
    (tmp / "cli_config.json").write_text(json.dumps(cfg))
    model = create_model("PretrainedCLIP_finaltf", seed=3, device="cpu", **CLI_MODEL)
    optimizer, scheduler = build_optimizer(model, CLI_OPT, CLI_SCHED, steps_per_epoch=6)
    data = [torch.from_numpy(a) for a in _inputs(seed=4)]
    data[2] = data[2][:, :2]
    train_step(model, clip_loss, optimizer, scheduler, data, {},
               generator=torch.Generator().manual_seed(0))
    (tmp / "single").mkdir()
    (tmp / "single" / "config.json").write_text(json.dumps(cfg))  # what -r reads
    save_checkpoint(tmp / "single", "single", arch="PretrainedCLIP_finaltf", epoch=1,
                    state_dict=model.state_dict(), optimizer=optimizer,
                    lr_scheduler=scheduler, config=cfg)
    return cfg


def _eval_spec(sd, tmp):
    from vtc_tpu_torch.training import save_checkpoint

    csv, root = _write_corpus(tmp / "eval")
    ckpt = save_checkpoint(tmp, "model_best", arch="PretrainedCLIP_finaltf", epoch=1,
                           state_dict=sd)
    config = {
        "name": "eval_fsdp", "n_gpu": 1, "n_devices": 2, "fsdp": 1, "batch_size": 2,
        "num_workers": 0, "arch": {"type": "PretrainedCLIP_finaltf", "args": dict(CLI_MODEL)},
        "dataset": _dataset_cfg(csv, root), "trainer": {"save_dir": str(tmp / "saved")},
    }
    (tmp / "evalrun").mkdir()
    return {"config": config, "ckpt": str(ckpt), "state_dict": sd, "videos": _videos(7)}


def _with_ddp(cases):
    """Each ZeRO-3 case beside its DDP twin (``<name>_ddp``)."""
    out = {}
    for name, case in cases.items():
        out[name] = dict(case, fsdp=True)
        out[f"{name}_ddp"] = dict(case, fsdp=False)
    return out


@pytest.fixture(scope="module")
def fsdp_runs(flagship, tmp_path_factory):  # noqa: F811
    """The spawns of dp2 (the step cases, the checkpoint round trip, the
    train twin, the evaluations) and dp2×tp2 (one step), started before
    ``vtc_tpu``'s fsdp step, which runs beside them; returns (the specs, the
    JAX losses, each spawn's ranks' results)."""
    sd = state_dict_from_jax(flagship)
    gen = torch.Generator().manual_seed(3)
    skips = [{"adapter_skip": torch.rand((8, 1), generator=gen) > 0.5} for _ in range(3)]
    off = dict(model_kw=dict(random_skip_adapter=False))
    specs, contexts = {}, {}
    tmp = tmp_path_factory.mktemp("fsdp2")
    data = _inputs(seed=2)
    specs[2] = {
        "n_model": 1,
        "cases": _with_ddp({
            "plain": _case(sd, data, skips),
            "accum": _case(sd, data, skips[:2], accum=2),
            "bf16": _case(sd, data, skips[:2], opt=BF16_OPT),
            "jax": _case(sd, _inputs(seed=1), **off),
        }),
        "round_trip": {"state_dict": sd, "ckpt": str(_single_step_ckpt(sd, tmp, data,
                                                                        skips[0])),
                       "data": data, "draws": skips[1:]},
        "cli": _cli_spec(tmp),
        "evals": _eval_spec(sd, tmp),
    }
    torch.save(specs[2], tmp / "fsdp.pt")
    contexts[2] = (tmp, R.spawn(R.run_fsdp, 2, tmp, join=False))
    tmp4 = tmp_path_factory.mktemp("fsdp4")
    specs[4] = {"n_model": 2,
                "cases": _with_ddp({"plain": _case(sd, data, skips[:1])})}
    torch.save(specs[4], tmp4 / "fsdp.pt")
    contexts[4] = (tmp4, R.spawn(R.run_fsdp, 4, tmp4, join=False))
    jax_losses_ = _jax_fsdp_run(flagship, _inputs(seed=1))
    ranks = {}
    for world, (where, context) in contexts.items():
        R.wait(context, timeout=TIMEOUT)
        ranks[world] = [torch.load(where / f"fsdp_rank{r}.pt", weights_only=False)
                        for r in range(world)]
    return specs, jax_losses_, ranks, tmp


_SINGLE = {}


def _single(specs, world, case):
    """The port's single-process run of a case."""
    if (world, case) not in _SINGLE:
        _SINGLE[world, case] = R.step_case(dict(specs[world]["cases"][case], fsdp=False))
    return _SINGLE[world, case]


@pytest.mark.parametrize("world, case", [(2, "plain"), (2, "accum"), (2, "bf16"),
                                         (2, "jax"), (4, "plain")])
def test_sharded_step_matches_one_process_and_ddp(fsdp_runs, world, case):
    specs, _, ranks, _ = fsdp_runs
    single = _single(specs, world, case)
    ours, ddp = ranks[world][0]["cases"][case], ranks[world][0]["cases"][f"{case}_ddp"]
    assert len(ours["losses"]) == len(specs[world]["cases"][case]["draws"] or [0, 0])
    np.testing.assert_allclose(ours["losses"], single["losses"], atol=LOSS_ATOL, rtol=0)
    assert ours["shapes"] == single["shapes"]
    assert sorted(ours["grads"]) == sorted(single["grads"])
    for name, g in single["grads"].items():
        assert (ours["grads"][name] is None) == (g is None), name
        if g is None:
            continue
        err = float((ours["grads"][name] - g).abs().max())
        assert err <= GRAD_RTOL * float(g.abs().max()), (name, err)
    # FSDP2's mean of the reduce-scatter is DDP's mean of the all-reduce
    assert ours["losses"] == ddp["losses"]
    for name, p in ddp["params"].items():
        assert torch.equal(ours["params"][name], p), name
        g = ddp["grads"][name]
        assert (g is None and ours["grads"][name] is None) or torch.equal(
            ours["grads"][name], g), name
    for r, other in enumerate(ranks[world]):  # every rank gathers the same state
        got = other["cases"][case]
        assert got["losses"] == ours["losses"], r
        for name, p in got["params"].items():
            assert torch.equal(p, ours["params"][name]), (r, name)


def test_sharded_step_matches_jax_fsdp(fsdp_runs):
    _, jax_losses_, ranks, _ = fsdp_runs
    ours = ranks[2][0]["cases"]["jax"]
    np.testing.assert_allclose(ours["losses"], jax_losses_, rtol=LOSS_RTOL_JAX)
    assert ours["shapes"][2] == (8, 8)  # the global batch's similarity


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_rows_of_parameters_and_moments(fsdp_runs, world):
    """A data rank holds ⌈n/2⌉ rows (the last one the rest) of every
    parameter and of each of its Adam moments; the DDP twin holds them all
    (split over the model axis on 4 ranks)."""
    specs, _, ranks, _ = fsdp_runs
    model = R.flagship_port(specs[world]["cases"]["plain"]["state_dict"])
    n_model = specs[world]["n_model"]
    for r, out in enumerate(ranks[world]):
        d = r // n_model
        case, ddp = out["cases"]["plain"], out["cases"]["plain_ddp"]
        for name, p in model.named_parameters():
            if p.dim() == 0:  # logit_scale: whole on every rank
                assert case["local_params"][name].shape == p.shape
                continue
            part = ddp["local_params"][name].shape  # this model place's part
            mine = (part[0] + 1) // 2 if d == 0 else part[0] - (part[0] + 1) // 2
            assert case["local_params"][name].shape == (mine,) + tuple(part[1:]), name
            for key, shape in case["local_moments"].get(name, {}).items():
                assert shape == case["local_params"][name].shape, (name, key)
        emb = case["local_moments"]["model.token_embedding.weight"]
        assert sorted(emb) == ["exp_avg", "exp_avg_sq", "max_exp_avg_sq"]
        assert emb["exp_avg"][0] == 49408 // n_model // 2


def test_single_card_checkpoints_cross_into_the_shards_and_back(fsdp_runs):
    """The single-card ``.pth`` loads into the dp2 shards and gathers back
    bit for bit (parameters, Adam moments); the fsdp run's gathered ``.pth``
    loads into one process (``strict``), which steps on to the fsdp run's
    next loss; both fsdp losses are one process's."""
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.training import build_optimizer, load_checkpoint, train_step

    specs, _, ranks, tmp = fsdp_runs
    spec = specs[2]["round_trip"]
    ckpt = load_checkpoint(spec["ckpt"])
    for out in ranks[2]:
        state, opt = out["round_trip"]["loaded"]
        assert state.keys() == ckpt["state_dict"].keys()
        for n, t in ckpt["state_dict"].items():
            assert torch.equal(state[n], t), n
        assert opt["state"].keys() == ckpt["optimizer"]["state"].keys()
        for i, entry in ckpt["optimizer"]["state"].items():
            for k, v in entry.items():
                assert torch.equal(opt["state"][i][k], v), (i, k)
        assert out["round_trip"]["shards"]["param"] == (49408 // 2, 64)
        assert set(out["round_trip"]["shards"]["moments"].values()) == {(49408 // 2, 64)}
    losses = ranks[2][0]["round_trip"]["losses"]
    assert ranks[2][1]["round_trip"]["losses"] == losses

    data = [torch.from_numpy(a) for a in spec["data"]]
    for step, path in enumerate((spec["ckpt"], tmp / "fsdp_step.pth")):
        saved = load_checkpoint(path)
        model = R.flagship_port(saved["state_dict"])  # strict: a single card's keys
        optimizer, scheduler = build_optimizer(model, R.OPT, R.SCHED, **R.STEP_KW)
        optimizer.load_state_dict(saved["optimizer"])
        scheduler.load_state_dict(saved["lr_scheduler"])
        loss, _ = train_step(model, clip_loss, optimizer, scheduler, data, {},
                             draws=spec["draws"][step])
        assert abs(float(loss) - losses[step]) <= LOSS_ATOL, (step, float(loss), losses[step])


def test_train_twin_at_fsdp(fsdp_runs):
    """``--fsdp 1`` on 2 ranks: one run dir per run, the ranks' gathered
    parameters equal, rank 0's ``.pth`` a single card's (``strict``) with
    its epoch's parameters; the second run resumes the single-card
    ``.pth`` into its shards bit for bit (moments and schedule too) and
    trains its second epoch sharded."""
    from vtc_tpu_torch.training import load_checkpoint

    specs, _, ranks, tmp = fsdp_runs
    outs = [r["cli"] for r in ranks[2]]
    assert outs[0]["dirs"] == outs[1]["dirs"] and outs[0]["start"] == outs[1]["start"] == 2
    assert outs[0]["sharded"] and outs[1]["sharded"]
    for a, b in zip(outs[0]["epochs"], outs[1]["epochs"]):
        assert all(torch.equal(a[n], b[n]) for n in a)
    ckpt = load_checkpoint(Path(outs[0]["dirs"][0]) / "checkpoint-epoch1.pth")
    model = R.flagship_port(ckpt["state_dict"], **{k: v for k, v in CLI_MODEL.items()
                                                   if k != "model_type"})
    for n, p in model.state_dict().items():
        assert torch.equal(p, outs[0]["epochs"][0][n]), n
    single = load_checkpoint(tmp / "single" / "single.pth")
    for out in outs:
        state, opt, step = out["resumed"][0]
        for n, t in single["state_dict"].items():
            assert torch.equal(state[n], t), n
        for i, entry in single["optimizer"]["state"].items():
            for k, v in entry.items():
                assert torch.equal(opt["state"][i][k], v), (i, k)
        assert step == single["lr_scheduler"]["last_epoch"] == 1
    moved = [n for n in outs[0]["epochs"][1] if n.startswith("final_transformer.")
             and not torch.equal(outs[0]["epochs"][1][n], single["state_dict"][n])]
    assert moved  # the resumed run trained the CAM


def test_evaluations_of_a_sharded_model_over_odd_shares(fsdp_runs, tmp_path, monkeypatch):
    """``retrieval_evaluation`` (7 videos: 4 and 3 a rank) of a model
    sharded over 2 data ranks, alone and as the train twin's per-epoch probe
    (normal and adapter-skip), ends (a forward that gathered inside would
    leave one rank waiting: the spawn's timeout) with the single process's
    recalls, and the model is sharded again after; the ``eval.py`` twin of
    an fsdp run's config (5 test items: 3 and 2 a rank, batches of 2) ends
    with them too, and rank 0 alone writes."""
    from vtc_tpu_torch.config import ConfigParser
    from vtc_tpu_torch.evaluation import eval as port_eval
    from vtc_tpu_torch.evaluation.retrieval_eval import retrieval_evaluation

    specs, _, ranks, _ = fsdp_runs
    ev = specs[2]["evals"]
    outs = [r["evals"] for r in ranks[2]]
    assert [Path(f).name for f in outs[0]["written"]] == [
        "model_best.pth_res_adapted_text_2_comms.json"]
    assert outs[1]["written"] == []
    assert outs[0]["sharded_after"] and outs[1]["sharded_after"]
    cfg = dict(ev["config"], n_devices=1, fsdp=0)
    cfg["trainer"] = {"save_dir": str(tmp_path / "saved")}
    monkeypatch.chdir(tmp_path)
    single = port_eval.main(ConfigParser(cfg), R.EvalArgs(), ev["ckpt"], device="cpu")
    for out in outs:
        assert out["recalls"] == single
    model = R.flagship_port(ev["state_dict"]).eval()
    table = retrieval_evaluation(model, "synthetic", "test", dataset=ev["videos"],
                                 frame_stride=4, device="cpu")
    for out in outs:
        np.testing.assert_array_equal(out["table"], table.to_numpy())
    # the trainer's probe after the first run's epoch, on that epoch's weights
    clis = [r["cli"] for r in ranks[2]]
    model = R.flagship_port(clis[0]["epochs"][0], **{k: v for k, v in CLI_MODEL.items()
                                                    if k != "model_type"}).eval()
    for i, branch in enumerate((None, "skip")):
        table = retrieval_evaluation(model, "synthetic", "test", dataset=ev["videos"],
                                     frame_stride=4, branch_override=branch, device="cpu")
        for cli in clis:
            assert cli["probes"][i][0] == branch
            np.testing.assert_array_equal(cli["probes"][i][1], table.to_numpy())
