"""The MoE adapter on more than one rank (``vtc_tpu_torch.parallel.expert``)
on the CPU: ranks of a gloo group spawned from ``tests/torch_dist_ranks.py``
(torch on one thread), against ``vtc_tpu.parallel.expert.MoEMLP`` on
``create_ep_mesh(2, 2)`` of the 8-device CPU mesh, computed in the test
process beside them, and against the port's one-process step.

* ``MoEMLP`` on dp2, dp1×ep2 and dp2×ep2: the rows' outputs within 2e-5 of
  ``vtc_tpu``'s, the global routing (expert ids, queue positions, keeps)
  equal to ``vtc_tpu``'s line for line and the aux loss within 1e-6; the
  input's and the parameters' gradients those of one process. At capacity
  factor 0.5 the global capacity drops tokens that a per-rank routing would
  keep, and the ranks drop exactly the global ones.
* ``configs/pretrained_clip_comments_attn_moe.jsonc`` at test-tiny: its
  train step on dp2 (also under ZeRO-3), dp1×tp2, dp1×ep2 and dp2×ep2,
  plain and at ``accum_steps`` 2, against the one-rank step (which
  ``tests/test_torch_expert.py`` holds to ``make_step_fns``): losses within
  2e-6, gradients within ``GRAD_RTOL`` of each parameter's largest
  (``TP_GRAD_RTOL`` on the model axis), the routing equal; each expert rank
  holds half of the expert stacks and of their Adam moments, in storage of
  its own.
* The train twin at ``--ep 2``: a single-card ``.pth`` that a whole model
  loads strictly, a resume that restores it bit for bit; the strided
  ``retrieval_evaluation`` of a model split at dp2×ep2 over an odd number
  of videos against one process.
* The refusals: an expert degree that does not divide ``nE``, two non-data
  axes, ``--ep`` without MoE, ``--ep`` beside ``--slices``.
* On the card (``-m cuda``): the dp1×ep2 step over gloo against one rank.

JAX is imported inside the CPU tests only, so the card test collects on a
machine without it (``--noconftest``).
"""

import json
import logging
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from vtc_tpu_torch.data import extract_patches, synthetic_tokens

E, N_EXP, TOP_K = 32, 4, 2
ATOL = 2e-5  # the MoE layer's output against vtc_tpu's
AUX_ATOL = 1e-6
LOSS_ATOL = 2e-6  # the steps against one rank's (tests/test_torch_dist.py)
GRAD_RTOL = 1e-5
# on the model axis the split attentions feed the MoE inputs rounded in
# another order, and the router's gradient (largest 0.02, a sum over the
# tokens) moves by up to 1.18e-5 of its largest at test-tiny
TP_GRAD_RTOL = 2e-5
TIMEOUT = 300
CONFIG = (Path(__file__).resolve().parents[1] / "configs"
          / "pretrained_clip_comments_attn_moe.jsonc")
# (name, (axis, n_data, n_second)) of each spawn's meshes, in order
MESHES = {2: [("dp2", ("model", 2, 1)), ("dp1xtp2", ("model", 1, 2)),
              ("dp1xep2", ("expert", 1, 2))],
          4: [("dp2xep2", ("expert", 2, 2))]}
LAYER_MESHES = ["dp2", "dp1xep2", "dp2xep2"]
STEP_CASES = [("dp2", "plain"), ("dp2", "accum"), ("dp2", "fsdp"), ("dp1xtp2", "plain"),
              ("dp1xep2", "plain"), ("dp1xep2", "accum"), ("dp2xep2", "plain"),
              ("dp2xep2", "accum")]


def _model_kw():
    from vtc_tpu_torch.utils import jsonc

    args = dict(jsonc.read_json(CONFIG)["arch"]["args"])
    assert (args.pop("moe_experts"), args.pop("moe_top_k")) == (N_EXP, TOP_K)
    args.pop("model_type")
    return dict(args, moe_experts=N_EXP, moe_top_k=TOP_K)


def _inputs(batch=8, seed=2):
    rng = np.random.default_rng(seed)
    vis = extract_patches(rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8), 8)
    return [vis, synthetic_tokens((batch,), 16, 14, rng),
            synthetic_tokens((batch, 5), 16, 14, rng)]


def _state_dict():
    """The MoE flagship at test-tiny, its CAM moved off the zero-init (else
    the experts' first layers take no gradient)."""
    from vtc_tpu_torch.models import create_model

    sd = create_model("PretrainedCLIP_finaltf", model_type=R.TINY, device="cpu",
                      **_model_kw()).state_dict()
    gen = torch.Generator().manual_seed(0)
    return {k: v + 0.05 * torch.randn(v.shape, generator=gen)
            if not k.startswith("model.") and v.is_floating_point() else v
            for k, v in sd.items()}


def _step_cases(sd):
    step = dict(state_dict=sd, data=_inputs(), steps=2, model_kw=_model_kw())
    return {"plain": step, "accum": dict(step, accum=2), "fsdp": dict(step, fsdp=True)}


def _layer_params(seed=0):
    """Params of ``vtc_tpu``'s MoEMLP (the shapes of its init, seeded normal
    values: the biases off zero, so that a dropped token differs from a
    kept one), its input and the backward's weights."""
    import jax
    import jax.numpy as jnp

    from vtc_tpu.parallel import expert as jax_expert

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, 6, E)).astype(np.float32)
    jm = jax_expert.MoEMLP(E, N_EXP, router_top_k=TOP_K)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    std = {"router": 0.3, "w_fc": E ** -0.5, "w_proj": (4 * E) ** -0.5}
    params = {n: rng.normal(0, std.get(n, 0.1), leaf.shape).astype(np.float32)
              for n, leaf in shapes["params"].items()}
    return params, x, rng.normal(size=x.shape).astype(np.float32)


def _layer_cases():
    params, x, c = _layer_params()
    return {f"layer_cf{cf}": {"layer": (E, N_EXP, TOP_K, cf), "params": params, "x": x, "c": c}
            for cf in (1.25, 0.5)}


def _cli_config(tmp):
    from test_torch_dist import _write_corpus

    from vtc_tpu_torch.utils import jsonc

    csv, root = _write_corpus(tmp / "cli")
    cfg = jsonc.read_json(CONFIG)
    cfg["arch"]["args"]["model_type"] = R.TINY
    cfg["dataset"]["args"].update(root=str(root), csv_file=str(csv), num_comms=2,
                                  image_size=32)
    cfg.update(batch_size=4, num_workers=0)
    cfg["trainer"].update(epochs=1, save_dir=str(tmp / "saved"), tensorboard=False)
    (tmp / "cli_config.json").write_text(json.dumps(cfg))


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """The spawns of 2 ranks (dp2, dp1×tp2, dp1×ep2, then the twin at
    ``--ep 2``) and 4 ranks (dp2×ep2, then the strided evaluations), started
    before ``vtc_tpu``'s layers compile beside them, and the one-process
    references made while they run; returns (the layer cases, the step
    cases, the JAX runs and the one-process results, each spawn's ranks'
    results)."""
    from test_torch_dist import _videos

    from vtc_tpu_torch.evaluation.retrieval_eval import retrieval_evaluation

    sd = _state_dict()
    steps, layers = _step_cases(sd), _layer_cases()
    contexts = {}
    for world, meshes in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"ep{world}")
        spec = {"meshes": [(name, mesh, dict(layers if name in LAYER_MESHES else {}, **{
            case: steps[case] for m, case in STEP_CASES if m == name}))
            for name, mesh in meshes]}
        if world == 2:
            _cli_config(tmp)
            spec["cli"] = True
        else:
            spec["evals"] = {"state_dict": sd, "model_kw": _model_kw(), "videos": _videos()}
        torch.save(spec, tmp / "ep.pt")
        contexts[world] = (tmp, R.spawn(R.run_ep, world, tmp, join=False))
    refs = {name: _jax_layer(case) for name, case in layers.items()}
    refs.update({("single", name): R.moe_layer_case(case) for name, case in layers.items()})
    refs.update({("single", case): R.step_case(steps[case]) for case in ("plain", "accum")})
    model = R.flagship_port(sd, **_model_kw()).eval()
    refs["table"] = retrieval_evaluation(model, "synthetic", "test", dataset=_videos(),
                                         frame_stride=4, device="cpu").to_numpy()
    ranks = {}
    for world, (tmp, context) in contexts.items():
        R.wait(context, timeout=TIMEOUT)
        for r in range(world):
            out = torch.load(tmp / f"ep_rank{r}.pt", weights_only=False)
            for key, value in out.items():
                ranks.setdefault(key, []).append(value)
        ranks["tmp", world] = tmp
    return layers, steps, refs, ranks


def _jax_layer(case):
    """``vtc_tpu``'s MoEMLP on ``create_ep_mesh(2, 2)``: its output, aux loss
    and routing (``test_torch_expert._jax_routing``, line for line)."""
    import jax
    import jax.numpy as jnp

    from test_torch_expert import _jax_routing
    from vtc_tpu.parallel import expert as jax_expert

    _, n_exp, k, cf = case["layer"]
    mesh = jax_expert.create_ep_mesh(2, 2, devices=jax.devices()[:4])
    try:
        jm = jax_expert.MoEMLP(E, n_exp, router_top_k=k, capacity_factor=cf)
        params = jax.tree_util.tree_map(jnp.asarray, case["params"])

        def apply(p, x):
            return jm.apply({"params": p}, x, mutable=["losses"])

        with mesh:
            y, state = jax.jit(apply)(params, jnp.asarray(case["x"]))
    finally:
        jax_expert.set_expert_mesh(None)
    xt = case["x"].reshape(-1, E)
    cap = math.ceil(cf * k * xt.shape[0] / n_exp)
    routing = _jax_routing(jnp.asarray(xt), jnp.asarray(case["params"]["router"]), k, cap)
    return np.asarray(y), float(state["losses"]["moe_aux"][0]), routing


def _data_places(name):
    """The rank of each data place's first expert/model place."""
    n_data, n_second = {"dp2": (2, 1), "dp1xtp2": (1, 2), "dp1xep2": (1, 2),
                        "dp2xep2": (2, 2)}[name]
    return [d * n_second for d in range(n_data)]


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("mesh", LAYER_MESHES)
def test_moe_layer_matches_jax_on_an_ep_mesh(ep_runs, mesh, cf):
    layers, _, jax_runs, ranks = ep_runs
    name = f"layer_cf{cf}"
    outs = ranks[mesh, name]
    ref_y, ref_aux, (idx_j, pos_j, keep_j) = jax_runs[name]
    places = _data_places(mesh)
    y = torch.cat([outs[r]["y"] for r in places]).numpy()
    np.testing.assert_allclose(y, ref_y, atol=ATOL, rtol=1e-4)
    for out in outs:  # every rank routes the global tokens alike
        idx, pos, keep = (t.numpy() for t in out["routing"])
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_array_equal(pos, pos_j)
        np.testing.assert_array_equal(keep, keep_j)
        assert abs(out["aux"] - ref_aux) <= AUX_ATOL
        assert out["routing"][0].shape[0] == 48  # T global

    # the backward: one process's gradients (each data place's rows' share)
    single = jax_runs["single", name]
    x_grad = torch.cat([outs[r]["x_grad"] for r in places])
    torch.testing.assert_close(x_grad, single["x_grad"], atol=1e-5, rtol=1e-5)
    for n, g in single["grads"].items():
        total = sum(outs[r]["grads"][n] for r in places)
        assert float((total - g).abs().max()) <= GRAD_RTOL * float(g.abs().max()), n


@pytest.mark.parametrize("mesh", ["dp2", "dp2xep2"])
def test_overflow_drops_only_under_the_global_capacity(ep_runs, mesh):
    """At capacity factor 0.5 (12 slots of the 48 tokens' 96 assignments)
    tokens are dropped; routing each data rank's 24 tokens on their own (6
    slots) would keep another set. The ranks keep exactly the global set,
    and a token dropped in both its slots gives zero."""
    from vtc_tpu_torch.parallel.expert import route

    layers, _, jax_runs, ranks = ep_runs
    case = layers["layer_cf0.5"]
    _, _, (_, _, keep_j) = jax_runs["layer_cf0.5"]
    assert 0 < keep_j.sum() < keep_j.size
    xt = torch.from_numpy(case["x"].reshape(-1, E))
    probs = torch.softmax(xt @ torch.from_numpy(case["params"]["router"]), -1)
    cap_local = math.ceil(0.5 * TOP_K * 24 / N_EXP)
    local = torch.cat([route(half, TOP_K, cap_local)[3] for half in probs.split(24)])
    assert not np.array_equal(local.numpy(), keep_j)
    for out in ranks[mesh, "layer_cf0.5"]:
        np.testing.assert_array_equal(out["routing"][2].numpy(), keep_j)
    y = torch.cat([ranks[mesh, "layer_cf0.5"][r]["y"] for r in _data_places(mesh)])
    dropped = ~torch.from_numpy(keep_j).any(1)
    assert dropped.any() and not y.reshape(-1, E)[dropped].any()


@pytest.mark.parametrize("mesh, case", STEP_CASES)
def test_moe_step_matches_one_rank(ep_runs, mesh, case):
    _, _, refs, ranks = ep_runs
    single = refs["single", "plain" if case == "fsdp" else case]
    outs = ranks[mesh, case]
    rtol = TP_GRAD_RTOL if "tp" in mesh else GRAD_RTOL
    for out in outs:
        np.testing.assert_allclose(out["losses"], single["losses"], atol=LOSS_ATOL, rtol=0)
        assert sorted(out["grads"]) == sorted(single["grads"])
        for name, g in single["grads"].items():
            assert (out["grads"][name] is None) == (g is None), name
            if g is not None:
                err = float((out["grads"][name] - g).abs().max())
                assert err <= rtol * float(g.abs().max()), (name, err)
        assert len(out["routing"]) == 2  # the CAM's two MoE blocks
        for got, ref in zip(out["routing"], single["routing"]):
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
        for name, p in out["params"].items():  # the ranks stay equal
            assert torch.equal(p, outs[0]["params"][name]), name
    moved = [n for n, g in single["grads"].items() if ".mlp_moe." in n and g is not None
             and g.abs().max() > 0]
    assert {n.rsplit(".", 1)[1] for n in moved} == {"router", "w_fc", "bias_fc", "w_proj",
                                                   "bias_proj"}


@pytest.mark.parametrize("mesh", ["dp1xep2", "dp2xep2"])
def test_each_expert_rank_holds_half_the_stacks_and_moments(ep_runs, mesh):
    from vtc_tpu_torch.parallel.expert import moe_pspec, moe_shardings

    _, steps, _, ranks = ep_runs
    whole = R.flagship_port(steps["plain"]["state_dict"], **_model_kw())
    shapes = {n: tuple(p.shape) for n, p in whole.named_parameters()}
    stacks = [n for n, axis in moe_shardings(whole).items() if axis == "expert"]
    assert len(stacks) == 8  # 4 leaves of 2 blocks
    for r, out in enumerate(ranks[mesh, "plain"]):
        ours = sum(out["local_params"][n].numel() for n in stacks)
        assert ours / sum(math.prod(shapes[n]) for n in stacks) == 0.5
        # in storage of its own: a view of the whole stack would hold all of it
        assert sum(out["storage"][n] for n in stacks) == 4 * ours
        for n, p in out["local_params"].items():
            x = r % 2
            if moe_pspec(n):
                half = out["params"][n].chunk(2)[x]
                assert torch.equal(p, half), n  # this rank's experts, x·nE/X ...
                moments = out["local_moments"][n]
                assert set(moments) == {"exp_avg", "exp_avg_sq", "max_exp_avg_sq"}
                assert all(m == tuple(p.shape) for m in moments.values()), n
            else:
                assert tuple(p.shape) == shapes[n], n  # the router and the rest whole


def test_twin_at_ep2_writes_single_card_checkpoints(ep_runs):
    """Rank 0's ``.pth`` holds a single card's keys and shapes (the stacks
    gathered), loads strictly into a whole model, equals the gathered state
    of its epoch, and the resume restores it and its Adam moments bit for
    bit on both ranks, whose stacks are halves again."""
    from vtc_tpu_torch.parallel.expert import moe_pspec
    from vtc_tpu_torch.training import load_checkpoint

    _, _, _, ranks = ep_runs
    out = ranks["cli"]
    assert out[0]["dirs"] == out[1]["dirs"] and out[0]["start"] == out[1]["start"] == 2
    ckpt = load_checkpoint(Path(out[0]["dirs"][0]) / "checkpoint-epoch1.pth")
    model = R.flagship_port(ckpt["state_dict"], **_model_kw())  # strict
    for r in (0, 1):
        state, opt = out[r]["resumed"][0]
        for n, p in model.state_dict().items():
            assert torch.equal(state[n], p) and torch.equal(out[r]["epochs"][0][n], p), (r, n)
        assert opt["state"].keys() == ckpt["optimizer"]["state"].keys()
        for i, entry in ckpt["optimizer"]["state"].items():
            for k, v in entry.items():
                assert torch.equal(opt["state"][i][k], v), (r, i, k)
        for n, p in out[r]["local"].items():
            if moe_pspec(n):
                assert torch.equal(p, out[r]["epochs"][1][n].chunk(2)[r]), n
    moved = [n for n in ckpt["state_dict"] if moe_pspec(n)
             and not torch.equal(out[0]["epochs"][1][n], out[0]["epochs"][0][n])]
    assert moved  # the second epoch trained the experts


def test_strided_evaluation_of_a_split_model(ep_runs):
    """dp2×ep2: each data rank evaluates its share of 7 videos (4 and 3)
    with the experts gathered whole around the forwards, each call routing
    its own tokens; the tables of one process, twice, and the stacks split
    again after."""
    _, _, refs, ranks = ep_runs
    ref = refs["table"]
    for out in ranks["evals"]:
        assert out["split_after"]
        for table in out["tables"]:
            np.testing.assert_array_equal(table, ref)


def test_refusals(tmp_path):
    """An expert degree that does not divide the 4 experts raises before
    anything is split; the train twin raises as ``vtc_tpu``'s ``train.py``
    does for two non-data axes, ``--ep`` without MoE and ``--ep`` beside
    ``--slices``."""
    from test_torch_train_cli import _config

    from vtc_tpu_torch import train as twin
    from vtc_tpu_torch.config import ConfigParser
    from vtc_tpu_torch.parallel.expert import shard_experts
    from vtc_tpu_torch.parallel.tensor import ModelAxis

    model = R.flagship_port(_state_dict(), **_model_kw())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="'expert' \\(size 3\\) does not divide dim 0"):
        shard_experts(model, ModelAxis(None, 0, 3))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    assert shard_experts(model, ModelAxis(None, 0, 1)) is model
    moe = {"moe_experts": N_EXP, "moe_top_k": TOP_K}
    for extra, arch, match in [
            ({"ep": 2, "n_model": 2}, moe, "at most one non-data mesh axis"),
            ({"ep": 2, "pp": 2}, moe, "at most one non-data mesh axis"),
            ({"ep": 2}, {}, "this arch has no MoE"),
            ({"ep": 2, "slices": 2}, moe, "--slices composes with dp/tp/fsdp")]:
        cfg = _config(tmp_path, "x.csv", "x", **extra)
        cfg["arch"]["args"].update(arch)
        with pytest.raises(ValueError, match=match):
            twin.main(ConfigParser(cfg), device="cpu")
    # one process without a group: --ep warns and goes on unsharded
    cfg = _config(tmp_path, tmp_path / "x.csv", tmp_path, ep=2)
    cfg["arch"]["args"].update(moe)
    twin._check_mesh(ConfigParser(cfg), torch.device("cpu"), logging.getLogger("test"))


@pytest.mark.cuda
def test_ep2_step_on_the_card_over_gloo(tmp_path):
    """dp1×ep2 over gloo with both ranks on the card: the MoE config's
    step of one rank on the card, losses within 2e-6, gradients within
    ``GRAD_RTOL``, the routing equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ranks run their kernels there")
    case = dict(_step_cases(_state_dict())["plain"], device="cuda")
    torch.save({"meshes": [("dp1xep2", ("expert", 1, 2), {"plain": case})], "device": "cuda"},
               tmp_path / "ep.pt")
    R.wait(R.spawn(R.run_ep, 2, tmp_path, join=False), timeout=TIMEOUT)
    single = R.step_case(case)
    for r in range(2):
        out = torch.load(tmp_path / f"ep_rank{r}.pt", weights_only=False,
                         map_location="cpu")["dp1xep2", "plain"]
        np.testing.assert_allclose(out["losses"], single["losses"], atol=LOSS_ATOL, rtol=0)
        for name, g in single["grads"].items():
            if g is not None:
                err = float((out["grads"][name].cpu() - g.cpu()).abs().max())
                assert err <= GRAD_RTOL * float(g.abs().max()), (name, err)
        for got, ref in zip(out["routing"], single["routing"]):
            assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, ref))
