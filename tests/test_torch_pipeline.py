"""The pipe axis of the port (``vtc_tpu_torch.parallel.pipeline`` and
``parallel.stack``) on the CPU: 4 ranks of a gloo group laid out as
``create_pipeline_mesh(2, 2)`` (two pipe groups of 2 stages), spawned from
``tests/torch_dist_ranks.py`` (torch on one thread), against
``vtc_tpu.parallel.pipeline.pipeline_blocks`` on ``create_pipeline_mesh(1,
2)`` of the 8-device CPU mesh, computed in the test process beside them,
and against the sequential stack.

* The stacks at test-tiny with ``n_micro`` 2: the text tower's (causal),
  the ViT tower's and the divided space-time TimeSformer's, within 2e-5 of
  ``vtc_tpu``'s pipeline and of the sequential stack, each counted as
  pipelined; the input's and the blocks' gradients (summed over the
  stages) those of the sequential stack.
* The ``n_micro`` clamp (``_pick_n_micro``) and a batch of 5 through the
  pipeline; a MoE stack and a stack of 3 layers on 2 stages run their
  sequential loop, counted as such.
* The flagship's train step at dp2×pp2, plain and at ``accum_steps`` 2, and
  the MoE config's (its CAM sequential): the one-rank step's losses within
  2e-6 and gradients within ``GRAD_RTOL`` of each parameter's largest,
  every rank's parameters equal after.
* The same plain and accumulating steps under ZeRO-3 (``--fsdp 1 --pp
  2``): the same limits against the one-rank step (``vtc_tpu``'s step
  gives the same loss with and without ``fsdp=True`` on its pipe mesh);
  each unit of a stage (its blocks and the root) reduce-scatters once a
  step, and each rank holds its data rank's rows of every parameter and
  moment, half of the bytes.
* The train twin at ``--n_devices 2 --pp 2``: a single-card ``.pth`` that a
  whole model loads strictly, a resume that restores it.
* ``--slices`` beside the pipe and sequence axes refused by name; ZeRO-3
  beside the pipe and expert axes no longer refused.
* On the card (``-m cuda``): the flagship's dp1×pp2 step over gloo against
  one rank.

JAX is imported inside the CPU tests only, so the card test collects on a
machine without it (``--noconftest``).
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from vtc_tpu_torch.data import extract_patches, synthetic_tokens

WIDTH, HEADS, LAYERS, NFRAMES, N_MICRO = 64, 4, 2, 4, 2
ATOL = 2e-5  # the stacks' outputs against vtc_tpu's and the sequential stack
GRAD_RTOL = 1e-5  # of each parameter's largest |gradient|
LOSS_ATOL = 2e-6
TIMEOUT = 300
MOE = {"moe_experts": 4, "moe_top_k": 2}
# (kind, layers, extra arg, x shape, constructor kwargs)
FORWARDS = {
    "text": ("transformer", LAYERS, True, (4, 16, WIDTH), {}),
    "vit": ("transformer", LAYERS, False, (4, 17, WIDTH), {}),
    "timesformer": ("timesformer", LAYERS, NFRAMES, (2, 1 + 16 * NFRAMES, WIDTH), {}),
    "batch5": ("transformer", LAYERS, True, (5, 16, WIDTH), {}),
    "moe_stack": ("transformer", LAYERS, False, (4, 5, WIDTH), MOE),
    "three_layers": ("transformer", 3, False, (4, 5, WIDTH), {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread in the test process, as in the spawned ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _block_shapes(kind):
    """The param shapes of ``vtc_tpu``'s block of ``kind`` (no init runs)."""
    import jax
    import jax.numpy as jnp

    from vtc_tpu.models.layers import ResidualAttentionBlock
    from vtc_tpu.models.timesformer import TimeSformerBlock

    if kind == "timesformer":
        block, x, args = TimeSformerBlock(WIDTH, HEADS), (1, 1 + 16 * NFRAMES, WIDTH), (NFRAMES,)
    else:
        block, x, args = ResidualAttentionBlock(WIDTH, HEADS), (1, 5, WIDTH), ()
    return jax.eval_shape(lambda: block.init(jax.random.PRNGKey(0), jnp.zeros(x), *args))


def _jax_blocks(kind, layers, seed):
    """Params of ``layers`` of ``vtc_tpu``'s blocks of ``kind`` as
    ``{"resblocks_i": ...}``: the shapes of their init, seeded normal values
    (a LayerNorm's scale about 1)."""
    import jax

    shapes = _block_shapes(kind)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        scale = str(getattr(path[-1], "key", "")) == "scale"
        return (float(scale) + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)

    return {f"resblocks_{i}": jax.tree_util.tree_map_with_path(draw, shapes["params"])
            for i in range(layers)}


def _port_state(params, layers):
    from vtc_tpu_torch.models.from_jax import _block, _Reader, _to_torch

    reader, sd = _Reader(params), {}
    for i in range(layers):
        _block(reader, f"resblocks_{i}", sd, f"resblocks.{i}")
    return _to_torch(sd)


def _forward_specs():
    """Each stack forward's spec for ``R.stack_forward``, with the JAX
    params of the pipelined ones."""
    from vtc_tpu_torch.models.layers import Transformer

    specs, jax_params = {}, {}
    for seed, (name, (kind, layers, extra, shape, kw)) in enumerate(FORWARDS.items()):
        rng = np.random.default_rng(100 + seed)
        if kw:  # the MoE stack: the port's init, moved off it
            stack = Transformer(WIDTH, layers, HEADS, **kw)
            with torch.no_grad():
                for p in stack.parameters():
                    p.normal_(0, 0.1, generator=torch.Generator().manual_seed(seed))
            state = {n: v.detach().clone() for n, v in stack.state_dict().items()}
        else:
            jax_params[name] = _jax_blocks(kind, layers, seed)
            state = _port_state(jax_params[name], layers)
        specs[name] = {"kind": kind, "args": (WIDTH, layers, HEADS), "kwargs": kw,
                       "extra": extra, "state_dict": state,
                       "x": rng.normal(size=shape).astype(np.float32),
                       "c": rng.normal(size=shape).astype(np.float32)}
    return specs, jax_params


def _inputs(batch=8, seed=2):
    rng = np.random.default_rng(seed)
    vis = extract_patches(rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8), 8)
    return [vis, synthetic_tokens((batch,), 16, 14, rng),
            synthetic_tokens((batch, 5), 16, 14, rng)]


def _state_dict(**kw):
    """The flagship at test-tiny, its CAM moved off the zero-init."""
    from vtc_tpu_torch.models import create_model

    sd = create_model("PretrainedCLIP_finaltf", model_type=R.TINY, device="cpu",
                      **kw).state_dict()
    gen = torch.Generator().manual_seed(1)
    return {k: v + 0.05 * torch.randn(v.shape, generator=gen)
            if not k.startswith("model.") and v.is_floating_point() else v
            for k, v in sd.items()}


def _step_cases():
    gen = torch.Generator().manual_seed(3)
    skip = [{"adapter_skip": torch.rand((8, 1), generator=gen) > 0.5} for _ in range(2)]
    step = dict(state_dict=_state_dict(), data=_inputs(), steps=2, batch_draws=skip,
                draws=skip)
    accum = dict(step, accum=2, draws=[[{"adapter_skip": d["adapter_skip"][i::2]}
                                        for i in range(2)] for d in skip])
    moe = dict(state_dict=_state_dict(freeze="all", **MOE), data=_inputs(seed=4), steps=1,
               model_kw=dict(freeze="all", **MOE))
    return {"plain": step, "accum": accum, "moe": moe, "fsdp": dict(step, fsdp=True),
            "fsdp_accum": dict(accum, fsdp=True)}


def _one_rank(case):
    """The one-rank reference of a step case (ZeRO-3's is the plain step's)."""
    return case.replace("fsdp_", "").replace("fsdp", "plain")


def _cli_config(tmp):
    from test_torch_dist import _write_corpus
    from test_torch_train_cli import _config

    csv, root = _write_corpus(tmp / "cli")
    cfg = _config(tmp / "saved", csv, root)
    cfg["trainer"].update(epochs=1, tensorboard=False)
    (tmp / "cli_config.json").write_text(json.dumps(cfg))


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """The spawn of 4 ranks (the stack forwards, the step cases, the twin at
    ``--pp 2``), started before ``vtc_tpu``'s pipelines compile beside it
    and the one-process references are made; returns (the forward specs,
    the step cases, the JAX outputs and the references, each rank's
    results)."""
    tmp = tmp_path_factory.mktemp("pp")
    specs, jax_params = _forward_specs()
    cases = _step_cases()
    _cli_config(tmp)
    torch.save({"n_micro": N_MICRO, "forwards": specs, "cases": cases, "cli": True},
               tmp / "pp.pt")
    context = R.spawn(R.run_pp, 4, tmp, join=False)
    refs = {name: _jax_pipeline(name, jax_params[name], specs[name]["x"])
            for name in ("text", "vit", "timesformer")}
    refs.update({("sequential", name): R.stack_forward(spec) for name, spec in specs.items()})
    refs.update({("single", name): R.step_case(case) for name, case in cases.items()
                 if _one_rank(name) == name})
    R.wait(context, timeout=TIMEOUT)
    ranks = [torch.load(tmp / f"pp_rank{r}.pt", weights_only=False) for r in range(4)]
    return specs, cases, refs, ranks


def _jax_pipeline(name, params, x):
    """``pipeline_blocks`` of ``vtc_tpu`` on ``create_pipeline_mesh(1, 2)``,
    ``n_micro`` 2."""
    import jax
    import jax.numpy as jnp

    from vtc_tpu.models.layers import causal_mask, set_tp_qkv
    from vtc_tpu.parallel.pipeline import (
        clip_block_apply,
        create_pipeline_mesh,
        pipeline_blocks,
        stack_layer_params,
        timesformer_block_apply,
    )

    mesh = create_pipeline_mesh(1, 2, devices=jax.devices()[:2])
    try:
        if name == "timesformer":
            apply = timesformer_block_apply(WIDTH, HEADS, NFRAMES)
        else:
            apply = clip_block_apply(WIDTH, HEADS, mask=causal_mask(x.shape[1])
                                     if name == "text" else None)
        stacked = stack_layer_params(jax.tree_util.tree_map(jnp.asarray, params), LAYERS)
        out = jax.jit(lambda p, h: pipeline_blocks(apply, p, h, mesh=mesh,
                                                   n_micro=N_MICRO))(stacked, jnp.asarray(x))
    finally:
        set_tp_qkv(False)
    return np.asarray(out)


def _close_grads(ours, ref):
    for n, g in ref.items():
        err = float((ours[n] - g).abs().max())
        assert err <= GRAD_RTOL * float(g.abs().max()), (n, err)


@pytest.mark.parametrize("name", ["text", "vit", "timesformer"])
def test_pipelined_stack_matches_jax_and_the_sequential_stack(pp_runs, name):
    _, _, jax_out, ranks = pp_runs
    seq = jax_out["sequential", name]
    np.testing.assert_allclose(seq["y"].numpy(), jax_out[name], atol=ATOL, rtol=1e-4)
    for out in ranks:  # every stage of both pipe groups returns the stack's output
        assert out[name]["counts"] == {"pipelined": 1}
        np.testing.assert_allclose(out[name]["y"].numpy(), jax_out[name], atol=ATOL,
                                   rtol=1e-4)
        torch.testing.assert_close(out[name]["y"], seq["y"], atol=ATOL, rtol=1e-4)
        torch.testing.assert_close(out[name]["x_grad"], seq["x_grad"], atol=1e-5, rtol=1e-5)
        _close_grads(out[name]["grads"], seq["grads"])


def test_n_micro_is_clamped_to_a_divisor_of_the_batch(pp_runs):
    from vtc_tpu_torch.parallel.stack import _pick_n_micro

    assert [_pick_n_micro(4, b) for b in (8, 6, 5, 3, 1)] == [4, 3, 1, 3, 1]
    assert _pick_n_micro(8, 5) == 5 and _pick_n_micro(2, 5) == 1
    _, _, refs, ranks = pp_runs
    seq = refs["sequential", "batch5"]
    for out in ranks:
        assert out["batch5"]["counts"] == {"pipelined": 1}
        torch.testing.assert_close(out["batch5"]["y"], seq["y"], atol=ATOL, rtol=1e-4)
        _close_grads(out["batch5"]["grads"], seq["grads"])


@pytest.mark.parametrize("name", ["moe_stack", "three_layers"])
def test_ineligible_stacks_run_sequentially(pp_runs, name):
    """A MoE stack and a stack of 3 layers on 2 stages run their loop on
    every rank, as ``vtc_tpu``'s do: counted sequential, the sequential
    numbers bit for bit."""
    _, _, refs, ranks = pp_runs
    seq = refs["sequential", name]
    for out in ranks:
        assert out[name]["counts"] == {"sequential": 1}
        assert torch.equal(out[name]["y"], seq["y"])
        assert torch.equal(out[name]["x_grad"], seq["x_grad"])


@pytest.mark.parametrize("case", ["plain", "accum", "moe", "fsdp", "fsdp_accum"])
def test_dp2_pp2_step_matches_one_rank(pp_runs, case):
    """The flagship's visual, text and CAM stacks run pipelined (3 a
    forward; 2 passes of 2 microbatches with ``accum_steps`` 2), under
    ZeRO-3 too; the MoE config's CAM runs sequentially beside its pipelined
    towers."""
    _, _, refs, ranks = pp_runs
    single = refs["single", _one_rank(case)]
    counts = {"plain": {"pipelined": 3 * 2}, "accum": {"pipelined": 3 * 2 * 2 * 2},
              "moe": {"pipelined": 2, "sequential": 1}}[_one_rank(case)]
    for out in ranks:
        res = out[case]
        assert res["counts"] == counts
        np.testing.assert_allclose(res["losses"], single["losses"], atol=LOSS_ATOL, rtol=0)
        assert sorted(res["grads"]) == sorted(single["grads"])
        for name, g in single["grads"].items():
            assert (res["grads"][name] is None) == (g is None), name
            if g is not None:
                err = float((res["grads"][name] - g).abs().max())
                assert err <= GRAD_RTOL * float(g.abs().max()), (name, err)
        for name, p in res["params"].items():  # every stage and data rank alike
            assert torch.equal(p, ranks[0][case]["params"][name]), name


@pytest.mark.parametrize("case", ["fsdp", "fsdp_accum"])
def test_zero3_stage_reduce_scatters_once_and_holds_half(pp_runs, case):
    """Under ZeRO-3 a stage's units (its block of each of the 3 stacks and
    the root) reduce-scatter once a step, the accumulating step's
    microbatches and the schedule's included; each rank holds its data
    rank's ⌈n/2⌉ (or the rest) dim-0 rows of every parameter, its Adam
    moments alike, and a pipe group's two stages the same rows."""
    _, _, _, ranks = pp_runs
    held = whole = 0
    for r, out in enumerate(ranks):
        res = out[case]
        assert res["reduce_scatters"] == [(4, 4)] * 2, (r, res["reduce_scatters"])
        d = r // 2  # rank d·2 + s of create_pipeline_mesh(2, 2)
        for n, full in res["params"].items():
            local = res["local_params"][n]
            if full.dim() == 0:  # logit_scale stays whole
                assert local.shape == full.shape, n
                continue
            rows = -(-full.shape[0] // 2)
            want = rows if d == 0 else full.shape[0] - rows
            assert torch.equal(local, full[d * rows:d * rows + want]), n
            assert torch.equal(local, ranks[r ^ 1][case]["local_params"][n]), n
            for k, shape in res["local_moments"].get(n, {}).items():
                assert shape == tuple(local.shape), (n, k)
            held += local.numel()
            whole += full.numel()
    assert 0.5 <= held / whole <= 0.5005


def test_twin_at_pp2_writes_single_card_checkpoints(pp_runs):
    from vtc_tpu_torch.training import load_checkpoint

    _, _, _, ranks = pp_runs
    outs = [out["cli"] for out in ranks]
    assert all(o["dirs"] == outs[0]["dirs"] and o["start"] == 2 for o in outs)
    ckpt = load_checkpoint(Path(outs[0]["dirs"][0]) / "checkpoint-epoch1.pth")
    model = R.flagship_port(ckpt["state_dict"], random_skip_adapter=False)  # strict
    for o in outs:
        state, opt = o["resumed"][0]
        for n, p in model.state_dict().items():
            assert torch.equal(state[n], p) and torch.equal(o["epochs"][0][n], p), n
        for n, p in o["local"].items():  # the whole model on every rank
            assert torch.equal(p, outs[0]["local"][n]), n
        assert opt["state"].keys() == ckpt["optimizer"]["state"].keys()


def test_sp_slices_and_seq_are_refused_by_name(pp_runs):
    """What stays refused beside the pipe and sequence axes: ``--slices``
    beside pp/sp/ep (as ``vtc_tpu``'s ``train.py``), the ``"seq"`` mode
    without its mesh axis. ZeRO-3 beside the pipe and expert axes passes
    the check, as ``vtc_tpu``'s ``tree_shardings`` composes them, and the
    dp2×pp2 groups built and stepped under it."""
    from vtc_tpu_torch.parallel.mesh import check_axes
    from vtc_tpu_torch.parallel.stack import set_stack_parallel, stack_parallel_mode

    for kw in ({"sp": 2}, {"pp": 2}, {"sp": 4}):
        with pytest.raises(ValueError, match="composes with dp/tp/fsdp"):
            check_axes(1, slices=2, **kw)
    with pytest.raises(ValueError, match="needs the mesh"):
        set_stack_parallel("seq", None)
    with pytest.raises(ValueError, match="at most one non-data mesh axis"):
        check_axes(2, pp=2)
    check_axes(1, pp=2, fsdp=True)
    check_axes(1, ep=2, fsdp=True)
    for out in pp_runs[3]:
        for case in ("fsdp", "fsdp_accum"):
            assert len(out[case]["losses"]) == 2 and np.isfinite(out[case]["losses"]).all()
    check_axes(1, pp=2)
    check_axes(1, sp=2, fsdp=True)
    check_axes(2, slices=2, fsdp=True)
    assert stack_parallel_mode() is None


@pytest.mark.cuda
def test_pp2_step_on_the_card_over_gloo(tmp_path):
    """dp1×pp2 over gloo with both ranks on the card: the flagship's step of
    one rank on the card, losses within 2e-6, gradients within
    ``GRAD_RTOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ranks run their kernels there")
    case = dict(_step_cases()["plain"], device="cuda")
    torch.save({"n_micro": N_MICRO, "forwards": {}, "cases": {"plain": case},
                "device": "cuda"}, tmp_path / "pp.pt")
    R.wait(R.spawn(R.run_pp, 2, tmp_path, join=False), timeout=TIMEOUT)
    single = R.step_case(case)
    for r in range(2):
        out = torch.load(tmp_path / f"pp_rank{r}.pt", weights_only=False,
                         map_location="cpu")["plain"]
        assert out["counts"] == {"pipelined": 3 * 2}
        np.testing.assert_allclose(out["losses"], single["losses"], atol=LOSS_ATOL, rtol=0)
        for name, g in single["grads"].items():
            if g is not None:
                err = float((out["grads"][name].cpu() - g.cpu()).abs().max())
                assert err <= GRAD_RTOL * float(g.abs().max()), (name, err)
