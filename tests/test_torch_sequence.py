"""The sequence axis of the port (``vtc_tpu_torch.parallel.sequence`` and
``parallel.stack``'s ``"seq"`` mode) on the CPU: one spawn of 4 ranks of a
gloo group from ``tests/torch_dist_ranks.py`` (torch on one thread), laid
out as ``create_sp_mesh(1, 4)``, then ``create_sp_mesh(2, 2)``, then two
groups of 2 as ``create_sp_mesh(1, 2)``, against ``vtc_tpu``'s sequential
``Transformer`` and ``jax.grad`` of it, ``vtc_tpu.parallel.sequence.
sp_transformer`` on ``create_sp_mesh(2, 2)`` of the 8-device CPU mesh, and
the port's one-process step, computed in the test process beside them.

* The stacks at test-tiny, fp32: the text tower's (causal, L = 16 and the
  77 of CLIP's context, padded), the ViT tower's (L = 17, padded) and the
  CAM's (L = 6, padded to 8 at sp 4), at sp 2 and 4: outputs within 2e-5 of
  ``vtc_tpu``'s sequential stack, the input's and the blocks' gradients
  (summed over the seq group) within 1e-5 of each one's largest
  ``jax.grad`` entry; each counted on the ring.
* ``pad_for_sp`` at L = 77 over 4 shards against ``vtc_tpu``'s.
* The flagship's train step at dp1×sp2 and dp2×sp2, and at dp2×sp2 under
  ZeRO-3 (``fully_shard_model`` over the data axis, as ``vtc_tpu``'s
  ``tree_shardings(..., fsdp=True)`` shards over ``data`` on its sp mesh),
  against the one-process step: losses within 2e-6,
  step-1 gradients within the data axis's reorder floor (3.06e-6 of each
  parameter's largest), every rank's parameters equal after; the three
  stacks of each forward on the ring.
* The video model's forward under ``"seq"``: the TimeSformer runs its
  sequential loop, the text tower and the CAM the ring.
* A MoE stack keeps its sequential loop.
* The train twin at ``--sp 2``: a single-card ``.pth`` that a whole model
  loads strictly, a resume that restores it.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from test_torch_pipeline import (
    HEADS,
    MOE,
    WIDTH,
    _cli_config,
    _inputs,
    _jax_blocks,
    _port_state,
    _state_dict,
)

ATOL = 2e-5  # the stacks' outputs against vtc_tpu's sequential stack
GRAD_RTOL_JAX = 1e-5  # the stacks' gradients against jax.grad, of each one's largest
REORDER_RTOL = 3.06e-6  # the data axis's reorder floor (tests/test_torch_dist.py)
LOSS_ATOL = 2e-6
TIMEOUT = 300
LAYERS = 2
NFRAMES = 4
# (name, sp degree): (L, causal, batch)
FORWARDS = {
    ("text", 2): (16, True, 4), ("text77", 2): (77, True, 2), ("vit", 2): (17, False, 4),
    ("cam", 2): (6, False, 4),
    ("text77", 4): (77, True, 2), ("vit", 4): (17, False, 4), ("cam", 4): (6, False, 4),
}


def _forward_specs():
    """Each stack forward's spec for ``R.stack_forward`` and its JAX
    params, by (name, sp degree)."""
    specs, params = {}, {}
    for seed, (key, (length, causal, batch)) in enumerate(FORWARDS.items()):
        rng = np.random.default_rng(200 + seed)
        params[key] = _jax_blocks("block", LAYERS, 300 + seed)
        specs[key] = {"kind": "transformer", "args": (WIDTH, LAYERS, HEADS), "kwargs": {},
                      "extra": causal, "state_dict": _port_state(params[key], LAYERS),
                      "x": rng.normal(size=(batch, length, WIDTH)).astype(np.float32),
                      "c": rng.normal(size=(batch, length, WIDTH)).astype(np.float32)}
    return specs, params


def _moe_spec():
    from vtc_tpu_torch.models.layers import Transformer

    stack = Transformer(WIDTH, LAYERS, HEADS, **MOE)
    with torch.no_grad():
        for p in stack.parameters():
            p.normal_(0, 0.1, generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(9)
    return {"kind": "transformer", "args": (WIDTH, LAYERS, HEADS), "kwargs": MOE,
            "extra": False, "state_dict": {n: v.clone() for n, v in stack.state_dict().items()},
            "x": rng.normal(size=(4, 6, WIDTH)).astype(np.float32),
            "c": rng.normal(size=(4, 6, WIDTH)).astype(np.float32)}


def _video_spec():
    """The test-tiny video model (4 frames), its CAM, ``temporal_fc`` and
    ``temporal_embed`` off their zero-init, on seeded inputs."""
    from vtc_tpu_torch.data import extract_patches, synthetic_tokens
    from vtc_tpu_torch.models import create_model

    sd = create_model("PretrainedCLIP_TimeSformer_finaltf", model_type=R.TINY, seed=3,
                      device="cpu", nframes=NFRAMES).state_dict()
    gen = torch.Generator().manual_seed(4)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
          if v.is_floating_point() and ("temporal" in k or not k.startswith("model."))
          else v for k, v in sd.items()}
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, (2, NFRAMES, 32, 32, 3), dtype=np.uint8)
    inputs = [extract_patches(u8, 8), synthetic_tokens((2,), 16, 14, rng),
              synthetic_tokens((2, 5), 16, 14, rng)]
    return {"state_dict": sd, "inputs": inputs, "nframes": NFRAMES}


def _step_cases():
    gen = torch.Generator().manual_seed(3)
    skip = [{"adapter_skip": torch.rand((8, 1), generator=gen) > 0.5} for _ in range(2)]
    step = dict(state_dict=_state_dict(), data=_inputs(), steps=2, draws=skip)
    return {"plain": step, "fsdp": dict(step, fsdp=True)}


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """The spawn of 4 ranks (``R.run_sp``), started before the JAX
    references compile beside it and the one-process references are made;
    returns (the forward specs, the JAX references, the one-process
    references, each rank's results)."""
    tmp = tmp_path_factory.mktemp("sp")
    specs, params = _forward_specs()
    cases, video, moe = _step_cases(), _video_spec(), _moe_spec()
    _cli_config(tmp)

    def forwards(sp):
        return {key: spec for key, spec in specs.items() if key[1] == sp}

    torch.save({"sp4": {"forwards": forwards(4)},
                "dp2xsp2": {"forwards": dict(forwards(2), moe=moe), "cases": cases,
                            "video": video},
                "dp1xsp2": {"cases": {"plain": cases["plain"]}},
                "cli": True}, tmp / "sp.pt")
    context = R.spawn(R.run_sp, 4, tmp, join=False)
    jax_refs = {key: _jax_sequential(params[key], spec) for key, spec in specs.items()}
    jax_refs["sp_transformer"] = _jax_sp_transformer(params["text77", 2], specs["text77", 2])
    refs = {"plain": R.step_case(cases["plain"])}
    refs["video"] = R.video_forward(video)
    refs["moe"] = R.stack_forward(moe)
    R.wait(context, timeout=TIMEOUT)
    ranks = [torch.load(tmp / f"sp_rank{r}.pt", weights_only=False) for r in range(4)]
    return specs, jax_refs, refs, ranks


def _jax_sequential(params, spec):
    """``vtc_tpu``'s sequential ``Transformer`` on ``spec``'s input: the
    output and ``jax.grad`` of ``sum(y · c)`` for the input and the
    blocks."""
    import jax
    import jax.numpy as jnp

    from vtc_tpu.models.layers import Transformer, causal_mask

    x = spec["x"]
    mask = causal_mask(x.shape[1]) if spec["extra"] else None
    stack = Transformer(WIDTH, LAYERS, HEADS)
    params = jax.tree_util.tree_map(jnp.asarray, params)

    def loss(p, h):
        y = stack.apply({"params": p}, h, mask)
        return jnp.sum(y * spec["c"]), y

    (_, y), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return {"y": np.asarray(y), "x_grad": np.asarray(g_x),
            "grads": _port_state(jax.tree_util.tree_map(np.asarray, g_params), LAYERS)}


def _jax_sp_transformer(params, spec):
    """``vtc_tpu.parallel.sequence.sp_transformer`` on ``create_sp_mesh(2,
    2)``, padded by its ``pad_for_sp``."""
    import jax
    import jax.numpy as jnp

    from vtc_tpu.models.layers import causal_mask, set_tp_qkv
    from vtc_tpu.parallel.pipeline import stack_layer_params
    from vtc_tpu.parallel.sequence import create_sp_mesh, pad_for_sp, sp_transformer

    mesh = create_sp_mesh(2, 2, devices=jax.devices()[:4])
    try:
        x, mask, length = pad_for_sp(jnp.asarray(spec["x"]), causal_mask(spec["x"].shape[1]),
                                     2)
        stacked = stack_layer_params(jax.tree_util.tree_map(jnp.asarray, params), LAYERS)
        out = jax.jit(lambda p, h, m: sp_transformer(p, h, m, mesh=mesh, heads=HEADS))(
            stacked, x, mask)
    finally:
        set_tp_qkv(False)
    return np.asarray(out[:, :length])


def _rel(ours, ref):
    ours, ref = (torch.as_tensor(np.array(t)) for t in (ours, ref))
    return float((ours - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


@pytest.mark.parametrize("key", list(FORWARDS), ids=[f"{n}-sp{s}" for n, s in FORWARDS])
def test_ring_stack_matches_jax_sequential_stack(sp_runs, key):
    """Every rank of every seq group returns the stack's output; the
    gradients, the blocks' summed over the seq group, are ``jax.grad``'s."""
    _, jax_refs, _, ranks = sp_runs
    ref = jax_refs[key]
    for out in ranks:
        res = out["sp4" if key[1] == 4 else "dp2xsp2"][key]
        assert res["counts"] == {"ring": 1}
        np.testing.assert_allclose(res["y"].numpy(), ref["y"], atol=ATOL, rtol=0)
        assert _rel(res["x_grad"], ref["x_grad"]) <= GRAD_RTOL_JAX
        assert sorted(res["grads"]) == sorted(ref["grads"])
        for name, g in ref["grads"].items():
            assert _rel(res["grads"][name], g) <= GRAD_RTOL_JAX, name


def test_ring_stack_matches_jax_sp_transformer(sp_runs):
    """The text stack at L = 77 on dp2×sp2 against ``vtc_tpu``'s ring on
    its own ``create_sp_mesh(2, 2)``."""
    _, jax_refs, _, ranks = sp_runs
    for out in ranks:
        np.testing.assert_allclose(out["dp2xsp2"]["text77", 2]["y"].numpy(),
                                   jax_refs["sp_transformer"], atol=ATOL, rtol=0)


def test_pad_for_sp_matches_jax_at_77_over_4():
    import jax.numpy as jnp

    from vtc_tpu.models.layers import causal_mask as jax_causal_mask
    from vtc_tpu.parallel.sequence import pad_for_sp as jax_pad
    from vtc_tpu_torch.ops.attention import causal_mask
    from vtc_tpu_torch.parallel.sequence import pad_for_sp

    x = np.random.default_rng(0).normal(size=(2, 77, 8)).astype(np.float32)
    for causal in (False, True):
        xp, mask, length = pad_for_sp(torch.from_numpy(x), causal_mask(77) if causal else None,
                                      4)
        jx, jmask, jlength = jax_pad(jnp.asarray(x), jax_causal_mask(77) if causal else None,
                                     4)
        assert length == jlength == 77 and tuple(xp.shape) == (2, 80, 8)
        np.testing.assert_array_equal(xp.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert mask.dtype == torch.float32
    same, mask, length = pad_for_sp(torch.from_numpy(x[:, :76]), None, 4)
    assert length == 76 and same.shape[1] == 76 and not mask.any()


@pytest.mark.parametrize("mesh, case", [("dp1xsp2", "plain"), ("dp2xsp2", "plain"),
                                        ("dp2xsp2", "fsdp")])
def test_sp_step_matches_one_rank(sp_runs, mesh, case):
    """The flagship's three stacks run on the ring in each forward of the
    2 steps, the step the one process's within the data axis's reorder
    floor."""
    _, _, refs, ranks = sp_runs
    single = refs["plain"]
    group = ranks[:2] if mesh == "dp1xsp2" else ranks
    for out in group:
        res = out[mesh][case]
        assert res["counts"] == {"ring": 3 * 2}
        np.testing.assert_allclose(res["losses"], single["losses"], atol=LOSS_ATOL, rtol=0)
        assert sorted(res["grads"]) == sorted(single["grads"])
        for name, g in single["grads"].items():
            assert (res["grads"][name] is None) == (g is None), name
            if g is not None:
                assert _rel(res["grads"][name], g) <= REORDER_RTOL, name
        for name, p in res["params"].items():  # every seq and data rank alike
            assert torch.equal(p, group[0][mesh][case]["params"][name]), name


def test_video_model_under_seq_runs_its_timesformer_sequentially(sp_runs):
    _, _, refs, ranks = sp_runs
    for out in ranks:
        video = out["dp2xsp2"]["video"]
        assert video["counts"] == {"ring": 2, "sequential": 1}
        for a, b in zip(video["feats"], refs["video"]["feats"]):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    assert refs["video"]["counts"] == {}


def test_moe_stack_keeps_its_sequential_loop(sp_runs):
    _, _, refs, ranks = sp_runs
    for out in ranks:
        res = out["dp2xsp2"]["moe"]
        assert res["counts"] == {"sequential": 1}
        assert torch.equal(res["y"], refs["moe"]["y"])
        assert torch.equal(res["x_grad"], refs["moe"]["x_grad"])


def test_twin_at_sp2_writes_single_card_checkpoints(sp_runs):
    from vtc_tpu_torch.training import load_checkpoint

    _, _, _, ranks = sp_runs
    outs = [out["cli"] for out in ranks[2:]]
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


def test_seq_mode_needs_a_seq_axis():
    from vtc_tpu_torch.parallel.mesh import check_axes
    from vtc_tpu_torch.parallel.stack import set_stack_parallel, stack_parallel_mode

    class Mesh:
        mesh_dim_names = ("data", "pipe")

    with pytest.raises(ValueError, match="needs a 'seq' mesh axis"):
        set_stack_parallel("seq", Mesh())
    with pytest.raises(ValueError, match="needs the mesh"):
        set_stack_parallel("seq", None)
    check_axes(1, sp=4)
    check_axes(1, sp=2, fsdp=True)
    with pytest.raises(ValueError, match="at most one non-data mesh axis"):
        check_axes(2, sp=2)
    assert stack_parallel_mode() is None
