"""The port's one-device mixture of experts (``vtc_tpu_torch.parallel.expert``)
and the MoE adapter config against ``vtc_tpu.parallel.expert`` on the CPU.

* ``MoEMLP`` at k = 1 and 2: the output at 2e-5; the routing equal exactly
  (expert ids, queue positions and kept slots, against JAX's ``top_k`` and
  its fp32 cumsum of one-hots), ties to the lower index as ``jax.lax.top_k``;
  the load-balance loss within 1e-6; identical experts reproduce the dense
  MLP; tokens over capacity are dropped (zero output), as in JAX.
* The MoE CAM's zero-init gives the exact average; the carrier's names.
* ``configs/pretrained_clip_comments_attn_moe.jsonc`` at test-tiny: the
  plain train step and the k = 2 accumulating step against
  ``make_step_fns`` (and ``make_step_fns(accum_steps=2)``: capacity follows
  the microbatch's token count, so the two steps drop different tokens),
  with SGD at lr 1 so that the update is the gradient: the loss (the
  weighted load-balance losses in it) and every trainable parameter's
  gradient.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.models.retrieval import PretrainedCLIP_finaltf as JaxFlagship
from vtc_tpu.ops import losses as jax_losses
from vtc_tpu.parallel import expert as jax_expert
from vtc_tpu_torch.data import extract_patches, synthetic_tokens
from vtc_tpu_torch.models import create_model, state_dict_from_jax
from vtc_tpu_torch.models.layers import MLPBlock, l2_normalize
from vtc_tpu_torch.ops import losses
from vtc_tpu_torch.parallel.expert import MoEMLP, route
from vtc_tpu_torch.training import train_step
from vtc_tpu_torch.utils import jsonc

TINY = "test-tiny"
ATOL, RTOL = 2e-5, 1e-4
E = 32
CONFIG = (Path(__file__).resolve().parents[1] / "configs"
          / "pretrained_clip_comments_attn_moe.jsonc")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _jax_routing(x, router, k, cap):
    """``vtc_tpu.parallel.expert.MoEMLP``'s routing, line for line in jnp:
    (idx [T, k], queue position [T, k], keep [T, k])."""
    probs = jax.nn.softmax(jnp.einsum("td,dn->tn", x, router,
                                      preferred_element_type=jnp.float32), axis=-1)
    n_exp = router.shape[1]
    _, idx = jax.lax.top_k(probs, k)
    counts = jnp.zeros((n_exp,), jnp.float32)
    pos, keep = [], []
    for s in range(k):
        oh = jax.nn.one_hot(idx[:, s], n_exp, dtype=jnp.float32)
        p = jnp.cumsum(oh, axis=0) - 1.0 + counts
        counts = counts + jnp.sum(oh, axis=0)
        pos_t = jnp.sum(oh * p, axis=-1)
        pos.append(pos_t)
        keep.append(pos_t < cap)
    return (np.asarray(idx), np.asarray(jnp.stack(pos, 1)).astype(np.int64),
            np.asarray(jnp.stack(keep, 1)))


def _moe_pair(k, capacity_factor=1.25, n_exp=4, seed=0, shape=(6, 11)):
    """(x, JAX params, the JAX module, the port's MoEMLP with them)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (E,)).astype(np.float32)
    jm = jax_expert.MoEMLP(E, n_exp, router_top_k=k, capacity_factor=capacity_factor)
    params = _np_tree(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    # biases off zero, so that a dropped token (output 0) differs from a kept one
    params["bias_fc"] = rng.normal(0, 0.1, params["bias_fc"].shape).astype(np.float32)
    params["bias_proj"] = rng.normal(0, 0.1, params["bias_proj"].shape).astype(np.float32)
    port = MoEMLP(E, n_exp, k, capacity_factor)
    port.load_state_dict({n: torch.from_numpy(v) for n, v in params.items()}, strict=True)
    return x, params, jm, port


def _jax_moe(jm, params, x):
    y, state = jm.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    return np.asarray(y), float(state["losses"]["moe_aux"][0])


@pytest.mark.parametrize("k", [1, 2])
def test_moe_mlp_matches_jax(k):
    x, params, jm, port = _moe_pair(k)
    ref, aux = _jax_moe(jm, params, x)
    ours = port(torch.from_numpy(x))
    np.testing.assert_allclose(_np(ours), ref, atol=ATOL, rtol=RTOL)
    assert abs(float(port.aux_loss) - aux) <= 1e-6
    t = x.shape[0] * x.shape[1]
    cap = port.capacity(t)
    assert cap == math.ceil(1.25 * k * t / 4)
    xt = x.reshape(-1, E)
    idx_j, pos_j, keep_j = _jax_routing(jnp.asarray(xt), jnp.asarray(params["router"]), k, cap)
    probs = torch.softmax(torch.from_numpy(xt) @ torch.from_numpy(params["router"]), -1)
    idx, _, pos, keep = route(probs, k, cap)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_array_equal(pos.numpy(), pos_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)


def test_routing_ties_go_to_the_lower_index():
    """Equal probabilities: ``torch.topk`` promises no order, the stable
    sort gives ``jax.lax.top_k``'s (lower index first)."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                          [0.3, 0.2, 0.3, 0.2]])
    idx, gates, _, _ = route(probs, 2, 10)
    _, ref = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    torch.testing.assert_close(gates, torch.full((3, 2), 0.5))


def test_identical_experts_equal_the_dense_mlp():
    """Every expert a copy of one dense MLP and capacity for all: the gates
    sum to 1, so the MoE is the dense ``MLPBlock``."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 5, E)).astype(np.float32))
    dense = MLPBlock(E)
    moe = MoEMLP(E, 4, 2, capacity_factor=4.0)
    with torch.no_grad():
        for p in dense.parameters():
            p.normal_(0, 0.1)
        moe.router.normal_(0, 0.1)
        moe.w_fc.copy_(dense.c_fc.weight.T.expand(4, -1, -1))
        moe.bias_fc.copy_(dense.c_fc.bias.expand(4, -1))
        moe.w_proj.copy_(dense.c_proj.weight.T.expand(4, -1, -1))
        moe.bias_proj.copy_(dense.c_proj.bias.expand(4, -1))
    torch.testing.assert_close(moe(x), dense(x), atol=ATOL, rtol=RTOL)


def test_capacity_overflow_drops_tokens():
    """At capacity factor 0.5 some tokens find their expert full: their
    output is zero (a dropped slot of k = 2 leaves the other), as in JAX."""
    x, params, jm, port = _moe_pair(2, capacity_factor=0.5, seed=3)
    ref, aux = _jax_moe(jm, params, x)
    ours = _np(port(torch.from_numpy(x))).reshape(-1, E)
    np.testing.assert_allclose(ours, ref.reshape(-1, E), atol=ATOL, rtol=RTOL)
    xt = x.reshape(-1, E)
    probs = torch.softmax(torch.from_numpy(xt) @ torch.from_numpy(params["router"]), -1)
    _, _, _, keep = route(probs, 2, port.capacity(len(xt)))
    dropped = ~keep.any(1)
    assert dropped.any() and (keep.sum(1) == 1).any()
    assert not ours[dropped.numpy()].any()
    assert abs(float(port.aux_loss) - aux) <= 1e-6


def test_moe_validation():
    with pytest.raises(ValueError, match="router_top_k"):
        MoEMLP(E, 2, 3)


# ---- the MoE adapter ----------------------------------------------------------

def _cfg_args():
    args = dict(jsonc.read_json(CONFIG)["arch"]["args"], model_type=TINY)
    assert (args["moe_experts"], args["moe_top_k"]) == (4, 2)
    return args


def _inputs(batch=6, seed=0):
    rng = np.random.default_rng(seed)
    vis = extract_patches(rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8), 8)
    title = synthetic_tokens((batch,), 16, 14, rng)
    comments = synthetic_tokens((batch, 5), 16, 14, rng)
    comments[0, 4] = 0
    comments[0, 4, :2] = (49406, 49407)
    return vis, title, comments


@pytest.fixture(scope="module")
def jax_moe():
    """(module, variables) of the JAX factory's MoE config at test-tiny."""
    return jax_create_model("PretrainedCLIP_finaltf", seed=0, **_cfg_args())


def test_moe_cam_zero_init_is_the_average(jax_moe):
    """``create_model`` on the MoE config zeroes each expert's ``w_proj``
    and ``bias_proj`` and each ``out_proj``: the adapter is the identity
    and the residual the normalized mean of the stack; the JAX factory's
    model, carried across, gives the same features."""
    args = _cfg_args()
    model = create_model("PretrainedCLIP_finaltf", device="cpu", **args)
    for block in model.final_transformer.resblocks:
        assert not block.mlp_moe.w_proj.any() and not block.mlp_moe.bias_proj.any()
        assert block.mlp_moe.w_fc.any() and not hasattr(block, "mlp")
    rng = np.random.default_rng(2)
    main = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32))
    aux = torch.from_numpy(rng.normal(size=(5, 4, 32)).astype(np.float32))
    with torch.no_grad():
        ours = model.adapt(main, aux)
        stack = l2_normalize(torch.cat([main[None], aux]).transpose(0, 1))
        res = l2_normalize(l2_normalize(stack).mean(1))
        torch.testing.assert_close(ours, l2_normalize(l2_normalize(main) + res),
                                   atol=1e-6, rtol=1e-6)
    jm, variables = jax_moe
    port = create_model("PretrainedCLIP_finaltf", device="cpu", **args)
    port.load_state_dict(state_dict_from_jax(_np_tree(variables["params"])), strict=True)
    data = _inputs()
    ref = jax.jit(jm.apply)(variables, *[jnp.asarray(a) for a in data])
    with torch.no_grad():
        out = port(*map(torch.from_numpy, data))
    for o, r, atol in zip(out, ref, (ATOL, ATOL, 3e-4)):
        np.testing.assert_allclose(_np(o), np.asarray(r), atol=atol, rtol=RTOL)


def test_moe_state_dict_names(jax_moe):
    _, variables = jax_moe
    sd = state_dict_from_jax(_np_tree(variables["params"]))
    moe = {k for k in sd if ".mlp_moe." in k}
    assert moe == {f"final_transformer.resblocks.{i}.mlp_moe.{leaf}" for i in range(2)
                   for leaf in ("router", "w_fc", "bias_fc", "w_proj", "bias_proj")}
    blk = variables["params"]["cam"]["final_transformer"]["resblocks_0"]["mlp_moe"]
    np.testing.assert_array_equal(sd["final_transformer.resblocks.0.mlp_moe.w_fc"].numpy(),
                                  np.asarray(blk["w_fc"]))


@pytest.fixture(scope="module")
def moe_model(jax_moe):
    """(module kwargs, params) of the MoE config at test-tiny, its CAM moved
    off the zero-init (else the experts' first layers take no gradient)."""
    args = _cfg_args()
    params = _np_tree(jax_moe[1]["params"])
    rng = np.random.default_rng(0)
    params["cam"] = jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), params["cam"])
    return args, params


@pytest.mark.parametrize("accum", [1, 2])
def test_moe_train_step_matches_make_step_fns(moe_model, accum):
    """The plain step against ``make_step_fns``, the k = 2 accumulating step
    against ``make_step_fns(accum_steps=2)``: the loss with the aux term
    (weight 0.01, the config's) and the gradient of every parameter that
    trains (the CLIP towers are frozen: ``freeze: "all"``)."""
    import optax

    from vtc_tpu.training.trainer import TrainState, make_step_fns

    args, params = moe_model
    weight = jsonc.read_json(CONFIG)["moe_aux_loss_weight"]
    jm = JaxFlagship(**{k: v for k, v in args.items()})
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = optax.sgd(1.0)
    jax_step, jax_eval = make_step_fns(jm, jax_losses.clip_loss, tx, donate=False,
                                       aux_loss_weight=weight, accum_steps=accum)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams), batch_stats={})
    data = _inputs(seed=1)
    jdata = tuple(jnp.asarray(a) for a in data)
    title = jax_eval(state, jdata, {}, branch_override="skip")[1][1]
    new_state, loss_j, out_j = jax_step(state, jdata, {}, jax.random.PRNGKey(2))
    diff = np.abs(np.asarray(out_j[1]) - np.asarray(title)).max(-1)
    assert np.all((diff < 1e-4) | (diff > 1e-2))
    skip = torch.from_numpy((diff < 1e-4)[:, None])
    draws = ({"adapter_skip": skip} if accum == 1 else
             [{"adapter_skip": skip[i::accum]} for i in range(accum)])

    port = create_model("PretrainedCLIP_finaltf", device="cpu", **args)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    trainable = {n: p for n, p in port.named_parameters() if p.requires_grad}
    assert trainable and all(not n.startswith("model.") for n in trainable)
    optimizer = torch.optim.SGD(trainable.values(), lr=1.0)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: 1.0)
    before = {n: p.detach().clone() for n, p in trainable.items()}
    loss, _ = train_step(port, losses.clip_loss, optimizer, scheduler,
                         [torch.from_numpy(a) for a in data], {}, draws=draws,
                         accum_steps=accum, moe_aux_loss_weight=weight)
    np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-5, rtol=1e-5)
    grads_j = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), params,
                                     _np_tree(new_state.params))
    ref = state_dict_from_jax(grads_j)
    moved = 0
    for name, p in trainable.items():
        g = _np(before[name] - p.detach())
        scale = max(1.0, float(ref[name].abs().max()))
        np.testing.assert_allclose(g, _np(ref[name]), atol=ATOL * scale, rtol=RTOL,
                                   err_msg=name)
        moved += ".mlp_moe.router" in name and bool(np.abs(g).max() > 0)
    assert moved == 2  # the load-balance loss reaches both routers
