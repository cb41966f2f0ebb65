"""The port's training path (vtc_tpu_torch) against the JAX package's, on the
same weights and inputs, on the CPU.

* Each model kernel's backward (``layernorm``, ``add_layernorm``,
  ``fused_mha``, ``fused_attention``) against ``jax.vjp`` of the JAX
  function, its Pallas forward run in interpret mode as the JAX package's
  own kernel tests run it, at atol 2e-5 in fp32 (bf16: two bf16 ulps at the
  gradient's largest magnitude, as the forward tests allow attention); and
  against autograd of the port's plain version, and by
  ``torch.autograd.gradcheck`` in fp64.
* The losses, the flagship's ``clip_loss`` gradients of every parameter,
  the CAM's training paths (BatchNorm running stats, comment masking,
  adapter skip, ``finaltf_frozen``) and three train steps against
  ``make_step_fns``. ``torch.Generator`` cannot reproduce ``jax.random``, so
  the port is fed JAX's draws: the comment mask through
  ``random_mask_comments`` applied on JAX's rng stream, the adapter skip
  read from JAX's own output (a skipped row of ``feats_text`` equals the
  normalized title feature).
* Token truncation against ``vtc_tpu.data.tokenizer``.

fp32 gradients of the whole model are held at atol 2e-5 with rtol 1e-4, as
the forward (tests/test_torch_models.py). After optimizer steps, Adam's
update ``m/√v`` is ±1 for any gradient, however small, so a parameter whose
gradient sits at rounding level may move by ``lr`` either way between two
correct runs: the step test holds the losses tightly and the parameters
within ``lr`` per step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.models.cam import ContextAdapter as JaxContextAdapter
from vtc_tpu.models.retrieval import PretrainedCLIP_finaltf as JaxFlagship
from vtc_tpu.ops import losses as jax_losses
from vtc_tpu_torch import ops
from vtc_tpu_torch.data import extract_patches, synthetic_tokens
from vtc_tpu_torch.models import state_dict_from_jax
from vtc_tpu_torch.models.cam import ContextAdapter
from vtc_tpu_torch.models.retrieval import PretrainedCLIP_finaltf
from vtc_tpu_torch.ops import losses
from vtc_tpu_torch.ops.addln import AddLayerNormFn
from vtc_tpu_torch.ops.attention import FusedAttentionFn, FusedMhaFn
from vtc_tpu_torch.ops.layernorm import LayerNormFn
from vtc_tpu_torch.training import build_optimizer, train_step

TINY = "test-tiny"
DIM = 32
ATOL, RTOL = 2e-5, 1e-4
SIM_ATOL = 3e-4  # exp(logit_scale) ≈ 14.3 times ATOL, as the forward tests
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _close(ours, ref, dtype_name="fp32", atol=ATOL, rtol=0.0, ulps=2):
    ours, ref = _np(ours), _np(ref)
    if dtype_name == "bf16":
        atol = ulps * 2.0**-7 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=rtol)


def _both(x, dtype_name, requires_grad=True):
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    t = torch.from_numpy(x).to(DTYPES[dtype_name]).requires_grad_(requires_grad)
    return t, jnp.asarray(x, jdt)


# ---- each kernel's backward -------------------------------------------------

def _ln_inputs(d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 8, d)) * 2 + 0.5).astype(np.float32)
    return (x, rng.normal(1.0, 0.2, d).astype(np.float32),
            rng.normal(0.0, 0.2, d).astype(np.float32),
            rng.normal(size=(2, 8, d)).astype(np.float32))


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [256, 768])
def test_layernorm_backward_matches_jax_vjp(monkeypatch, d, dtype_name):
    from vtc_tpu.ops import pallas_layernorm

    monkeypatch.setattr(pallas_layernorm, "_INTERPRET", True)
    x, scale, bias, g = _ln_inputs(d, d)
    (xt, xj), (gt, gj) = _both(x, dtype_name), _both(g, dtype_name, False)
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    _, vjp = jax.vjp(pallas_layernorm.layernorm, xj, jnp.asarray(scale),
                     jnp.asarray(bias))
    y = ops.layernorm(xt, st, bt)
    assert isinstance(y.grad_fn, LayerNormFn._backward_cls)
    ours = torch.autograd.grad(y, (xt, st, bt), gt)
    assert [o.dtype for o in ours] == [xt.dtype, torch.float32, torch.float32]
    for o, r in zip(ours, vjp(gj)):
        _close(o, r, dtype_name if o.dtype == torch.bfloat16 else "fp32",
               rtol=RTOL)


@pytest.mark.parametrize("used", ["both", "s", "y"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_add_layernorm_backward_matches_jax_vjp(monkeypatch, dtype_name, used):
    """Both outputs' cotangents, or only one's: the other is absent (None)
    on the port's side and zero on JAX's."""
    from vtc_tpu.ops import pallas_addln

    monkeypatch.setattr(pallas_addln, "_INTERPRET", True)
    a, scale, bias, gs = _ln_inputs(512, 1)
    b, _, _, gy = _ln_inputs(512, 2)
    (at, aj), (bt, bj) = _both(a, dtype_name), _both(b, dtype_name)
    (gst, gsj), (gyt, gyj) = _both(gs, dtype_name, False), _both(gy, dtype_name, False)
    st, bit = (torch.from_numpy(p).requires_grad_() for p in (scale, bias))
    _, vjp = jax.vjp(pallas_addln.add_layernorm, aj, bj, jnp.asarray(scale),
                     jnp.asarray(bias))
    s, y = ops.add_layernorm(at, bt, st, bit)
    outs, cots = {"both": ((s, y), (gst, gyt)), "s": ((s,), (gst,)),
                  "y": ((y,), (gyt,))}[used]
    ours = torch.autograd.grad(outs, (at, bt, st, bit), cots, allow_unused=True)
    ref = vjp((gsj if used != "y" else jnp.zeros_like(gsj),
               gyj if used != "s" else jnp.zeros_like(gyj)))
    for o, r in zip(ours, ref):
        if o is None:  # the LN parameters when only s is used
            assert used == "s" and not np.any(_np(r))
            continue
        _close(o, r, dtype_name if o.dtype == torch.bfloat16 else "fp32",
               rtol=RTOL)


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [7, 16])
def test_fused_mha_backward_matches_jax_vjp(l, causal, dtype_name):
    """The port's q, k, v are the column views of one qkv tensor (row stride
    3E), as the model hands them over; the gradient lands in that tensor."""
    from vtc_tpu.ops.pallas_attention import fused_mha as jax_fused_mha

    e, h, b = 128, 2, 3
    rng = np.random.default_rng(l)
    qkv = rng.normal(size=(b, l, 3 * e)).astype(np.float32)
    g = rng.normal(size=(b, l, e)).astype(np.float32)
    qkv_t, _ = _both(qkv, dtype_name)
    gt, gj = _both(g, dtype_name, False)
    qj, kj, vj = (jnp.asarray(x, gj.dtype) for x in np.split(qkv, 3, -1))
    _, vjp = jax.vjp(lambda q, k, v: jax_fused_mha(q, k, v, h, causal, None, 2, True),
                     qj, kj, vj)
    out = ops.fused_mha(*qkv_t.chunk(3, -1), h, causal)
    assert isinstance(out.grad_fn, FusedMhaFn._backward_cls)
    (grad,) = torch.autograd.grad(out, qkv_t, gt)
    for o, r in zip(grad.chunk(3, -1), vjp(gj)):
        _close(o, r, dtype_name, rtol=RTOL)


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "additive"])
def test_fused_attention_backward_matches_jax_vjp(mask_kind, dtype_name):
    """The port's q, k, v are ``[B, H, L, D]`` head views of one qkv tensor
    (the TimeSformer's temporal attention); JAX's the contiguous
    ``[B·H, L, D]`` copies. The mask gets no gradient."""
    from vtc_tpu.ops.pallas_attention import fused_attention as jax_fused_attention

    b, h, l, d = 3, 2, 8, 16
    rng = np.random.default_rng(11)
    qkv = rng.normal(size=(b, l, 3 * h * d)).astype(np.float32)
    g = rng.normal(size=(b, h, l, d)).astype(np.float32)
    mask = {"none": None, "causal": _np(ops.causal_mask(l)),
            "additive": np.where(rng.uniform(size=(l, l)) < 0.3, -np.inf,
                                 rng.normal(size=(l, l))).astype(np.float32)}[mask_kind]
    if mask is not None:
        np.fill_diagonal(mask, 0.0)
    qkv_t, _ = _both(qkv, dtype_name)
    gt, gj = _both(g, dtype_name, False)
    heads = [x.reshape(b, l, h, d).transpose(0, 2, 1, 3).reshape(b * h, l, d)
             for x in np.split(qkv, 3, -1)]
    mask_j = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_fused_attention(q, k, v, mask_j, None, 8, True),
        *(jnp.asarray(x, gj.dtype) for x in heads),
    )
    q, k, v = (t.unflatten(-1, (h, d)).transpose(1, 2) for t in qkv_t.chunk(3, -1))
    assert q.stride(2) == 3 * h * d
    out = ops.fused_attention(q, k, v, None if mask is None else torch.from_numpy(mask))
    assert isinstance(out.grad_fn, FusedAttentionFn._backward_cls)
    (grad,) = torch.autograd.grad(out, qkv_t, gt)
    ref = vjp(gj.reshape(b * h, l, d))
    for o, r in zip(grad.chunk(3, -1), ref):
        o = o.unflatten(-1, (h, d)).transpose(1, 2).reshape(b * h, l, d)
        _close(o, r, dtype_name, rtol=RTOL)


def _kernel_cases(dtype):
    """(name, fn, inputs) of each model kernel at a small shape."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(dtype).requires_grad_()

    w = torch.randn(16, generator=g, dtype=torch.float64 if dtype == torch.float64
                    else torch.float32).requires_grad_()
    bias = (0.1 * torch.randn(16, generator=g)).to(w.dtype).requires_grad_()
    mask = torch.randn(7, 7, generator=g).masked_fill(
        torch.ones(7, 7, dtype=torch.bool).triu(2), float("-inf")).to(w.dtype)
    return {
        "layernorm": (lambda x, w_, b_: ops.layernorm(x, w_, b_),
                      lambda x, w_, b_: ops.layernorm_plain(x, w_, b_),
                      (rand(3, 5, 16), w, bias)),
        "add_layernorm": (lambda a, b_, w_, bi: ops.add_layernorm(a, b_, w_, bi),
                          lambda a, b_, w_, bi: ops.add_layernorm_plain(a, b_, w_, bi),
                          (rand(3, 5, 16), rand(3, 5, 16), w, bias)),
        "fused_mha": (lambda t: ops.fused_mha(*t.chunk(3, -1), 4, True),
                      lambda t: ops.fused_mha_plain(*t.chunk(3, -1), 4, True, 0.5),
                      (rand(2, 7, 48),)),
        "fused_attention": (
            lambda q, k, v: ops.fused_attention(q, k, v, mask),
            lambda q, k, v: ops.fused_attention_plain(q, k, v, mask),
            (rand(2, 3, 7, 8), rand(2, 3, 7, 8), rand(2, 3, 7, 8))),
    }


@pytest.mark.parametrize("kernel", ["layernorm", "add_layernorm", "fused_mha",
                                    "fused_attention"])
def test_kernel_backward_gradcheck_fp64(kernel):
    """In fp64 the plain forward and the backward compute in fp64 and no
    rounding to q's dtype happens, so finite differences hold the backward."""
    fn, _, inputs = _kernel_cases(torch.float64)[kernel]
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("kernel", ["layernorm", "add_layernorm", "fused_mha",
                                    "fused_attention"])
def test_kernel_backward_matches_autograd_of_plain(kernel, dtype_name):
    """The backward is its own function: held against autograd through the
    plain version, with the same cotangents."""
    fn, plain, inputs = _kernel_cases(DTYPES[dtype_name])[kernel]
    outs, refs = fn(*inputs), plain(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i)).to(o.dtype)
            for i, o in enumerate(outs)]
    ours = torch.autograd.grad(outs, inputs, cots)
    ref = torch.autograd.grad(refs, inputs, cots)
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        _close(o, r, dtype_name if o.dtype == torch.bfloat16 else "fp32", ulps=1)


def test_inference_stays_off_the_tape():
    """Without a gradient wanted the wrappers call the launch directly; with
    one they record their Function (on the CPU too, so the CPU runs the
    backward the card runs)."""
    fn, _, inputs = _kernel_cases(torch.float32)["layernorm"]
    with torch.no_grad():
        assert fn(*inputs).grad_fn is None
    assert fn(*[x.detach() for x in inputs]).grad_fn is None
    assert isinstance(fn(*inputs).grad_fn, LayerNormFn._backward_cls)
    a, b_, w, bias = _kernel_cases(torch.float32)["add_layernorm"][2]
    assert isinstance(ops.add_layernorm(a, b_, w, bias)[0].grad_fn,
                      AddLayerNormFn._backward_cls)


# ---- losses -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["clip_loss", "cross_entropy",
                                  "binary_cross_entropy", "mse_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(3)
    n = 6
    sim = (rng.normal(size=(n, n)) * 5).astype(np.float32)
    feats = rng.normal(size=(n, 4)).astype(np.float32)
    target = {"clip_loss": None,
              "cross_entropy": rng.integers(0, n, n),
              "binary_cross_entropy": rng.integers(0, 2, (n, n)).astype(np.float32),
              "mse_loss": rng.normal(size=(n, 4)).astype(np.float32)}[name]
    meta = None if target is None else {"target": target}
    sim_t = torch.from_numpy(sim).requires_grad_()
    out_t = (torch.from_numpy(feats), torch.from_numpy(feats), sim_t)
    out_j = (jnp.asarray(feats), jnp.asarray(feats), jnp.asarray(sim))
    if name == "mse_loss":
        out_t = (sim_t[:, :4],)
        out_j = (jnp.asarray(sim[:, :4]),)
    ours = losses.LOSSES[name](out_t, meta)
    ref = jax_losses.LOSSES[name](out_j, None if meta is None else
                                  {"target": jnp.asarray(target)})
    _close(ours, ref, atol=1e-6, rtol=1e-6)
    (g,) = torch.autograd.grad(ours, sim_t)
    if name == "mse_loss":
        ref_g = jax.grad(lambda s: jax_losses.mse_loss((s[:, :4],), meta))(jnp.asarray(sim))
    else:
        ref_g = jax.grad(lambda s: jax_losses.LOSSES[name]((None, None, s), meta))(
            jnp.asarray(sim))
    _close(g, ref_g, atol=1e-6, rtol=1e-5)


# ---- the flagship and its CAM -----------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    """(module kwargs, params) of the test-tiny flagship as
    configs/pretrained_clip_comments_attention.jsonc builds it, with the CAM
    moved off its zero-init so its gradients are not trivially zero."""
    _, variables = jax_create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=0)
    params = _np_tree(variables["params"])
    rng = np.random.default_rng(0)
    params["cam"] = jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), params["cam"])
    return params


def _inputs(batch=6, seed=0):
    """bench.py's recipe at test-tiny: uint8 patches, 16-token title and 5
    comments, one comment empty."""
    rng = np.random.default_rng(seed)
    vis = extract_patches(rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8), 8)
    title = synthetic_tokens((batch,), 16, 14, rng)
    comments = synthetic_tokens((batch, 5), 16, 14, rng)
    comments[0, 4] = 0
    comments[0, 4, :2] = (49406, 49407)
    return vis, title, comments


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rngs(seed):
    rng = jax.random.PRNGKey(seed)
    return {"adapter_skip": jax.random.fold_in(rng, 1),
            "comment_mask": jax.random.fold_in(rng, 2),
            "dropout": jax.random.fold_in(rng, 3)}


def _skipped_rows(feats_text_train, feats_title):
    """JAX's adapter-skip draw, read from its output: a skipped row is the
    normalized title feature itself (the residual is a unit vector, so an
    adapted row is far from it)."""
    diff = np.abs(np.asarray(feats_text_train) - np.asarray(feats_title)).max(-1)
    skip = diff < 1e-4
    assert np.all((diff < 1e-4) | (diff > 1e-2)), diff
    return torch.from_numpy(skip[:, None])


def _port(params, batch_stats=None, **kwargs):
    model = PretrainedCLIP_finaltf(model_type=TINY, **kwargs)
    model.load_state_dict(state_dict_from_jax(params, batch_stats), strict=True)
    return model


@pytest.mark.parametrize("skip_adapter", [False, True])
def test_flagship_clip_loss_gradients_match_jax(flagship, skip_adapter):
    """Every parameter's gradient of ``clip_loss`` in training mode against
    ``jax.grad``, mapped onto the port's names by ``state_dict_from_jax``."""
    module = JaxFlagship(model_type=TINY, random_skip_adapter=skip_adapter)
    data = [jnp.asarray(a) for a in _inputs()]
    rngs = _rngs(7)

    def loss_fn(p):
        out = module.apply({"params": p}, *data, train=True, rngs=rngs)
        return jax_losses.clip_loss(out), out

    (loss_j, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(_j(flagship))
    draws = {}
    if skip_adapter:
        title_j = module.apply({"params": _j(flagship)}, *data, branch_override="skip")[1]
        draws["adapter_skip"] = _skipped_rows(out_j[1], title_j)
        assert 0 < int(draws["adapter_skip"].sum()) < 6  # both kinds of row
    port = _port(flagship, random_skip_adapter=skip_adapter).train()
    out = port(*[torch.from_numpy(a) for a in _inputs()], draws=draws)
    loss = losses.clip_loss(out)
    loss.backward()
    _close(loss, loss_j, atol=1e-5)
    ref = state_dict_from_jax(_np_tree(grads_j))
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(ref)
    for name, p in named.items():
        ours = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(1.0, float(ref[name].abs().max()))
        np.testing.assert_allclose(_np(ours), _np(ref[name]), atol=ATOL * scale,
                                   rtol=RTOL, err_msg=name)
    # the adapter's own weights take part
    assert port.final_transformer.resblocks[0].attn.in_proj_weight.grad.abs().max() > 0


@pytest.mark.parametrize("act", ["sub_mean", "bn"])
def test_cam_batch_stats_in_training_match_jax(flagship, act):
    """``sub_mean``/``bn`` in training: the output from the batch's
    statistics and the running stats after one forward, against JAX's
    ``batch_stats``."""
    rng = np.random.default_rng(4)
    main = rng.normal(size=(5, DIM)).astype(np.float32)
    aux = rng.normal(size=(3, 5, DIM)).astype(np.float32)
    stats = {"mean": rng.normal(0, 0.1, DIM).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, DIM).astype(np.float32)}
    jam = JaxContextAdapter(feature_dim=DIM, residual_activation=act,
                            random_skip_adapter=False)
    ref, new_vars = jam.apply(
        {"params": flagship["cam"], "batch_stats": stats}, jnp.asarray(main),
        jnp.asarray(aux), True, method="adapt", mutable=["batch_stats"])
    cam = ContextAdapter(feature_dim=DIM, residual_activation=act,
                         random_skip_adapter=False)
    sd = {k: v for k, v in state_dict_from_jax(flagship, {"cam": stats}).items()
          if not k.startswith("model.")}
    cam.load_state_dict(sd, strict=True)
    ours = cam.train().adapt(torch.from_numpy(main), torch.from_numpy(aux))
    _close(ours, ref)
    _close(cam.mean_center_bn.running_mean, new_vars["batch_stats"]["mean"], atol=1e-6)
    _close(cam.mean_center_bn.running_var, new_vars["batch_stats"]["var"], atol=1e-6)
    with pytest.raises(ValueError, match="batch >= 2"):
        cam.adapt(torch.from_numpy(main[:1]), torch.from_numpy(aux[:, :1]))


def test_finaltf_frozen_reads_the_running_stats(flagship):
    """With ``freeze`` naming the adapter, training reads the running stats
    and leaves them as they were, as JAX's ``finaltf_frozen``."""
    stats = {"cam": {"mean": np.full(DIM, 0.1, np.float32),
                     "var": np.full(DIM, 2.0, np.float32)}}
    data = _inputs(seed=2)
    module = JaxFlagship(model_type=TINY, residual_activation="bn",
                         freeze="finaltf", random_skip_adapter=False)
    ref, _ = module.apply(_j({"params": flagship, "batch_stats": stats}),
                          *[jnp.asarray(a) for a in data], train=True,
                          mutable=["batch_stats"])
    port = _port(flagship, stats, residual_activation="bn", freeze="finaltf",
                 random_skip_adapter=False).train()
    assert port.finaltf_frozen
    ours = port(*[torch.from_numpy(a) for a in data])
    for o, r, atol in zip(ours, ref, (ATOL, ATOL, SIM_ATOL)):
        _close(o, r, atol=atol, rtol=RTOL)
    _close(port.mean_center_bn.running_var, stats["cam"]["var"], atol=0)


def test_random_mask_comments_matches_jax(flagship):
    """JAX's draw on its ``comment_mask`` stream, read from its output (a
    kept comment is unchanged, a masked one is the mask embedding), fed to
    the port gives JAX's output; and a generator's draw is 0/1 per
    (comment, sample)."""
    feats = np.random.default_rng(5).normal(size=(5, 4, DIM)).astype(np.float32)
    module = JaxFlagship(model_type=TINY, random_comment_masking=True)
    ref = np.asarray(module.apply(
        {"params": _j(flagship)}, jnp.asarray(feats), rngs=_rngs(3),
        method=lambda m, f: m.cam.random_mask_comments(f)))
    keep = np.all(ref == feats, -1, keepdims=True)
    assert keep.any() and not keep.all()
    port = _port(flagship, random_comment_masking=True)
    ours = port.random_mask_comments(torch.from_numpy(feats), torch.from_numpy(keep))
    _close(ours, ref, atol=0)
    drawn = port.random_mask_comments(torch.from_numpy(feats),
                                      generator=torch.Generator().manual_seed(0))
    kept = (drawn == torch.from_numpy(feats)).all(-1)
    masked = (drawn == port.mask_embedding[0]).all(-1)
    assert bool((kept ^ masked).all())


def test_flagship_training_forward_with_masking_and_skip_matches_jax(flagship):
    """The whole training forward with both random paths on: JAX's comment
    mask taken on its own rng stream, its adapter skip read from its
    output, and ``branch_to_adapt`` (image) in training where the eval
    branch is text."""
    data = [jnp.asarray(a) for a in _inputs(seed=4)]
    kw = dict(random_comment_masking=True, branch_to_adapt="image")
    module = JaxFlagship(model_type=TINY, **kw)
    rngs = _rngs(9)
    variables = {"params": _j(flagship)}
    ref = module.apply(variables, *data, train=True, rngs=rngs)
    feats = np.zeros((5, 6, DIM), np.float32) + 3.0
    keep = np.all(np.asarray(module.apply(
        variables, jnp.asarray(feats), rngs=rngs,
        method=lambda m, f: m.cam.random_mask_comments(f))) == feats, -1, keepdims=True)
    vis_j = module.apply(variables, *data, branch_override="skip")[0]
    skip = _skipped_rows(ref[0], vis_j)
    port = _port(flagship, **kw).train()
    ours = port(*[torch.from_numpy(np.asarray(a)) for a in data],
                draws={"comment_mask": torch.from_numpy(keep), "adapter_skip": skip})
    for o, r, atol in zip(ours, ref, (ATOL, ATOL, SIM_ATOL)):
        _close(o, r, atol=atol, rtol=RTOL)


def test_shared_comment_broadcast_is_refused_in_training(flagship):
    vis, title, comments = (torch.from_numpy(a) for a in _inputs())
    port = _port(flagship)
    with torch.no_grad():
        port.eval()(vis, title, comments[:1])  # eval: shared by every row
        with pytest.raises(ValueError, match="eval-only"):
            port.train()(vis, title, comments[:1])


# ---- train steps against make_step_fns --------------------------------------

OPT = {"type": "Adam", "args": {"lr": 1e-3, "weight_decay": 1e-4, "amsgrad": True}}
SCHED = {"type": "StepLR", "args": {"step_size": 1, "gamma": 0.5}}
STEP_KW = dict(steps_per_epoch=2, adapter_lr=1e-2, fc_lr=2e-3)


def test_three_train_steps_match_jax(flagship):
    """``train_step`` against ``make_step_fns``' jitted train step with the
    fused 4-group Adam (amsgrad, L2 decay, StepLR): the loss of each step,
    then every parameter within the Adam bound of ``lr`` per step, and most
    of them far closer."""
    from vtc_tpu.training.optim import build_optimizer as jax_build_optimizer
    from vtc_tpu.training.trainer import TrainState, make_step_fns

    module = JaxFlagship(model_type=TINY)
    params = _j(flagship)
    tx = jax_build_optimizer(params, OPT, SCHED, **STEP_KW)
    jax_step, jax_eval = make_step_fns(module, jax_losses.clip_loss, tx, donate=False)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), batch_stats={})
    port = _port(flagship)
    optimizer, scheduler = build_optimizer(port, OPT, SCHED, **STEP_KW)
    data_np = _inputs(seed=1)
    data_j = tuple(jnp.asarray(a) for a in data_np)
    data_t = [torch.from_numpy(a) for a in data_np]
    for step in range(3):
        title_j = jax_eval(state, data_j, {}, branch_override="skip")[1][1]
        state, loss_j, out_j = jax_step(state, data_j, {}, jax.random.PRNGKey(step))
        skip = _skipped_rows(out_j[1], title_j)
        loss, _ = train_step(port, losses.clip_loss, optimizer, scheduler, data_t,
                             {}, draws={"adapter_skip": skip})
        _close(loss, loss_j, atol=1e-5, rtol=1e-5)
        assert all(p.grad is None for p in port.parameters())
    ref = state_dict_from_jax(_np_tree(state.params))
    lr = {id(p): g["initial_lr"] for g in optimizer.param_groups for p in g["params"]}
    rel = []
    for name, p in port.named_parameters():
        d = np.abs(_np(p) - _np(ref[name])) / lr[id(p)]
        assert d.max() <= 2 * 3, (name, d.max())  # each step moves at most lr
        rel.append(d.ravel())
    assert np.quantile(np.concatenate(rel), 0.99) < 1e-2  # the bulk: 1% of lr


# ---- token truncation ---------------------------------------------------------

@pytest.mark.parametrize("eot", [5, 15, 16, 40, 76])
def test_truncate_batch_tokens_matches_jax(eot):
    from vtc_tpu.data import tokenizer as jax_tok
    from vtc_tpu_torch.data import tokenizer as tok

    rng = np.random.default_rng(eot)
    title = synthetic_tokens((3,), 77, 3, rng)
    comments = synthetic_tokens((3, 2), 77, eot - 1, rng)
    feats = rng.normal(size=(3, 77)).astype(np.float32)  # not tokens: floats
    batch = [feats, title, comments]
    ref = jax_tok.truncate_batch_tokens(batch)
    assert tok.batch_token_need(batch) == jax_tok.batch_token_need(batch)
    for ours in (tok.truncate_batch_tokens(batch),
                 tok.truncate_batch_tokens([torch.from_numpy(a) for a in batch])):
        assert [tuple(a.shape) for a in ours] == [a.shape for a in ref]
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(np.asarray(o), r)
    np.testing.assert_array_equal(tok.truncate_to_eot_bucket(comments),
                                  jax_tok.truncate_to_eot_bucket(comments))
