"""The port's joint-layout TimeSformer (``vtc_tpu_torch.models.
timesformer_joint``) against ``vtc_tpu.models.timesformer_joint`` on the
same weights, at ``test-tiny`` with 4 frames (L = 1 + 4·16 = 65), on the
CPU (the kernels' plain versions).

* The surgery against ``joint_timesformer_params_from_clip_visual``, entry
  for entry, from one ViT init.
* The forward against ``TimeSformerJoint.apply`` at fp32 atol 2e-5
  (``tests/test_pallas_attention.py``'s), with the time attention and the
  temporal embedding moved off their no-op init by seeded noise; bf16 by
  the cosine of the normalized features, > 0.995
  (``test_clip_parity.py::test_bf16_close_to_fp32``); the input gradient
  against ``jax.grad``; ``VTC_REMAT=1`` equal to the plain forward and
  gradient.
* The init's time attention is an exact no-op, as
  ``tests/test_model_zoo_extra.py`` holds it.
* ``fused_mha_plain`` and ``mha_backward`` at Lq < Lk (the CLS row's 1
  query over all keys) against the JAX model's ``_attn`` and its
  ``jax.vjp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtc_tpu.models.clip_model import CLIP_VARIANTS as JAX_VARIANTS
from vtc_tpu.models.clip_model import VisionTransformer as JaxVisionTransformer
from vtc_tpu.models.timesformer_joint import TimeSformerJoint as JaxJoint
from vtc_tpu.models.timesformer_joint import _attn as jax_attn
from vtc_tpu.models.timesformer_joint import (
    joint_timesformer_params_from_clip_visual as jax_surgery,
)
from vtc_tpu_torch.models import joint_state_dict_from_jax
from vtc_tpu_torch.models.clip_model import CLIP_VARIANTS
from vtc_tpu_torch.models.from_jax import _blocks, _Reader, _visual_stem
from vtc_tpu_torch.models.timesformer_joint import (
    TimeSformerJoint,
    joint_timesformer_params_from_clip_visual,
)
from vtc_tpu_torch.ops.attention import fused_mha, fused_mha_plain, mha_backward

TINY = "test-tiny"
NF = 4
RES = JAX_VARIANTS[TINY].input_resolution
ATOL = 2e-5  # tests/test_pallas_attention.py:114


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def vit_params():
    vit = JaxVisionTransformer(variant=JAX_VARIANTS[TINY])
    return _np_tree(vit.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, RES, RES)))["params"])


@pytest.fixture(scope="module")
def params(vit_params):
    """The surgery's tree with the time attention, ``ln_time`` and the
    temporal embedding moved off their init by seeded noise."""
    p = _np_tree(jax_surgery(vit_params, JAX_VARIANTS[TINY], NF))
    rng = np.random.default_rng(1)

    def noise(x, scale):
        return (x + rng.normal(0, scale, x.shape)).astype(np.float32)

    for i in range(JAX_VARIANTS[TINY].vision_layers):
        blk = p[f"transformer_resblocks_{i}"]
        blk["timeattn"] = jax.tree_util.tree_map(lambda x: noise(x, 0.05), blk["timeattn"])
        blk["timeattn"]["out_proj"]["kernel"] = noise(
            np.zeros_like(blk["timeattn"]["out_proj"]["kernel"]), 0.05)
        blk["ln_time"] = jax.tree_util.tree_map(lambda x: noise(x, 0.05), blk["ln_time"])
    p["temporal_embed"] = noise(p["temporal_embed"], 0.05)
    return p


@pytest.fixture(scope="module")
def jax_forward():
    """``TimeSformerJoint.apply`` compiled once for the tests' batch of 2."""
    module = JaxJoint(variant=JAX_VARIANTS[TINY], nframes=NF)
    return jax.jit(lambda p, x: module.apply({"params": p}, x))


def _video(batch=2, seed=0):
    return np.random.default_rng(seed).normal(size=(batch, NF, 3, RES, RES)).astype(np.float32)


def _port(params, dtype=torch.float32):
    model = TimeSformerJoint(CLIP_VARIANTS[TINY], NF, dtype=dtype)
    model.load_state_dict(joint_state_dict_from_jax(params), strict=True)
    return model


def _visual_state_dict(vit_params):
    """The JAX ViT's tree in the port's ``VisionTransformer`` names."""
    sd = {}
    r = _Reader(vit_params)
    _visual_stem(r, "", sd, "")
    _blocks(r, "transformer", sd, "transformer")
    assert not r.unconsumed()
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def test_surgery_matches_jax(vit_params):
    ours = joint_timesformer_params_from_clip_visual(
        _visual_state_dict(vit_params), CLIP_VARIANTS[TINY], NF)
    ref = joint_state_dict_from_jax(_np_tree(jax_surgery(vit_params, JAX_VARIANTS[TINY], NF)))
    assert sorted(ours) == sorted(ref)
    for name, t in ref.items():
        assert torch.equal(ours[name], t), name
    model = TimeSformerJoint(CLIP_VARIANTS[TINY], NF)
    model.load_state_dict(ours, strict=True)
    assert sorted(ours) == sorted(model.state_dict())


def test_forward_matches_jax_fp32(params, jax_forward):
    video = _video()
    ref = np.asarray(jax_forward(params, jnp.asarray(video)))
    with torch.no_grad():
        ours = _port(params)(torch.from_numpy(video)).numpy()
    assert ours.shape == (2, JAX_VARIANTS[TINY].embed_dim)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def test_bf16_close_to_fp32(params, jax_forward):
    video = _video(seed=2)
    ref = np.asarray(jax_forward(params, jnp.asarray(video)))
    with torch.no_grad():
        ours = _port(params, torch.bfloat16)(torch.from_numpy(video)).float().numpy()
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    ours = ours / np.linalg.norm(ours, axis=-1, keepdims=True)
    cos = np.sum(ours * ref, axis=-1)
    assert (cos > 0.995).all(), cos


def test_input_gradient_matches_jax(params):
    video = _video(seed=3)
    rng = np.random.default_rng(4)
    cot = rng.normal(size=(2, JAX_VARIANTS[TINY].embed_dim)).astype(np.float32)
    module = JaxJoint(variant=JAX_VARIANTS[TINY], nframes=NF)
    ref = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(module.apply({"params": params}, x) * cot)))(jnp.asarray(video)))
    x = torch.from_numpy(video).requires_grad_()
    (_port(params)(x) * torch.from_numpy(cot)).sum().backward()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(x.grad.numpy(), ref, atol=1e-5 * scale, rtol=0)


def test_remat_equals_the_plain_forward(params, monkeypatch):
    video = torch.from_numpy(_video(seed=5))
    model = _port(params)
    outs, grads = [], []
    for remat in ("0", "1"):
        monkeypatch.setenv("VTC_REMAT", remat)
        model.zero_grad(set_to_none=True)
        out = model(video)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert torch.equal(outs[0], outs[1])
    for name, g in grads[0].items():
        assert torch.equal(grads[1][name], g), name


def test_time_attention_is_a_no_op_at_init(vit_params, jax_forward):
    """With the surgery's init the time attention adds exactly zero: the
    model equals itself with the time path's ``out_proj`` zeroed, and
    ``vtc_tpu``'s output."""
    p = _np_tree(jax_surgery(vit_params, JAX_VARIANTS[TINY], NF))
    video = _video(seed=6)
    model = _port(p)
    with torch.no_grad():
        out = model(torch.from_numpy(video))
        for block in model.transformer.resblocks:
            block.timeattn.out_proj.weight.zero_()
        ablated = model(torch.from_numpy(video))
    assert torch.equal(out, ablated)
    ref = np.asarray(jax_forward(p, jnp.asarray(video)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq, lk", [(1, 65), (5, 9)])
def test_attention_with_fewer_queries_than_keys(dtype, lq, lk):
    """``fused_mha`` (on the CPU its plain version) and ``mha_backward`` at
    Lq < Lk against ``_attn`` on the heads split out, q scaled first as the
    JAX model does, and ``jax.vjp`` of it: fp32 at 2e-5 (the output) and
    1e-5 of the largest (the gradients); bf16 to one bf16 ulp."""
    b, heads, dh = 2, 4, 16
    e = heads * dh
    rng = np.random.default_rng(lq * 1000 + lk)
    q, k, v, g = (rng.normal(size=(b, n, e)).astype(np.float32) for n in (lq, lk, lk, lq))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def ref(q_, k_, v_):
        def heads_of(z):
            return jnp.moveaxis(z.reshape(b, -1, heads, dh), 2, 1).reshape(b * heads, -1, dh)

        out = jax_attn(heads_of(q_) * (dh ** -0.5), heads_of(k_), heads_of(v_))
        return jnp.moveaxis(out.reshape(b, heads, lq, dh), 1, 2).reshape(b, lq, e)

    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    out_j, vjp = jax.vjp(jax.jit(ref), jq, jk, jv)
    grads_j = vjp(jnp.asarray(g).astype(jdt))
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    out = fused_mha(tq, tk, tv, heads)
    assert torch.equal(out, fused_mha_plain(tq, tk, tv, heads))
    grads = mha_backward(tq, tk, tv, torch.from_numpy(g).to(dtype), heads, False, dh ** -0.5)
    pairs = [(out, out_j)] + list(zip(grads, grads_j))
    for i, (ours, theirs) in enumerate(pairs):
        theirs = np.asarray(theirs.astype(jnp.float32))
        assert ours.shape == theirs.shape and ours.dtype == dtype, i
        ours = ours.float().numpy()
        if dtype == torch.float32:
            tol = ATOL if i == 0 else 1e-5 * np.abs(theirs).max()
        else:  # one bf16 ulp of the largest
            tol = 2.0 ** -7 * np.abs(theirs).max()
        np.testing.assert_allclose(ours, theirs, atol=tol, rtol=0, err_msg=str(i))
    with pytest.raises(ValueError, match="causal"):
        fused_mha(tq, tk, tv, heads, causal=True)
    with pytest.raises(ValueError, match="shapes differ"):
        fused_mha(tk, tq, tv, heads)
