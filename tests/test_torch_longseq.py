"""The port past the short attention tile: ViT-B/16 (L = 197) and ViT-L/14
(L = 257) against the JAX package, on the CPU.

The JAX package runs these lengths through XLA attention
(``vtc_tpu/models/layers.py:269-290``); the port's ``fused_mha`` takes them
on its long route (on the CPU its plain version, ``fused_mha_plain``). The
models run at tiny widths with the real patch sizes at 224 (``test-b16``:
patch 16, ``test-l14``: patch 14 and an ``embed_dim`` of its own, as
ViT-L/14's 768 differs from the text width), registered in both packages'
``CLIP_VARIANTS`` for the module. Inputs come from numpy seeds; weights
from a JAX init carried over by ``state_dict_from_jax``. fp32 parity at
atol 2e-5 / rtol 1e-4 (tests/test_clip_parity.py's), ``sim`` at
exp(logit_scale) · 2e-5 ≈ 3e-4; gradients at 2e-5 of each parameter's
largest; bf16 by the cosine of the normalized features, > 0.995
(test_clip_parity.py::test_bf16_close_to_fp32). Torch runs on one thread.
Full-width ViT-B/16 and ViT-L/14 parity is under ``-m slow``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.models import clip_model as jax_clip_model
from vtc_tpu.models.factory import convert_weights as jax_convert_weights
from vtc_tpu.models.layers import MultiHeadAttention as JaxMultiHeadAttention
from vtc_tpu.models.layers import causal_mask as jax_causal_mask
from vtc_tpu_torch import ops
from vtc_tpu_torch.data import extract_patches, synthetic_tokens
from vtc_tpu_torch.models import convert_weights, create_model, state_dict_from_jax
from vtc_tpu_torch.models import clip_model
from vtc_tpu_torch.models.layers import MultiHeadAttention

ATOL, RTOL = 2e-5, 1e-4
SIM_ATOL = 3e-4
TINY = dict(input_resolution=224, vision_width=64, vision_layers=2, vision_heads=4,
            embed_dim=32, text_width=64, text_layers=2, text_heads=4)
VARIANTS = {  # name: (variant, tokens of the image tower)
    "test-b16": (dict(TINY, patch_size=16), 197),
    "test-l14": (dict(TINY, patch_size=14, vision_layers=1, embed_dim=48), 257),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _variants():
    """The tiny long-sequence variants in both packages' tables."""
    with pytest.MonkeyPatch.context() as mp:
        for name, (kw, _) in VARIANTS.items():
            mp.setitem(jax_clip_model.CLIP_VARIANTS, name,
                       jax_clip_model.ClipVariant(**kw))
            mp.setitem(clip_model.CLIP_VARIANTS, name, clip_model.ClipVariant(**kw))
        yield


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=RTOL)


def _inputs(model_type, batch=2, seed=0, frames=0):
    """bench.py's recipe: uint8 patches at 224, 16-token title, 5 comments."""
    patch = VARIANTS[model_type][0]["patch_size"]
    rng = np.random.default_rng(seed)
    lead = (batch, frames) if frames else (batch,)
    vis = extract_patches(rng.integers(0, 256, lead + (224, 224, 3), dtype=np.uint8), patch)
    title = synthetic_tokens((batch,), 16, 14, rng)
    comments = synthetic_tokens((batch, 5), 16, 14, rng)
    return vis, title, comments


_JAX_INITS = {}


def _carried(arch, model_type, **kwargs):
    """(JAX module, variables, the port's model in eval mode on the same
    weights); the CAM moved off its zero-init so its attention counts. The
    JAX init is made once per model for the module."""
    key = (arch, model_type, tuple(sorted(kwargs.items())))
    if key not in _JAX_INITS:
        module, variables = jax_create_model(arch, model_type=model_type, seed=0, **kwargs)
        params = _np_tree(variables["params"])
        rng = np.random.default_rng(0)
        params["cam"] = jax.tree_util.tree_map(
            lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), params["cam"])
        _JAX_INITS[key] = module, params
    module, params = _JAX_INITS[key]
    port = create_model(arch, model_type=model_type, device="cpu", **kwargs)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    return module, variables, port.eval()


# ---- the attention itself ----------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", [129, 197, 257])
def test_mha_matches_xla_attention(length, causal):
    """The port's ``MultiHeadAttention`` (``fused_mha``'s plain version on
    the CPU) against the JAX module's XLA attention, shared weights."""
    e, h = 128, 2
    module = JaxMultiHeadAttention(e, h)
    x = np.random.default_rng(length).normal(size=(2, length, e)).astype(np.float32)
    params = _np_tree(module.init(jax.random.PRNGKey(length), jnp.asarray(x))["params"])
    params["in_proj_bias"] = np.random.default_rng(1).normal(
        0, 0.1, params["in_proj_bias"].shape).astype(np.float32)
    mask = jax_causal_mask(length) if causal else None
    ref = module.apply({"params": params}, jnp.asarray(x), mask)
    port = MultiHeadAttention(e, h)
    port.load_state_dict({
        "in_proj_weight": torch.tensor(params["in_proj_weight"].reshape(3 * e, e)),
        "in_proj_bias": torch.tensor(params["in_proj_bias"].reshape(3 * e)),
        "out_proj.weight": torch.from_numpy(params["out_proj"]["kernel"].T.copy()),
        "out_proj.bias": torch.from_numpy(params["out_proj"]["bias"]),
    })
    before = ops.launch_counts()
    with torch.no_grad():
        _close(port(torch.from_numpy(x), causal), ref)
    assert ops.launch_counts() == before  # the CPU launches no kernel


# ---- the towers and the flagship ---------------------------------------------

@pytest.mark.parametrize("model_type", list(VARIANTS))
def test_vision_transformer_matches_flax(model_type):
    module, variables, port = _carried("PretrainedCLIP_finaltf", model_type)
    vis = _inputs(model_type)[0]
    tokens = VARIANTS[model_type][1]
    assert port.model.visual.positional_embedding.shape[0] == tokens
    ref = module.apply(variables, jnp.asarray(vis),
                       method=lambda m, x: m.clip.encode_image(x))
    with torch.no_grad():
        _close(port.model.visual(torch.from_numpy(vis)), ref)


@pytest.mark.parametrize("model_type", list(VARIANTS))
def test_flagship_forward_and_gradients_match_flax(model_type):
    """``create_model("PretrainedCLIP_finaltf", model_type=...)``: the
    forward at atol 2e-5, and every parameter's gradient of the summed
    features and similarities against ``jax.grad``, mapped onto the port's
    names by ``state_dict_from_jax``."""
    module, variables, port = _carried("PretrainedCLIP_finaltf", model_type)
    data = _inputs(model_type, seed=1)
    dim = VARIANTS[model_type][0]["embed_dim"]

    def objective(fv, ft, sim):
        return (fv * 0.5).sum() + ft.sum() + 0.01 * sim.sum()

    def loss_fn(p):
        out = module.apply({"params": p}, *[jnp.asarray(a) for a in data])
        return objective(*out), out

    (_, ref), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    out = port(*[torch.from_numpy(a) for a in data])
    assert out[0].shape == (2, dim) and out[1].shape == (2, dim)
    for o, r, atol in zip(out, ref, (ATOL, ATOL, SIM_ATOL)):
        _close(o, r, atol)
    objective(*out).backward()
    ref_g = state_dict_from_jax(_np_tree(grads))
    for name, p in port.named_parameters():
        ours = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(1.0, float(ref_g[name].abs().max()))
        np.testing.assert_allclose(ours.numpy(), ref_g[name].numpy(), atol=ATOL * scale,
                                   rtol=RTOL, err_msg=name)
    assert port.model.visual.positional_embedding.grad.abs().max() > 0


def test_timesformer_b16_matches_flax():
    """The TimeSformer at patch 16, 2 frames: its spatial attention runs at
    L = 197 per frame (the long route), its temporal attention at L = 2."""
    module, variables, port = _carried("PretrainedCLIP_TimeSformer_finaltf", "test-b16",
                                       nframes=2)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    rng = np.random.default_rng(3)
    # temporal_fc and temporal_embed off their zero-init, so the temporal
    # branch counts
    for k, v in params["clip"]["visual"].items():
        if k.startswith("transformer_resblocks_"):
            v["temporal_fc"] = jax.tree_util.tree_map(
                lambda x: rng.normal(0, 0.02, x.shape).astype(np.float32), v["temporal_fc"])
    params["clip"]["visual"]["temporal_embed"] = rng.normal(
        0, 0.02, params["clip"]["visual"]["temporal_embed"].shape).astype(np.float32)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    data = _inputs("test-b16", seed=2, frames=2)
    ref = module.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                       *[jnp.asarray(a) for a in data])
    with torch.no_grad():
        out = port(*[torch.from_numpy(a) for a in data])
    for o, r, atol in zip(out, ref, (ATOL, ATOL, SIM_ATOL)):
        assert o.shape == r.shape and bool(torch.isfinite(o).all())
        _close(o, r, atol)


@pytest.mark.parametrize("model_type", list(VARIANTS))
def test_bf16_close_to_fp32(model_type):
    """bf16 by ``convert_weights`` on both sides: the port's normalized
    features track flax's bf16 model and the port's own fp32 one."""
    module, variables, port32 = _carried("PretrainedCLIP_finaltf", model_type)
    jbf = type(module)(model_type=model_type, dtype=jnp.bfloat16)
    data = _inputs(model_type, seed=4)
    ref = jbf.apply({"params": jax_convert_weights(variables["params"])},
                    *[jnp.asarray(a) for a in data])
    port16 = create_model("PretrainedCLIP_finaltf", model_type=model_type, device="cpu",
                          dtype="bf16")
    port16.load_state_dict(port32.state_dict(), strict=True)
    convert_weights(port16.eval())
    inputs = [torch.from_numpy(a) for a in data]
    with torch.no_grad():
        ours16, ours32 = port16(*inputs), port32(*inputs)
    for a, b, c in zip(ours16[:2], ref[:2], ours32[:2]):
        a = a.float().numpy()
        assert (np.sum(a * np.asarray(b, np.float32), -1) > 0.995).all()
        assert (np.sum(a * c.numpy(), -1) > 0.995).all()


# ---- full width ------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("model_type", ["ViT-B/16", "ViT-L/14"])
def test_flagship_matches_flax_at_full_width(model_type):
    """Full ViT-B/16 and ViT-L/14 width and depth, fp32, on the CPU."""
    module, variables = jax_create_model("PretrainedCLIP_finaltf", model_type=model_type,
                                         seed=0)
    params = _np_tree(variables["params"])
    patch = jax_clip_model.CLIP_VARIANTS[model_type].patch_size
    rng = np.random.default_rng(0)
    vis = extract_patches(rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8), patch)
    title = synthetic_tokens((2,), 16, 14, rng)
    comments = synthetic_tokens((2, 5), 16, 14, rng)
    data = (vis, title, comments)
    ref = module.apply(variables, *[jnp.asarray(a) for a in data])
    port = create_model("PretrainedCLIP_finaltf", model_type=model_type, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        ours = port.eval()(*[torch.from_numpy(a) for a in data])
    for o, r, atol in zip(ours, ref, (ATOL, ATOL, SIM_ATOL)):
        _close(o, r, atol)


def test_variants_declare_the_lengths():
    """The declared variants give the lengths the long route serves."""
    for name, tokens in (("ViT-B/16", 197), ("ViT-L/14", 257)):
        v = clip_model.CLIP_VARIANTS[name]
        assert (v.input_resolution // v.patch_size) ** 2 + 1 == tokens
        assert dataclasses.asdict(v) == dataclasses.asdict(
            jax_clip_model.CLIP_VARIANTS[name])
