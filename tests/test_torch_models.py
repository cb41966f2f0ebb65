"""The port's models (vtc_tpu_torch.models) against the JAX package's flax
modules, on the same weights.

One JAX init of the ``test-tiny`` flagship (``PretrainedCLIP_finaltf``) is
made per module by the ``tiny`` fixture and carried into the port with
``state_dict_from_jax``; every module test reuses it. The CAM weights are
moved off their zero-init so the adapter's attention and MLP count. fp32
parity is at atol 2e-5 / rtol 1e-4, as tests/test_clip_parity.py; ``sim``
scales the features by exp(logit_scale) = 1/0.07 ≈ 14.3, so its atol is
14.3 · 2e-5 ≈ 3e-4. bf16 is held by the cosine of the normalized features,
> 0.995 as test_clip_parity.py::test_bf16_close_to_fp32: flax and PyTorch
round bf16 at different places.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.models.cam import ContextAdapter as JaxContextAdapter
from vtc_tpu.models.clip_model import (
    CLIP_VARIANTS as JAX_VARIANTS,
    TextTransformer as JaxTextTransformer,
    VisionTransformer as JaxVisionTransformer,
)
from vtc_tpu.models.factory import convert_weights as jax_convert_weights
from vtc_tpu.models.layers import Transformer as JaxTransformer
from vtc_tpu.models.layers import causal_mask as jax_causal_mask
from vtc_tpu.models.retrieval import PretrainedCLIP as JaxPretrainedCLIP
from vtc_tpu.models.retrieval import (
    PretrainedCLIP_finaltf as JaxPretrainedCLIP_finaltf,
)
from vtc_tpu.models.torch_export import export_vtc_state_dict
from vtc_tpu_torch.data import extract_patches, synthetic_tokens
from vtc_tpu_torch.models import (
    convert_weights,
    create_model,
    state_dict_from_jax,
)
from vtc_tpu_torch.models.cam import ContextAdapter
from vtc_tpu_torch.models.clip_model import (
    CLIP_VARIANTS,
    TextTransformer,
    VisionTransformer,
)
from vtc_tpu_torch.models.layers import Transformer
from vtc_tpu_torch.models.retrieval import PretrainedCLIP, PretrainedCLIP_finaltf

TINY = "test-tiny"
ATOL, RTOL = 2e-5, 1e-4
SIM_ATOL = 3e-4
DIM = 32  # test-tiny embed_dim, the CAM width


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(
        ours.detach().float().numpy(), np.asarray(ref, np.float32),
        atol=atol, rtol=RTOL,
    )


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def tiny():
    """(module, variables, state dict): the JAX test-tiny flagship with its
    CAM moved off zero-init and ``bn`` running stats, and the port's state
    dict carried from the same numpy weights."""
    module, variables = jax_create_model(
        "PretrainedCLIP_finaltf", model_type=TINY, seed=0,
        residual_activation="bn",
    )
    params = _np_tree(variables["params"])
    rng = np.random.default_rng(0)
    params["cam"] = jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), params["cam"]
    )
    stats = {"cam": {
        "mean": rng.normal(0, 0.1, DIM).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, DIM).astype(np.float32),
    }}
    sd = state_dict_from_jax(params, stats)
    variables = jax.tree_util.tree_map(
        jnp.asarray, {"params": params, "batch_stats": stats}
    )
    return module, variables, sd


def _flagship_inputs(batch=4, seed=0, patch=8, res=32):
    """bench.py's recipe: uint8 patches, 16-token title and 5 comments; the
    last comment of row 0 is empty (SOT, EOT)."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (batch, res, res, 3), dtype=np.uint8)
    vis = extract_patches(u8, patch)
    title = synthetic_tokens((batch,), 16, 14, rng)
    comments = synthetic_tokens((batch, 5), 16, 14, rng)
    comments[0, 4] = 0
    comments[0, 4, :2] = (49406, 49407)
    return vis, title, comments


def _port_flagship(sd, **kwargs):
    model = PretrainedCLIP_finaltf(model_type=TINY, **kwargs)
    model.load_state_dict(sd, strict=True)
    return model.eval()


# ---- per module ------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_transformer_matches_flax(tiny, causal):
    _, variables, sd = tiny
    tp = variables["params"]["clip"]["text"]["transformer"]
    x = np.random.default_rng(1).normal(size=(3, 16, 64)).astype(np.float32)
    mask = jax_causal_mask(16) if causal else None
    ref = JaxTransformer(64, 2, 4).apply({"params": tp}, jnp.asarray(x), mask)
    port = Transformer(64, 2, 4)
    port.load_state_dict(_sub(sd, "model.transformer."), strict=True)
    with torch.no_grad():
        _close(port(torch.from_numpy(x), causal), ref)


@pytest.mark.parametrize("path", ["nchw", "uint8_patches"])
def test_vision_transformer_matches_flax(tiny, path):
    _, variables, sd = tiny
    rng = np.random.default_rng(2)
    if path == "nchw":
        x = rng.normal(size=(3, 3, 32, 32)).astype(np.float32)
    else:
        x = extract_patches(rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8), 8)
    ref = JaxVisionTransformer(JAX_VARIANTS[TINY]).apply(
        {"params": variables["params"]["clip"]["visual"]}, jnp.asarray(x)
    )
    port = VisionTransformer(CLIP_VARIANTS[TINY])
    port.load_state_dict(_sub(sd, "model.visual."), strict=True)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), ref)


def test_text_transformer_matches_flax(tiny):
    _, variables, sd = tiny
    toks = synthetic_tokens((3,), 16, 9, np.random.default_rng(3))
    ref = JaxTextTransformer(JAX_VARIANTS[TINY]).apply(
        {"params": variables["params"]["clip"]["text"]}, jnp.asarray(toks)
    )
    port = TextTransformer(CLIP_VARIANTS[TINY])
    text_sd = {k: v for k, v in _sub(sd, "model.").items()
               if not k.startswith("visual.") and k != "logit_scale"}
    port.load_state_dict(text_sd, strict=True)
    with torch.no_grad():
        _close(port(torch.from_numpy(toks)), ref)


@pytest.mark.parametrize("act", [None, "normalize", "squash", "sub_mean", "bn"])
@pytest.mark.parametrize("init_from_avg", [True, False])
def test_context_adapter_adapt_matches_flax(tiny, act, init_from_avg):
    _, variables, sd = tiny
    rng = np.random.default_rng(4)
    main = rng.normal(size=(3, DIM)).astype(np.float32)
    aux = rng.normal(size=(5, 3, DIM)).astype(np.float32)
    jax_vars = {"params": variables["params"]["cam"],
                "batch_stats": variables["batch_stats"]["cam"]}
    ref = JaxContextAdapter(
        feature_dim=DIM, init_from_avg=init_from_avg, residual_activation=act
    ).apply(jax_vars, jnp.asarray(main), jnp.asarray(aux), method="adapt")
    port = ContextAdapter(feature_dim=DIM, init_from_avg=init_from_avg,
                          residual_activation=act)
    cam_sd = {k: v for k, v in sd.items() if not k.startswith("model.")}
    if act not in ("sub_mean", "bn"):
        cam_sd = {k: v for k, v in cam_sd.items() if "mean_center_bn" not in k}
    port.load_state_dict(cam_sd, strict=True)
    with torch.no_grad():  # eval: the running stats, no random adapter skip
        _close(port.eval().adapt(torch.from_numpy(main), torch.from_numpy(aux)), ref)


# ---- the slice as a whole --------------------------------------------------

@pytest.mark.parametrize("branch", ["text", "image", "skip"])
def test_flagship_forward_matches_flax(tiny, branch):
    module, variables, sd = tiny
    vis, title, comments = _flagship_inputs()
    ref = module.apply(
        variables, jnp.asarray(vis), jnp.asarray(title), jnp.asarray(comments),
        branch_override=branch,
    )
    port = _port_flagship(sd, residual_activation="bn")
    with torch.no_grad():
        ours = port(torch.from_numpy(vis), torch.from_numpy(title),
                    torch.from_numpy(comments), branch_override=branch)
    for o, r, atol in zip(ours, ref, (ATOL, ATOL, SIM_ATOL)):
        assert o.shape == r.shape and bool(torch.isfinite(o).all())
        _close(o, r, atol)


@pytest.mark.parametrize("fusion", [None, "averaging"])
def test_pretrained_clip_matches_flax(tiny, fusion):
    """The CAM-free wrapper, with and without averaging the comments into
    the title, on the flagship's CLIP towers."""
    _, variables, sd = tiny
    vis, title, comments = _flagship_inputs(seed=6)
    ref = JaxPretrainedCLIP(model_type=TINY, comment_fusion=fusion).apply(
        {"params": {"clip": variables["params"]["clip"]}},
        jnp.asarray(vis), jnp.asarray(title), jnp.asarray(comments),
    )
    port = PretrainedCLIP(model_type=TINY, comment_fusion=fusion)
    port.load_state_dict({k: v for k, v in sd.items() if k.startswith("model.")},
                         strict=True)
    with torch.no_grad():
        ours = port.eval()(*[torch.from_numpy(a) for a in (vis, title, comments)])
    for o, r, atol in zip(ours, ref, (ATOL, ATOL, SIM_ATOL)):
        _close(o, r, atol)


def test_visual_input_shapes(tiny):
    """Features pass through; a video of patch frames is the mean of its
    frames' features; other shapes raise."""
    _, _, sd = tiny
    port = _port_flagship(sd, residual_activation="bn")
    frames = _flagship_inputs(batch=6, seed=7)[0]
    with torch.no_grad():
        per_frame = port.encode_image(torch.from_numpy(frames))
        video = port.encode_image(torch.from_numpy(frames).reshape(2, 3, 16, 192))
        feats = torch.randn(2, DIM)
        torch.testing.assert_close(video, per_frame.reshape(2, 3, DIM).mean(1))
        torch.testing.assert_close(port.encode_image(feats), feats)
        with pytest.raises(ValueError, match="Unsupported visual input"):
            port.encode_image(torch.zeros(2, 7))


def test_flagship_shared_comments_broadcast(tiny):
    """A comment batch of 1 is shared by every row: the same result as the
    comments repeated per row."""
    _, _, sd = tiny
    vis, title, comments = _flagship_inputs()
    port = _port_flagship(sd, residual_activation="bn")
    vis, title = torch.from_numpy(vis), torch.from_numpy(title)
    shared = torch.from_numpy(comments[:1])
    with torch.no_grad():
        a = port(vis, title, shared)
        b = port(vis, title, shared.expand(4, -1, -1).contiguous())
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-5)


def test_flagship_bf16_close_to_flax_bf16_and_fp32(tiny):
    """bf16 via convert_weights on both sides: the port's normalized
    features track flax's bf16 model and the port's own fp32 model."""
    _, variables, sd = tiny
    jbf = JaxPretrainedCLIP_finaltf(
        model_type=TINY, dtype=jnp.bfloat16, residual_activation="bn"
    )
    vis, title, comments = _flagship_inputs(seed=5)
    ref = jbf.apply(
        {"params": jax_convert_weights(variables["params"]),
         "batch_stats": variables["batch_stats"]},
        jnp.asarray(vis), jnp.asarray(title), jnp.asarray(comments),
    )
    port32 = _port_flagship(sd, residual_activation="bn")
    port16 = _port_flagship(sd, residual_activation="bn", dtype=torch.bfloat16)
    convert_weights(port16)
    assert port16.model.visual.proj.dtype == torch.bfloat16
    assert port16.model.visual.ln_pre.weight.dtype == torch.float32
    inputs = [torch.from_numpy(a) for a in (vis, title, comments)]
    with torch.no_grad():
        ours16, ours32 = port16(*inputs), port32(*inputs)
    for a, b, c in zip(ours16[:2], ref[:2], ours32[:2]):
        a = a.float().numpy()
        assert (np.sum(a * np.asarray(b, np.float32), -1) > 0.995).all()
        assert (np.sum(a * c.numpy(), -1) > 0.995).all()


# ---- the weight carrier and the factory ------------------------------------

def test_state_dict_from_jax_equals_torch_export(tiny):
    module, variables, sd = tiny
    ref = export_vtc_state_dict(variables["params"], variables["batch_stats"])
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    # and the port's modules carry exactly those names
    port = PretrainedCLIP_finaltf(model_type=TINY, residual_activation="bn")
    port.load_state_dict(sd, strict=True)


def test_state_dict_from_jax_refuses_leaves_it_cannot_place(tiny):
    _, variables, _ = tiny
    params = _np_tree(variables["params"])
    params["video_head"] = {"fc1": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError, match="video_head"):
        state_dict_from_jax(params)
    params = _np_tree(variables["params"])
    params["cam"]["final_transformer"]["resblocks_0"]["mlp"]["c_gate"] = np.zeros(2)
    with pytest.raises(ValueError, match="c_gate"):
        state_dict_from_jax(params)


def test_create_model_is_seeded_and_zero_inits_the_cam():
    a = create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=3, device="cpu")
    b = create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=3, device="cpu")
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, atol=0, rtol=0, msg=k)
    blk = a.final_transformer.resblocks[0]
    assert not blk.attn.out_proj.weight.any() and not blk.mlp.c_proj.weight.any()
    assert not a.final_linear.weight.any()
    torch.testing.assert_close(a.model.logit_scale, torch.tensor(np.log(1 / 0.07),
                                                                 dtype=torch.float32))
    # the audio MLP: seeded too, flax's init (biases 0, BatchNorm scale 1);
    # audio features without it are refused
    audio = create_model("PretrainedCLIP_finaltf", model_type=TINY, device="cpu",
                         seed=3, init_audio_model=True)
    mlp = audio.audio_model.mlp.layers
    assert not mlp[1].bias.any() and bool((mlp[2].weight == 1).all())
    assert 0.03 < float(mlp[1].weight.std()) < 0.06  # lecun_normal: 512 ** -0.5
    for k, x in a.state_dict().items():
        torch.testing.assert_close(audio.state_dict()[k], x, atol=0, rtol=0, msg=k)
    with pytest.raises(ValueError, match="init_audio_model"):
        a(torch.zeros(1, 3, 32, 32), torch.zeros(1, 77, dtype=torch.long),
          torch.zeros(1, 2, 77, dtype=torch.long), torch.zeros(1, 5, 512))


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    from vtc_tpu_torch.serving import ClipRetrievalService, RetrievalIndex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("PretrainedCLIP", model_type=TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalIndex(DIM)
    model = create_model("PretrainedCLIP", model_type=TINY, device="cpu")
    index = RetrievalIndex(DIM, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClipRetrievalService(model, index)


def test_port_imports_no_jax():
    """No module of vtc_tpu_torch, nor chip_smoke.py, imports jax, flax,
    optax, orbax or the JAX package, nor pandas or regex (the machine with
    the card has neither); PIL only inside the CPU route of
    ``data/image_io.py:decode_rgb``. The walk takes every module of the
    package, the evaluation, serving and script modules among them."""
    root = Path(__file__).resolve().parent.parent
    files = sorted((root / "vtc_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    walked = {f.relative_to(root).as_posix() for f in files}
    assert {f"vtc_tpu_torch/{m}.py" for m in (
        "evaluation/retrieval_eval", "evaluation/eval", "evaluation/retrieval_evaluation",
        "serving/server", "scripts/serve", "scripts/get_clip_vit_embeddings",
        "scripts/bench_serving", "data/png", "data/image_io", "data/video",
        "data/video_retrieval", "scripts/bench_video_pipeline", "parallel/mesh",
        "utils/util", "parallel/tensor", "data/gif", "data/bmp", "scripts/dryrun_fullsize",
        "scripts/profile_trace", "data/webp")} <= walked
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "vtc_tpu", "pandas", "regex")
    pil_imports = []
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        # the innermost function around each node (inner ones come later)
        functions = {id(n): fn.name for fn in ast.walk(tree)
                     if isinstance(fn, ast.FunctionDef) for n in ast.walk(fn)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, f"{f}: imports {n}"
                if n.split(".")[0] == "PIL":
                    pil_imports.append((f.relative_to(root).as_posix(),
                                        functions.get(id(node))))
    assert pil_imports == [("vtc_tpu_torch/data/image_io.py", "decode_rgb")]


@pytest.mark.slow
def test_flagship_vit_b32_matches_flax_at_full_width():
    """Full ViT-B/32 width and depth, fp32, on the CPU."""
    module, variables = jax_create_model(
        "PretrainedCLIP_finaltf", model_type="ViT-B/32", seed=0
    )
    params = _np_tree(variables["params"])
    vis, title, comments = _flagship_inputs(batch=2, patch=32, res=224)
    ref = module.apply(variables, jnp.asarray(vis), jnp.asarray(title),
                       jnp.asarray(comments))
    port = PretrainedCLIP_finaltf(model_type="ViT-B/32")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        ours = port.eval()(*[torch.from_numpy(a) for a in (vis, title, comments)])
    for o, r, atol in zip(ours, ref, (ATOL, ATOL, SIM_ATOL)):
        _close(o, r, atol)
