"""The port's TimeSformer video models against the JAX package's flax
modules, on the same weights, at ``test-tiny`` with ``NFRAMES = 4`` (as
tests/test_timesformer.py).

One JAX init of ``PretrainedCLIP_TimeSformer_finaltf`` is made per module
by the ``video`` fixture and carried into the port with
``state_dict_from_jax``. The CAM, ``temporal_fc`` and ``temporal_embed`` are
moved off their zero-init by seeded noise, so the temporal branch (the
``fused_attention`` path) and the adapter count. The JAX temporal attention
folds the ``b·n`` sequences of 4 frames into masked calls of 32
(``seq_fold=0``) and the port does not: fp32 parity at atol 2e-5 / rtol 1e-4
(tests/test_clip_parity.py's), ``sim`` at exp(logit_scale) · 2e-5 ≈ 3e-4,
shows the two agree. bf16 is held by the cosine of the normalized features,
> 0.995 (test_clip_parity.py::test_bf16_close_to_fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.models.clip_model import CLIP_VARIANTS as JAX_VARIANTS
from vtc_tpu.models.factory import convert_weights as jax_convert_weights
from vtc_tpu.models.layers import MultiHeadAttention as JaxMultiHeadAttention
from vtc_tpu.models.layers import pick_seq_fold
from vtc_tpu.models.retrieval import (
    PretrainedCLIP_TimeSformer as JaxPretrainedCLIP_TimeSformer,
    PretrainedCLIP_TimeSformer_finaltf as JaxPretrainedCLIP_TimeSformer_finaltf,
)
from vtc_tpu.models.timesformer import TimeSformer as JaxTimeSformer
from vtc_tpu.models.torch_export import export_vtc_state_dict
from vtc_tpu.utils import jsonc as jax_jsonc
from vtc_tpu_torch import ops
from vtc_tpu_torch.data import extract_patches, synthetic_tokens
from vtc_tpu_torch.models import convert_weights, create_model, state_dict_from_jax
from vtc_tpu_torch.models.clip_model import CLIP_VARIANTS
from vtc_tpu_torch.models.layers import HeadsAttention
from vtc_tpu_torch.models.retrieval import (
    PretrainedCLIP_TimeSformer,
    PretrainedCLIP_TimeSformer_finaltf,
)
from vtc_tpu_torch.models.timesformer import (
    TimeSformer,
    timesformer_params_from_clip_visual,
)
from vtc_tpu_torch.utils import jsonc

TINY = "test-tiny"
NFRAMES = 4
ATOL, RTOL = 2e-5, 1e-4
SIM_ATOL = 3e-4
WIDTH = 64  # test-tiny vision width
CONFIG = "configs/pretrained_clip_timesformer_comments_attention.jsonc"


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
def video():
    """(module, variables, state dict): the JAX test-tiny video CAM model
    with the CAM, ``temporal_fc`` and ``temporal_embed`` moved off their
    zero-init, and the port's state dict carried from the same weights."""
    module, variables = jax_create_model(
        "PretrainedCLIP_TimeSformer_finaltf", model_type=TINY, seed=0,
        nframes=NFRAMES,
    )
    params = _np_tree(variables["params"])
    rng = np.random.default_rng(0)

    def noise(x):
        return x + rng.normal(0, 0.05, x.shape).astype(np.float32)

    params["cam"] = jax.tree_util.tree_map(noise, params["cam"])
    vis = params["clip"]["visual"]
    vis["temporal_embed"] = noise(vis["temporal_embed"])
    for name, block in vis.items():
        if name.startswith("transformer_resblocks_"):
            block["temporal_fc"] = jax.tree_util.tree_map(noise, block["temporal_fc"])
    sd = state_dict_from_jax(params)
    return module, jax.tree_util.tree_map(jnp.asarray, {"params": params}), sd


def _video_inputs(batch=4, seed=0):
    """uint8 patch frames [b, 4, 16, 192], a 16-token title and 5 comments;
    the last comment of row 0 is empty (SOT, EOT)."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (batch, NFRAMES, 32, 32, 3), dtype=np.uint8)
    vis = extract_patches(u8, 8)
    title = synthetic_tokens((batch,), 16, 14, rng)
    comments = synthetic_tokens((batch, 5), 16, 14, rng)
    comments[0, 4] = 0
    comments[0, 4, :2] = (49406, 49407)
    return vis, title, comments


def _port(sd, cls=PretrainedCLIP_TimeSformer_finaltf, **kwargs):
    model = cls(model_type=TINY, nframes=NFRAMES, **kwargs)
    if cls is PretrainedCLIP_TimeSformer:
        sd = {k: v for k, v in sd.items() if k.startswith("model.")}
    model.load_state_dict(sd, strict=True)
    return model.eval()


# ---- per module ------------------------------------------------------------

def test_heads_attention_matches_folded_flax_attention(video):
    """``timeattn``: the port attends each 4-frame sequence on its own
    through ``fused_attention``; flax folds 32 of them into one masked call."""
    _, variables, sd = video
    assert pick_seq_fold(64, NFRAMES) == 32
    blk = variables["params"]["clip"]["visual"]["transformer_resblocks_1"]
    x = np.random.default_rng(1).normal(size=(64, NFRAMES, WIDTH)).astype(np.float32)
    ref = JaxMultiHeadAttention(WIDTH, 4, seq_fold=0).apply(
        {"params": blk["timeattn"]}, jnp.asarray(x)
    )
    port = HeadsAttention(WIDTH, 4)
    port.load_state_dict(_sub(sd, "model.visual.transformer.resblocks.1.timeattn."),
                         strict=True)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("path", ["nchw", "uint8_patches"])
def test_timesformer_tower_matches_flax(video, path):
    _, variables, sd = video
    rng = np.random.default_rng(2)
    if path == "nchw":
        x = rng.normal(size=(2, NFRAMES, 3, 32, 32)).astype(np.float32)
    else:
        u8 = rng.integers(0, 256, (2, NFRAMES, 32, 32, 3), dtype=np.uint8)
        x = extract_patches(u8, 8)
    ref = JaxTimeSformer(JAX_VARIANTS[TINY], nframes=NFRAMES).apply(
        {"params": variables["params"]["clip"]["visual"]}, jnp.asarray(x)
    )
    port = TimeSformer(CLIP_VARIANTS[TINY], nframes=NFRAMES)
    port.load_state_dict(_sub(sd, "model.visual."), strict=True)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), ref)
    with pytest.raises(ValueError, match="takes 4 frames"):
        port(torch.from_numpy(x[:, :2]))


# ---- the slice as a whole --------------------------------------------------

@pytest.mark.parametrize("branch", ["text", "image", "skip"])
def test_video_cam_model_matches_flax(video, branch):
    module, variables, sd = video
    vis, title, comments = _video_inputs()
    ref = module.apply(variables, *(jnp.asarray(a) for a in (vis, title, comments)),
                       branch_override=branch)
    port = _port(sd)
    before = ops.launch_counts()
    with torch.no_grad():
        ours = port(*(torch.from_numpy(a) for a in (vis, title, comments)),
                    branch_override=branch)
    assert ops.launch_counts() == before  # the CPU runs no kernel
    for o, r, atol in zip(ours, ref, (ATOL, ATOL, SIM_ATOL)):
        assert o.shape == r.shape and bool(torch.isfinite(o).all())
        _close(o, r, atol)


def test_video_model_without_cam_matches_flax(video):
    _, variables, sd = video
    vis, title, _ = _video_inputs(seed=3)
    ref = JaxPretrainedCLIP_TimeSformer(model_type=TINY, nframes=NFRAMES).apply(
        {"params": {"clip": variables["params"]["clip"]}},
        jnp.asarray(vis), jnp.asarray(title),
    )
    port = _port(sd, PretrainedCLIP_TimeSformer)
    with torch.no_grad():
        ours = port(torch.from_numpy(vis), torch.from_numpy(title))
        enc = port.encode_image(torch.from_numpy(vis))
    for o, r, atol in zip(ours, ref, (ATOL, ATOL, SIM_ATOL)):
        _close(o, r, atol)
    # encode_image goes straight to the video tower: unnormalized features
    torch.testing.assert_close(enc / enc.norm(dim=-1, keepdim=True), ours[0])


def test_video_bf16_close_to_flax_bf16_and_fp32(video):
    """bf16 via convert_weights on both sides. flax rounds the folded
    temporal logits to bf16 (``layers.py:308-312``); the port keeps them
    fp32, so the two are held by the cosine."""
    _, variables, sd = video
    vis, title, comments = _video_inputs(seed=5)
    ref = JaxPretrainedCLIP_TimeSformer_finaltf(
        model_type=TINY, nframes=NFRAMES, dtype=jnp.bfloat16
    ).apply({"params": jax_convert_weights(variables["params"])},
            *(jnp.asarray(a) for a in (vis, title, comments)))
    port32 = _port(sd)
    port16 = convert_weights(_port(sd, dtype=torch.bfloat16))
    visual = port16.model.visual
    assert visual.temporal_embed.dtype == torch.float32
    assert visual.class_embedding.dtype == torch.float32
    block = visual.transformer.resblocks[0]
    assert block.timeattn.in_proj_weight.dtype == torch.bfloat16
    assert block.temporal_fc.weight.dtype == torch.bfloat16
    assert block.ln_time.weight.dtype == torch.float32
    inputs = [torch.from_numpy(a) for a in (vis, title, comments)]
    with torch.no_grad():
        ours16, ours32 = port16(*inputs), port32(*inputs)
    for a, b, c in zip(ours16[:2], ref[:2], ours32[:2]):
        a = a.float().numpy()
        assert (np.sum(a * np.asarray(b, np.float32), -1) > 0.995).all()
        assert (np.sum(a * c.numpy(), -1) > 0.995).all()


# ---- the weight carrier, the surgery and the factory -----------------------

def test_state_dict_from_jax_equals_torch_export_for_video(video):
    _, variables, sd = video
    ref = export_vtc_state_dict(variables["params"])
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    _port(sd)
    _port(sd, PretrainedCLIP_TimeSformer)


def test_state_dict_from_jax_refuses_a_leaf_it_cannot_place(video):
    _, variables, _ = video
    params = _np_tree(variables["params"])
    params["clip"]["visual"]["transformer_resblocks_0"]["extra"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="transformer_resblocks_0/extra"):
        state_dict_from_jax(params)


def test_surgery_starts_as_the_frame_mean_vit():
    """At surgery (zero temporal_fc and temporal_embed) a video of one
    repeated frame gives the CLIP ViT's output for that frame
    (tests/test_timesformer.py::test_init_equals_frame_mean_vit); only
    time/temporal keys are new, with the JAX surgery's initial values."""
    clip = create_model("PretrainedCLIP", model_type=TINY, seed=1, device="cpu")
    vit_sd = clip.model.visual.state_dict()
    tsf_sd = timesformer_params_from_clip_visual(vit_sd, CLIP_VARIANTS[TINY],
                                                 nframes=NFRAMES, seed=0)
    tower = TimeSformer(CLIP_VARIANTS[TINY], nframes=NFRAMES)
    tower.load_state_dict(tsf_sd, strict=True)
    new = set(tsf_sd) - set(vit_sd)
    assert new and all("time" in k or "temporal" in k for k in new)
    blk = "transformer.resblocks.0."
    w = tsf_sd[blk + "timeattn.in_proj_weight"]
    assert abs(w.std().item() - 0.02) < 0.002 and w.shape == (3 * WIDTH, WIDTH)
    assert not tsf_sd[blk + "temporal_fc.weight"].any()
    torch.testing.assert_close(tsf_sd[blk + "ln_time.weight"], torch.ones(WIDTH))
    frame = torch.from_numpy(
        np.random.default_rng(0).normal(size=(2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        want = clip.model.visual(frame)
        got = tower.eval()(frame[:, None].expand(2, NFRAMES, 3, 32, 32))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_create_video_model_is_seeded_with_the_reference_init():
    kw = dict(model_type=TINY, seed=3, device="cpu", nframes=NFRAMES)
    a = create_model("PretrainedCLIP_TimeSformer_finaltf", **kw)
    b = create_model("PretrainedCLIP_TimeSformer_finaltf", **kw)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, atol=0, rtol=0, msg=k)
    visual = a.model.visual
    assert not visual.temporal_embed.any()
    for block in visual.transformer.resblocks:
        assert not block.temporal_fc.weight.any() and not block.temporal_fc.bias.any()
        torch.testing.assert_close(block.ln_time.weight, torch.ones(WIDTH))
        assert 0.015 < block.timeattn.in_proj_weight.std().item() < 0.025
    assert not a.final_linear.weight.any()  # the CAM's zero-init
    assert not a.final_transformer.resblocks[0].attn.out_proj.weight.any()
    plain = create_model("PretrainedCLIP_TimeSformer", **kw)
    assert not hasattr(plain, "final_transformer")
    convert_weights(a)
    assert visual.temporal_embed.dtype == torch.float32
    assert visual.conv1.weight.dtype == torch.bfloat16


def test_video_config_builds_the_model_with_the_ports_jsonc():
    """The port's JSONC reader reads every config as the JAX package's does,
    and the video config's ``arch`` block builds the port's model."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    for path in sorted((root / "configs").glob("*.jsonc")):
        assert jsonc.read_json(path) == jax_jsonc.read_json(path), path.name
    arch = jsonc.read_json(root / CONFIG)["arch"]
    args = dict(arch["args"], model_type=TINY)
    model = create_model(arch["type"], device="cpu", nframes=NFRAMES, **args)
    assert isinstance(model, PretrainedCLIP_TimeSformer_finaltf)
    assert model.branch_to_adapt_val == "text" and model.init_from_avg
    vis, title, comments = _video_inputs(batch=2, seed=9)
    with torch.no_grad():
        fv, ft, sim = model(*(torch.from_numpy(a) for a in (vis, title, comments)))
    assert fv.shape == ft.shape == (2, 32) and sim.shape == (2, 2)
    assert bool(torch.isfinite(sim).all())
