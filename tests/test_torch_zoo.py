"""The rest of the model zoo in the port against the JAX package, on the CPU:
``TorchBatchNorm``, the feature baselines ``MLP``/``JointEmbedding``/``CLIP``,
the audio-MLP fusion of ``PretrainedCLIP_finaltf``, R(2+1)D-34, GDT's
ResNet-9, the log spectrograms and ``VideoDatasetFirst32``/``First1800``.
The MoE adapter is in tests/test_torch_expert.py.

The same numpy-seeded inputs go through both packages; the JAX weights are
carried across by ``state_dict_from_jax``/``plain_state_dict_from_jax`` or by
the published-layout importers (a seeded torchvision ``r2plus1d_34`` state
dict through ``import_ig65m_weights``, a GDT one through
``import_gdt_audio_weights``). ``torch.Generator`` cannot reproduce
``jax.random``, so the port is fed JAX's dropout masks, read from the
captured output of JAX's ``nn.Dropout`` (a kept entry of a nonzero input is
nonzero), and its adapter skip, read from its output.

Tolerances: 2e-5 in fp32 (tests/test_pallas_attention.py), 1e-4 relative
for conv sums, 1e-6 for the spectrograms, atol 0 for decoded frames. Torch
runs on one thread.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from vtc_tpu.audio import resnet9 as jax_resnet9
from vtc_tpu.audio import spectrogram as jax_spec
from vtc_tpu.models import layers as jax_layers
from vtc_tpu.models import r2plus1d as jax_r21d
from vtc_tpu.models import retrieval as jax_retrieval
from vtc_tpu.ops import losses as jax_losses
from vtc_tpu_torch.audio import AudioResNet9, load_gdt_state_dict, spectrogram
from vtc_tpu_torch.data import extract_patches, synthetic_tokens
from vtc_tpu_torch.models import (
    create_model,
    plain_state_dict_from_jax,
    r2plus1d,
    retrieval,
    state_dict_from_jax,
)
from vtc_tpu_torch.models.layers import TorchBatchNorm
from vtc_tpu_torch.ops import losses
from vtc_tpu_torch.training import train_step

TINY = "test-tiny"
ATOL, RTOL = 2e-5, 1e-4
SIM_ATOL = 3e-4  # exp(logit_scale) ≈ 14.3 times ATOL (tests/test_torch_training.py)
CONV_RTOL = 1e-4


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


def _close(ours, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(_np(ours), _np(ref), atol=atol, rtol=rtol)


def _dropout_masks(intermediates):
    """The keep masks of every captured ``nn.Dropout`` call, in call order."""
    masks = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                if k.startswith("Dropout"):
                    masks.extend(np.asarray(o) != 0 for o in node[k]["__call__"])
                else:
                    walk(node[k])

    walk(intermediates)
    return masks


def _capture_dropout(module, path):
    return isinstance(module, fnn.Dropout)


# ---- TorchBatchNorm -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 6), (3, 6, 2, 3, 4)], ids=["1d", "3d"])
def test_torch_batchnorm_matches_jax(shape):
    """Train outputs and the running stats over 3 updates (torch's momentum
    0.1 is flax's 0.9; the unbiased variance updates the running one), then
    eval from the running stats; channels on dim 1 in the port, last in JAX."""
    rng = np.random.default_rng(0)
    d = shape[1]
    params = {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32),
              "bias": rng.normal(0, 0.1, d).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.1, d).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, d).astype(np.float32)}
    jbn = jax_layers.TorchBatchNorm(use_running_average=False, momentum=0.9)
    bn = TorchBatchNorm(d)
    bn.load_state_dict({k: torch.as_tensor(v) for k, v in jax_layers_bn_state(
        params, stats).items()})
    bn.train()

    def last(x):  # channels last, for JAX
        return np.moveaxis(x, 1, -1)

    for step in range(3):
        x = rng.normal(1.0, 2.0, shape).astype(np.float32)
        ref, new = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(last(x)),
                             mutable=["batch_stats"])
        stats = _np_tree(new["batch_stats"])
        _close(last(_np(bn(torch.from_numpy(x)))), ref)
    _close(bn.running_mean, stats["mean"], atol=1e-6)
    _close(bn.running_var, stats["var"], atol=1e-6)
    assert int(bn.num_batches_tracked) == 3
    x = rng.normal(size=shape).astype(np.float32)
    ref = jax_layers.TorchBatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(last(x)))
    _close(last(_np(bn.eval()(torch.from_numpy(x)))), ref)


def jax_layers_bn_state(params, stats):
    from vtc_tpu_torch.models.layers import bn_state_from_jax

    return bn_state_from_jax(params["scale"], params["bias"], stats["mean"], stats["var"])


# ---- the feature baselines --------------------------------------------------------

def _perturbed_stats(stats, seed):
    rng = np.random.default_rng(seed)

    def f(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.normal(0, 0.1, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, _np_tree(stats))


BASELINES = {
    "MLP": (dict(num_classes=24, num_features=40), [(6, 40)]),
    "JointEmbedding": (dict(input_dims_a=40, input_dims_b=24, embedding_dims=16),
                       [(6, 40), (6, 24)]),
    "CLIP": (dict(input_dims_a=40, input_dims_b=24, embedding_dims=16),
             [(6, 40), (6, 24)]),
}


@pytest.mark.parametrize("arch", sorted(BASELINES))
def test_baseline_matches_jax(arch):
    """Training forward (the dropout mask JAX drew fed to the port) with the
    BatchNorm stats it leaves, then eval, against the flax module; and the
    factory builds the arch on the CPU."""
    kwargs, shapes = BASELINES[arch]
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jm = getattr(jax_retrieval, arch)(**kwargs)
    variables = jm.init(jax.random.PRNGKey(0), *[jnp.asarray(x) for x in xs])
    params = _np_tree(variables["params"])
    if arch == "CLIP":
        params["temperature"] = np.float32(2.5)
    stats = _perturbed_stats(variables["batch_stats"], 2)
    port = getattr(retrieval, arch)(**kwargs)
    port.load_state_dict(plain_state_dict_from_jax(params, stats), strict=True)

    ref, new = jm.apply({"params": params, "batch_stats": stats}, *map(jnp.asarray, xs),
                        train=True, rngs={"dropout": jax.random.PRNGKey(5)},
                        mutable=["batch_stats", "intermediates"],
                        capture_intermediates=_capture_dropout)
    masks = _dropout_masks(new.get("intermediates", {}))
    draws = {"dropout": torch.from_numpy(masks[0])} if arch == "MLP" else None
    if arch == "MLP":
        assert len(masks) == 1 and 0 < masks[0].mean() < 1
    ours = port.train()(*map(torch.from_numpy, xs), draws=draws)
    for o, r in zip(ours if arch != "MLP" else [ours], ref if arch != "MLP" else [ref]):
        _close(o, r, rtol=RTOL)
    want = plain_state_dict_from_jax(params, _np_tree(new["batch_stats"]))
    for name, buf in port.named_buffers():
        if not name.endswith("num_batches_tracked"):
            _close(buf, want[name], atol=1e-6)

    ref = jm.apply({"params": params, "batch_stats": stats}, *map(jnp.asarray, xs))
    port.load_state_dict(plain_state_dict_from_jax(params, stats), strict=True)
    ours = port.eval()(*map(torch.from_numpy, xs))
    for o, r in zip(ours if arch != "MLP" else [ours], ref if arch != "MLP" else [ref]):
        _close(o, r, rtol=RTOL)
    model = create_model(arch, device="cpu", seed=1, **kwargs)
    assert sorted(model.state_dict()) == sorted(port.state_dict())


# ---- the audio-MLP fusion ----------------------------------------------------------

@pytest.fixture(scope="module")
def audio_flagship():
    """(params, batch_stats) of the test-tiny flagship with the audio MLP,
    as configs/pretrained_clip_comments_attention_audio.jsonc builds it, the
    CAM and the audio MLP moved off their init."""
    from vtc_tpu.models import create_model as jax_create_model

    _, variables = jax_create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=0,
                                    init_audio_model=True)
    params = _np_tree(variables["params"])
    rng = np.random.default_rng(0)
    for key in ("cam", "audio_mlp"):
        params[key] = jax.tree_util.tree_map(
            lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), params[key])
    return params, _perturbed_stats(variables["batch_stats"], 3)


def _audio_inputs(batch=6, seed=0):
    rng = np.random.default_rng(seed)
    vis = extract_patches(rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8), 8)
    title = synthetic_tokens((batch,), 16, 14, rng)
    comments = synthetic_tokens((batch, 5), 16, 14, rng)
    comments[0, 4] = 0
    comments[0, 4, :2] = (49406, 49407)
    audio = rng.normal(size=(batch, 5, 512)).astype(np.float32)
    return vis, title, comments, audio


def _rngs(seed):
    rng = jax.random.PRNGKey(seed)
    return {"adapter_skip": jax.random.fold_in(rng, 1),
            "comment_mask": jax.random.fold_in(rng, 2),
            "dropout": jax.random.fold_in(rng, 3)}


def _audio_port(params, stats, **kwargs):
    port = retrieval.PretrainedCLIP_finaltf(model_type=TINY, init_audio_model=True,
                                            **kwargs)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return port


def test_audio_state_dict_names_are_the_reference_export(audio_flagship):
    """``state_dict_from_jax`` of the audio model equals
    ``torch_export.export_vtc_state_dict`` key for key and value for value,
    and the port's module carries exactly those names."""
    from vtc_tpu.models.torch_export import export_vtc_state_dict

    params, stats = audio_flagship
    ours = state_dict_from_jax(params, stats)
    ref = export_vtc_state_dict(params, stats)
    assert sorted(ours) == sorted(ref)
    assert {k for k in ref if k.startswith("audio_model.")} == {
        f"audio_model.mlp.layers.{i}.{leaf}" for i in (1, 4) for leaf in ("weight", "bias")
    } | {f"audio_model.mlp.layers.2.{leaf}" for leaf in (
        "weight", "bias", "running_mean", "running_var", "num_batches_tracked")}
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    _audio_port(params, stats)


@pytest.mark.parametrize("masking", [False, True])
def test_audio_fusion_matches_jax(audio_flagship, masking):
    """Eval forward, then the training forward (JAX's five dropout masks, its
    adapter skip and, with ``random_comment_masking``, its comment mask over
    the 5 comments and 5 clips fed to the port) with the BatchNorm running
    stats after the five sequential updates."""
    params, stats = audio_flagship
    kw = dict(random_comment_masking=masking)
    jm = jax_retrieval.PretrainedCLIP_finaltf(model_type=TINY, init_audio_model=True, **kw)
    data = _audio_inputs()
    jdata = [jnp.asarray(a) for a in data]
    variables = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})
    port = _audio_port(params, stats, **kw)

    ref = jm.apply(variables, *jdata)
    ours = port.eval()(*map(torch.from_numpy, data))
    for o, r, atol in zip(ours, ref, (ATOL, ATOL, SIM_ATOL)):
        _close(o, r, atol=atol, rtol=RTOL)

    rngs = _rngs(4)
    ref, new = jm.apply(variables, *jdata, train=True, rngs=rngs,
                        mutable=["batch_stats", "intermediates"],
                        capture_intermediates=_capture_dropout)
    masks = _dropout_masks(new["intermediates"])
    assert len(masks) == 5
    title = jm.apply(variables, *jdata, branch_override="skip")[1]
    skip = np.abs(np.asarray(ref[1]) - np.asarray(title)).max(-1) < 1e-4
    draws = {"dropout": torch.from_numpy(np.stack(masks)),
             "adapter_skip": torch.from_numpy(skip[:, None])}
    if masking:
        feats = np.full((10, 6, 32), 3.0, np.float32)
        keep = np.asarray(jm.apply(variables, jnp.asarray(feats), rngs=rngs,
                                   method=lambda m, f: m.cam.random_mask_comments(f)))
        draws["comment_mask"] = torch.from_numpy(np.all(keep == feats, -1, keepdims=True))
    ours = port.train()(*map(torch.from_numpy, data), draws=draws)
    for o, r, atol in zip(ours, ref, (ATOL, ATOL, SIM_ATOL)):
        _close(o, r, atol=atol, rtol=RTOL)
    bn = port.audio_model.mlp.layers[2]
    want = new["batch_stats"]["audio_mlp"]["bn"]
    _close(bn.running_mean, want["mean"], atol=1e-6)
    _close(bn.running_var, want["var"], atol=1e-6)
    assert int(bn.num_batches_tracked) == 5  # one update per clip


def test_audio_train_step_matches_jax(audio_flagship):
    """One ``train_step`` of the audio model against ``make_step_fns``' (SGD
    at lr 1, so the update is the gradient): the loss, every parameter's
    gradient and the audio MLP's BatchNorm stats."""
    import optax

    from vtc_tpu.training.trainer import TrainState, make_step_fns

    params, stats = audio_flagship
    jm = jax_retrieval.PretrainedCLIP_finaltf(model_type=TINY, init_audio_model=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = optax.sgd(1.0)
    jax_step, jax_eval = make_step_fns(jm, jax_losses.clip_loss, tx, donate=False)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams), batch_stats=stats)
    data = _audio_inputs(seed=1)
    jdata = tuple(jnp.asarray(a) for a in data)
    title = jax_eval(state, jdata, {}, branch_override="skip")[1][1]
    key = jax.random.PRNGKey(3)
    _, new = jm.apply({"params": jparams, "batch_stats": stats}, *jdata, train=True,
                      rngs={n: jax.random.fold_in(key, i) for i, n in
                            ((1, "adapter_skip"), (2, "comment_mask"), (3, "dropout"))},
                      mutable=["batch_stats", "intermediates"],
                      capture_intermediates=_capture_dropout)
    masks = np.stack(_dropout_masks(new["intermediates"]))
    new_state, loss_j, out_j = jax_step(state, jdata, {}, key)
    skip = np.abs(np.asarray(out_j[1]) - np.asarray(title)).max(-1) < 1e-4

    port = _audio_port(params, stats)
    optimizer = torch.optim.SGD(port.parameters(), lr=1.0)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: 1.0)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    loss, _ = train_step(port, losses.clip_loss, optimizer, scheduler,
                         [torch.from_numpy(a) for a in data], {},
                         draws={"dropout": torch.from_numpy(masks),
                                "adapter_skip": torch.from_numpy(skip[:, None])})
    _close(loss, loss_j, atol=1e-5)
    grads_j = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), params,
                                     _np_tree(new_state.params))
    ref = state_dict_from_jax(grads_j)
    for name, p in port.named_parameters():
        g = before[name] - p.detach()
        scale = max(1.0, float(ref[name].abs().max()))
        np.testing.assert_allclose(_np(g), _np(ref[name]), atol=ATOL * scale, rtol=RTOL,
                                   err_msg=name)
    bn = port.audio_model.mlp.layers[2]
    want = new_state.batch_stats["audio_mlp"]["bn"]
    _close(bn.running_mean, want["mean"], atol=1e-6)
    _close(bn.running_var, want["var"], atol=1e-6)


def test_accumulating_step_refuses_the_audio_mlp_batchnorm(audio_flagship):
    params, stats = audio_flagship
    port = _audio_port(params, stats)
    optimizer = torch.optim.SGD(port.parameters(), lr=1.0)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: 1.0)
    with pytest.raises(ValueError, match="BatchNorm running stats"):
        train_step(port, losses.clip_loss, optimizer, scheduler,
                   [torch.from_numpy(a) for a in _audio_inputs()], accum_steps=2)


# ---- R(2+1)D-34 --------------------------------------------------------------------

def _conv(k):
    """flax DHWIO -> torch OIDHW."""
    return np.asarray(k, np.float32).transpose(4, 3, 0, 1, 2)


def _block_state(p, s):
    """A flax ``R2Plus1dBlock``'s params/batch_stats -> torchvision names."""
    from vtc_tpu_torch.models.layers import bn_state_from_jax

    sd = {}

    def bn(dst, pp, ss):
        for k, v in bn_state_from_jax(pp["scale"], pp["bias"], ss["mean"], ss["var"]).items():
            sd[f"{dst}.{k}"] = v

    for i, ci in ((1, "conv1"), (2, "conv2")):
        sd[f"{ci}.0.0.weight"] = _conv(p[ci]["conv_s"]["kernel"])
        bn(f"{ci}.0.1", p[ci]["bn_s"], s[ci]["bn_s"])
        sd[f"{ci}.0.3.weight"] = _conv(p[ci]["conv_t"]["kernel"])
        bn(f"{ci}.1", p[f"bn{i}"], s[f"bn{i}"])
    if "downsample_conv" in p:
        sd["downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
        bn("downsample.1", p["downsample_bn"], s["downsample_bn"])
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("cin,cout,stride", [(16, 16, 1), (16, 24, 2)],
                         ids=["plain", "transition"])
def test_r2plus1d_block_matches_jax(cin, cout, stride):
    """A plain block and a transition block (stride 2, a downsample, conv2 on
    the block's midplanes) at small widths, eval and training."""
    rng = np.random.default_rng(cin + cout)
    x = rng.normal(size=(2, cin, 4, 6, 6)).astype(np.float32)  # NCDHW
    jblk = jax_r21d.R2Plus1dBlock(cout, (stride,) * 3)
    xl = jnp.asarray(np.moveaxis(x, 1, -1))
    variables = jblk.init(jax.random.PRNGKey(0), xl)
    params, stats = _np_tree(variables["params"]), _perturbed_stats(
        variables["batch_stats"], 4)
    blk = r2plus1d.BasicBlock(cin, cout, stride)
    blk.load_state_dict(_block_state(params, stats), strict=True)
    mid = r2plus1d._midplanes(cin, cout)
    assert blk.conv2[0][0].weight.shape[:2] == (mid, cout)  # the block's midplanes
    ref = jblk.apply({"params": params, "batch_stats": stats}, xl)
    _close(np.moveaxis(_np(blk.eval()(torch.from_numpy(x))), 1, -1), ref,
           atol=ATOL, rtol=CONV_RTOL)
    ref, new = jblk.apply({"params": params, "batch_stats": stats}, xl, train=True,
                          mutable=["batch_stats"])
    _close(np.moveaxis(_np(blk.train()(torch.from_numpy(x))), 1, -1), ref,
           atol=ATOL, rtol=CONV_RTOL)
    want = _block_state(params, _np_tree(new["batch_stats"]))
    for name, buf in blk.named_buffers():
        if not name.endswith("num_batches_tracked"):
            _close(buf, want[name], atol=1e-6)


def _torchvision_r2plus1d_34(seed=0):
    """A seeded state dict in torchvision's ``r2plus1d_34`` layout (the
    classifier ``fc`` included), running stats off their init."""
    rng = np.random.default_rng(seed)
    sd = {}

    def w(*shape):
        fan_in = np.prod(shape[1:])
        return (rng.standard_normal(shape, np.float32) * fan_in ** -0.5).astype(np.float32)

    def bn(n, prefix):
        sd[f"{prefix}.weight"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
        sd[f"{prefix}.bias"] = rng.normal(0, 0.05, n).astype(np.float32)
        sd[f"{prefix}.running_mean"] = rng.normal(0, 0.05, n).astype(np.float32)
        sd[f"{prefix}.running_var"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(7, np.int64)

    sd["stem.0.weight"] = w(45, 3, 1, 7, 7)
    bn(45, "stem.1")
    sd["stem.3.weight"] = w(64, 45, 3, 1, 1)
    bn(64, "stem.4")
    inplanes = 64
    for li, (n, p) in enumerate(zip(r2plus1d.LAYERS, r2plus1d.WIDTHS)):
        for bi in range(n):
            i = inplanes if bi == 0 else p
            m = r2plus1d._midplanes(i, p)
            t = f"layer{li + 1}.{bi}"
            for ci, c in (("conv1", i), ("conv2", p)):
                sd[f"{t}.{ci}.0.0.weight"] = w(m, c, 1, 3, 3)
                bn(m, f"{t}.{ci}.0.1")
                sd[f"{t}.{ci}.0.3.weight"] = w(p, m, 3, 1, 1)
                bn(p, f"{t}.{ci}.1")
            if li > 0 and bi == 0:
                sd[f"{t}.downsample.0.weight"] = w(p, i, 1, 1, 1)
                bn(p, f"{t}.downsample.1")
        inplanes = p
    sd["fc.weight"] = w(359, 512)
    sd["fc.bias"] = np.zeros(359, np.float32)
    return sd


@pytest.mark.parametrize("pool", ["mean", "max"])
def test_r2plus1d_34_full_depth_matches_jax(pool):
    """Full depth on a 4 x 16² clip: the seeded torchvision state dict loads
    strictly into the port (``load_ig65m_state_dict``) and through
    ``import_ig65m_weights`` into the JAX module; the pooled features agree
    at 1e-4, with mean and with max pooling."""
    sd = _torchvision_r2plus1d_34()
    imported = jax_r21d.import_ig65m_weights(sd)
    jm = jax_r21d.R2Plus1D_34_IG65M_32frames(pool_spatial=pool, pool_temporal=pool)
    x = np.random.default_rng(1).normal(size=(2, 3, 4, 16, 16)).astype(np.float32)
    ref = jax.jit(jm.apply)(imported, jnp.asarray(x))
    port = r2plus1d.R2Plus1D_34_IG65M_32frames(pool_spatial=pool, pool_temporal=pool)
    r2plus1d.load_ig65m_state_dict(port, sd)
    ours = port.eval()(torch.from_numpy(x))
    assert ours.shape == (2, 512)
    scale = float(np.abs(np.asarray(ref)).max())
    _close(ours, ref, atol=CONV_RTOL * scale, rtol=CONV_RTOL)
    model = create_model("R2Plus1D_34_IG65M_32frames", device="cpu")
    assert sorted(model.state_dict()) == sorted(k for k in sd if not k.startswith("fc."))


# ---- the audio tower and its spectrograms -------------------------------------------

def _gdt_state_dict(seed=0):
    """A GDT checkpoint's audio tower (``audio_network.base.*``), seeded,
    with running stats off their init, and a key of another network."""
    g = torch.Generator().manual_seed(seed)
    model = AudioResNet9()
    from vtc_tpu_torch.models.factory import init_plain

    init_plain(model, g)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_mean"):
            v = torch.randn(v.shape, generator=g) * 0.1
        elif k.endswith("running_var"):
            v = torch.rand(v.shape, generator=g) + 0.5
        elif k.endswith(".bias"):
            v = torch.randn(v.shape, generator=g) * 0.05
        sd[f"audio_network.{k}"] = v
    sd["video_network.base.stem.0.weight"] = torch.zeros(1)
    return sd


def test_audio_resnet9_matches_jax_through_gdt_import():
    sd = _gdt_state_dict()
    variables = jax_resnet9.import_gdt_audio_weights(sd)
    x = np.random.default_rng(2).normal(size=(2, 1, 257, 199)).astype(np.float32)
    ref = jax.jit(jax_resnet9.AudioResNet9().apply)(variables, jnp.asarray(x))
    port = AudioResNet9()
    load_gdt_state_dict(port, sd)
    ours = port.eval()(torch.from_numpy(x))
    assert ours.shape == (2, 512)
    scale = float(np.abs(np.asarray(ref)).max())
    _close(ours, ref, atol=CONV_RTOL * scale, rtol=CONV_RTOL)


@pytest.mark.parametrize("n", [48000, 60000, 10000, 400])
def test_spectrograms_match_jax(n):
    """``stft_magnitude`` and ``log_spectrogram`` (padded, cut, z-normalized)
    on seeded waveforms."""
    rng = np.random.default_rng(n)
    t = np.arange(n) / spectrogram.SAMPLE_RATE
    wav = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.normal(size=n)).astype(np.float32)
    _close(spectrogram.stft_magnitude(wav), jax_spec.stft_magnitude(wav), atol=1e-6)
    for z in (False, True):
        ours = spectrogram.log_spectrogram(wav, z_normalize=z)
        assert ours.shape == (1, 257, 199)
        _close(ours, jax_spec.log_spectrogram(wav, z_normalize=z), atol=1e-6)
    np.testing.assert_array_equal(spectrogram.FALLBACK, jax_spec.FALLBACK)
    assert spectrogram.TIME_POINTS == jax_spec.TIME_POINTS


# ---- the R(2+1)D datasets ---------------------------------------------------------

BASE36 = "0123456789abcdefghijklmnopqrstuvwxyz"
CLIP = Path(__file__).resolve().parent / "data" / "video" / "clip_160x120.mp4"


@pytest.fixture(scope="module")
def video_corpus(tmp_path_factory):
    """The committed mp4 under 8 base-36 ids (both splits), a CSV of them,
    a cached text-feature file, and one id whose file does not decode."""
    import pandas as pd

    tmp = tmp_path_factory.mktemp("first32")
    root = tmp / "videos"
    root.mkdir()
    names = [f"ab{c}" for c in "4589stu6"]
    for n in names[:-1]:
        shutil.copy(CLIP, root / f"{n}.mp4")
    (root / f"{names[-1]}.mp4").write_bytes(b"not a video")
    ids = [int(n, 36) for n in names]
    pd.DataFrame({"reddit_id": ids, "video_path": [f"results/{n}.mp4" for n in names],
                  "title": [f"video number {i}" for i in range(len(names))]}
                 ).to_csv(tmp / "posts.csv", index=False)
    rng = np.random.default_rng(0)
    np.savez(tmp / "text.npz", reddit_ids=np.asarray(ids, np.int64),
             embeddings=rng.normal(size=(len(ids), 16)).astype(np.float32))
    return tmp, root


def _same_items(ours, ref):
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        for a, b in zip(ours[i], ref[i]):
            if isinstance(b, dict):
                assert a == b
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("clip_preprocess", [False, True], ids=["ig65m", "clip"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_video_dataset_first32_matches_jax(video_corpus, monkeypatch, clip_preprocess,
                                           train):
    """Items equal (atol 0) to the JAX package's on its OpenCV route (PIL's
    transform for the CLIP preprocess, as tests/test_torch_video.py pins it),
    a file that does not decode included (zero frames)."""
    import vtc_tpu.data.datasets as jax_datasets
    from vtc_tpu.data import preprocess as jax_pre
    from vtc_tpu_torch.data import datasets

    monkeypatch.setenv("VTC_DECODE", "cv2")
    monkeypatch.setattr(jax_datasets, "clip_preprocess_batch", lambda frames: np.stack(
        [jax_pre.clip_preprocess(jax_pre.Image.fromarray(f)) for f in frames]))
    tmp, root = video_corpus
    kw = dict(csv_file=str(tmp / "posts.csv"), root=str(root), train=train,
              clip_preprocess=clip_preprocess,
              text_features=None if clip_preprocess else str(tmp / "text.npz"))
    ours = datasets.VideoDatasetFirst32(**kw)
    ref = jax_datasets.VideoDatasetFirst32(**kw)
    shape = (32, 3, 224, 224) if clip_preprocess else (3, 32, 128, 171)
    assert ours[0][0].shape == shape
    _same_items(ours, ref)


def test_video_dataset_first1800_matches_jax(video_corpus, monkeypatch):
    """Items equal (atol 0) to the JAX package's: 90 frames, short side 128,
    center crop 112, ig65m-normalized; a file that does not decode gives the
    32 zero frames."""
    import vtc_tpu.data.datasets as jax_datasets
    from vtc_tpu_torch.data import DataLoader, datasets

    monkeypatch.setenv("VTC_DECODE", "cv2")
    tmp, root = video_corpus
    for train in (True, False):
        kw = dict(csv_file=str(tmp / "posts.csv"), root=str(root), train=train)
        ours = datasets.VideoDatasetFirst1800(**kw)
        _same_items(ours, jax_datasets.VideoDatasetFirst1800(**kw))
    assert ours[0][0].shape[0] == 3 and ours[0][0].shape[2:] == (112, 112)
    val = datasets.VideoDatasetFirst1800(str(tmp / "posts.csv"), str(root), train=False)
    frames = {val[i][0].shape[1] for i in range(len(val))}
    assert frames == {32, 90}  # the broken file pads to 32; the clip has 90
    batch = next(iter(DataLoader(datasets.VideoDatasetFirst32(
        str(tmp / "posts.csv"), str(root), text_features=str(tmp / "text.npz")),
        batch_size=2, num_workers=0)))
    assert batch[0].shape == (2, 3, 32, 128, 171) and batch[1].shape == (2, 16)


def test_audio_embedding_script_on_the_committed_mp4(tmp_path):
    """The ``get_audio_embeddings`` twin on the CPU over the committed mp4
    (no audio stream, or no PyAV here: every clip the all-ones fallback,
    counted): the ``{reddit_ids, embeddings [N, 5, 512]}`` file, each row
    the tower's encoding of ``video_audio_clips``, which equal JAX's."""
    import pandas as pd

    from vtc_tpu_torch.scripts import get_audio_embeddings as script

    (tmp_path / "v").mkdir()
    names = ["ab8", "ab9"]
    for n in names:
        shutil.copy(CLIP, tmp_path / "v" / f"{n}.mp4")
    pd.DataFrame({"reddit_id": [int(n, 36) for n in names],
                  "video_path": [f"results/{n}.mp4" for n in names]}).to_csv(
        tmp_path / "p.csv", index=False)
    out = tmp_path / "audio.npz"
    emb, fallbacks = script.main(["--csv", str(tmp_path / "p.csv"), "--root",
                                  str(tmp_path / "v"), "--out", str(out), "--batch_size", "2",
                                  "--num_workers", "0", "--device", "cpu"])
    clips = spectrogram.video_audio_clips(str(tmp_path / "v" / "ab8.mp4"))
    np.testing.assert_array_equal(clips, jax_spec.video_audio_clips(
        str(tmp_path / "v" / "ab8.mp4")))
    assert fallbacks == int(spectrogram.is_fallback(clips).sum()) * 2
    saved = np.load(out)
    assert saved["embeddings"].shape == (2, 5, 512)
    np.testing.assert_array_equal(saved["reddit_ids"], [int(n, 36) for n in names])
    with torch.no_grad():
        ref = script.encode(script.build_tower(device="cpu"), torch.from_numpy(clips[None]))
    _close(emb[:1], ref, atol=1e-6)
