"""The port's three kernels (vtc_tpu_torch.ops) against the JAX Pallas
kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; here that version is
held against the JAX function with the Pallas kernel run in interpret mode,
as the JAX package's own tests run it. Tolerances: fp32 atol 2e-5 (the
repo's kernel tolerance, tests/test_pallas_attention.py); bf16 one bf16 ulp
at the output's scale (two for attention, where P is rounded to bf16 too).

The ``cuda``-marked tests hold each kernel against its plain version on the
card and skip without one. The card's machine has no JAX, so this module
imports the JAX package only inside the tests that compare with it; run the
card's tests there with
``python -m pytest tests/test_torch_ops.py -m cuda --noconftest``.
"""

import shutil

import numpy as np
import pytest
import torch

from vtc_tpu_torch import ops
from vtc_tpu_torch.ops import _build

FP32_ATOL = 2e-5
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def bf16_tol(ref, ulps=1):
    """``ulps`` bf16 ulps at the largest magnitude of ``ref`` (8 significant
    bits: the spacing below 2^(e+1) is 2^(e-7) <= |x|·2^-7)."""
    return ulps * 2.0**-7 * max(1.0, float(np.abs(ref).max()))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)  # a JAX array, bf16 included


def assert_close(ours, ref, dtype_name, ulps=1):
    ours, ref = _f32(ours), _f32(ref)
    atol = FP32_ATOL if dtype_name == "fp32" else bf16_tol(ref, ulps)
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


def both(x, dtype_name):
    """The same values as a torch tensor and a JAX array of the dtype (both
    round fp32 to bf16 to nearest even)."""
    import jax.numpy as jnp

    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    return torch.from_numpy(x).to(DTYPES[dtype_name]), jnp.asarray(x, jdt)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels build and run only there")
    return torch.device("cuda")


def _ln_inputs(d, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 8, d)) * 2 + 0.5).astype(np.float32)
    scale = rng.normal(1.0, 0.2, d).astype(np.float32)
    bias = rng.normal(0.0, 0.2, d).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [256, 768])
def test_layernorm_matches_pallas(monkeypatch, d, dtype_name):
    import jax.numpy as jnp

    from vtc_tpu.ops import pallas_layernorm

    monkeypatch.setattr(pallas_layernorm, "_INTERPRET", True)
    x, scale, bias = _ln_inputs(d)
    xt, xj = both(x, dtype_name)
    ref = pallas_layernorm.layernorm(xj, jnp.asarray(scale), jnp.asarray(bias))
    before = ops.layernorm.launches
    ours = ops.layernorm(xt, torch.from_numpy(scale), torch.from_numpy(bias))
    assert ours.dtype == xt.dtype and ours.shape == xt.shape
    assert ops.layernorm.launches == before  # the CPU runs no kernel
    assert_close(ours, ref, dtype_name)


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [256, 768])
def test_add_layernorm_matches_pallas(monkeypatch, d, dtype_name):
    import jax.numpy as jnp

    from vtc_tpu.ops import pallas_addln

    monkeypatch.setattr(pallas_addln, "_INTERPRET", True)
    a, scale, bias = _ln_inputs(d, 1)
    b = _ln_inputs(d, 2)[0]
    (at, aj), (bt, bj) = both(a, dtype_name), both(b, dtype_name)
    s_ref, y_ref = pallas_addln.add_layernorm(
        aj, bj, jnp.asarray(scale), jnp.asarray(bias)
    )
    s, y = ops.add_layernorm(at, bt, torch.from_numpy(scale), torch.from_numpy(bias))
    assert s.dtype == y.dtype == at.dtype
    assert_close(s, s_ref, dtype_name)
    assert_close(y, y_ref, dtype_name)


def test_add_layernorm_mixed_dtypes_follow_a():
    """The CAM in bf16 mode adds a bf16 branch to an fp32 residual stream:
    both outputs are fp32 and the sum is taken in fp32."""
    import jax.numpy as jnp

    from vtc_tpu.ops import pallas_addln

    a, scale, bias = _ln_inputs(512, 3)
    b = _ln_inputs(512, 4)[0]
    b16 = torch.from_numpy(b).to(torch.bfloat16)
    s_ref, y_ref = pallas_addln._xla_add_layernorm(
        jnp.asarray(a), jnp.asarray(b, jnp.bfloat16), jnp.asarray(scale),
        jnp.asarray(bias), 1e-5,
    )
    s, y = ops.add_layernorm(
        torch.from_numpy(a), b16, torch.from_numpy(scale), torch.from_numpy(bias)
    )
    assert s.dtype == y.dtype == torch.float32
    assert_close(s, s_ref, "fp32")
    assert_close(y, y_ref, "fp32")


def _qkv(b, l, e, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, l, e)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [6, 16, 50, 77])
def test_fused_mha_matches_pallas(l, causal, dtype_name):
    from vtc_tpu.ops.pallas_attention import fused_mha as jax_fused_mha

    e, h = 128, 2
    pairs = [both(x, dtype_name) for x in _qkv(3, l, e, l)]
    ref = jax_fused_mha(*[j for _, j in pairs], h, causal, None, 2, True)
    ours = ops.fused_mha(*[t for t, _ in pairs], h, causal)
    assert ours.dtype == pairs[0][0].dtype and ours.is_contiguous()
    assert_close(ours, ref, dtype_name, ulps=2)


def test_fused_mha_takes_strided_qkv_views():
    """q, k, v as the column slices of one merged qkv tensor (row stride 3E),
    as MultiHeadAttention hands them over, give the result of contiguous
    copies."""
    qkv = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 16, 3 * 64))
                           .astype(np.float32))
    q, k, v = qkv.chunk(3, dim=-1)
    assert q.stride(1) == 3 * 64
    out = ops.fused_mha(q, k, v, 4, True)
    ref = ops.fused_mha(q.contiguous(), k.contiguous(), v.contiguous(), 4, True)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_fused_mha_rejects_long_sequences():
    """``fused_mha`` no longer refuses L > 128, where the Pallas kernel
    stops: past it the JAX package runs XLA attention, with the math of the
    kernel's own reference (``_mha_reference``), and the port takes the
    long route. Parity at L = 129, causal, fp32."""
    from vtc_tpu.ops.pallas_attention import _mha_reference

    pairs = [both(x, "fp32") for x in _qkv(2, 129, 64, 129)]
    ref = _mha_reference(*[j for _, j in pairs], 4, True, 16**-0.5)
    assert_close(ops.fused_mha(*[t for t, _ in pairs], 4, True), ref, "fp32")


def test_long_route_launch_refuses_cpu_tensors():
    """The long route's launch takes CUDA tensors only; on the CPU
    ``fused_mha`` runs the plain version at any L."""
    q = torch.zeros(1, 129, 64)
    with pytest.raises(ValueError, match="cuda tensors"):
        ops.fused_mha_long(q, q, q, 4, False, 0.25)
    assert ops.fused_mha(q, q, q, 4).shape == q.shape


def test_backward_through_a_kernel_raises():
    """The LN sweep's designs take no gradient: a gradient through their
    launch fails loudly instead of being recomputed elsewhere. (The model
    path's kernels have their backward: tests/test_torch_training.py.)"""
    x = torch.ones(3, requires_grad=True)
    y = _build.forward_only("ln_mxu", lambda t: t * 2, x)
    with pytest.raises(NotImplementedError, match="ln_mxu has no backward: .*LN sweep"):
        y.sum().backward()
    with torch.no_grad():  # inference takes the launch as it is
        assert not _build.forward_only("ln_mxu", lambda t: t * 2, x).requires_grad


def test_header_edit_renames_both_libraries(tmp_path):
    """Every kernel source (the two attention kernels and ``ln_mxu``) includes
    ``csrc/short_attention.cuh``; ``jpeg_decode.cu`` (the nvJPEG binding)
    includes none. A library's name hashes every header beside its source,
    so an edit to the header alone renames (and so rebuilds) every library,
    and a stale build is never loaded. No GPU or nvcc needed: only the names
    are computed."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    sources = sorted(csrc.glob("*.cu"))
    assert [src.stem for src in sources] == ["fused_attention", "fused_mha",
                                             "jpeg_decode", "ln_mxu"]
    for src in sources:
        includes = '#include "short_attention.cuh"' in src.read_text()
        assert includes == (src.stem != "jpeg_decode"), src.name
        # the same files give the same name wherever they lie
        assert _build._lib_path(src, csrc) == _build._lib_path(
            _build.CSRC_DIR / src.name)
    before = [_build._lib_path(src, csrc) for src in sources]
    header = csrc / "short_attention.cuh"
    text = bytearray(header.read_bytes())
    text[text.index(b"Hopper")] = ord("h")  # one byte of a comment
    header.write_bytes(bytes(text))
    after = [_build._lib_path(src, csrc) for src in sources]
    assert all(a != b and a.stem.split("-")[0] == b.stem.split("-")[0]
               for a, b in zip(after, before))


def test_launch_counters_reset():
    ops.layernorm.launches = 3
    ops.reset_launch_counts()
    assert ops.launch_counts() == {
        "layernorm": 0, "add_layernorm": 0, "fused_mha": 0, "fused_attention": 0,
        "ln_mxu": 0, "ln_mxu_bf16": 0, "fused_mha_long": 0,
    }


# ---- on the card: each kernel against its plain version -------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("rows,d", [(8000, 768), (15360, 512), (960, 512), (7, 100)])
def test_layernorm_kernels_on_card(cuda, rows, d, dtype_name):
    tdt = DTYPES[dtype_name]
    x, scale, bias = _ln_inputs(d, rows)
    x = torch.from_numpy(np.resize(x, (rows, d))).to(cuda, tdt)
    b = torch.roll(x, 1, 0)
    scale, bias = torch.from_numpy(scale).to(cuda), torch.from_numpy(bias).to(cuda)
    n = ops.layernorm.launches
    y = ops.layernorm(x, scale, bias)
    s2, y2 = ops.add_layernorm(x, b, scale, bias)
    torch.cuda.synchronize()
    assert ops.layernorm.launches == n + 1
    for ours, ref in ((y, ops.layernorm_plain(x, scale, bias)),
                      *zip((s2, y2), ops.add_layernorm_plain(x, b, scale, bias))):
        assert_close(ours, ref, dtype_name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("b,l,e,h,causal", [
    (160, 50, 768, 12, False), (960, 16, 512, 8, True), (160, 6, 512, 8, False),
    (4, 128, 256, 2, True),
    # the tile's edges: one key, a ragged 16-row tile, 77 and 128 keys
    (32, 1, 128, 2, False), (32, 7, 128, 2, True), (24, 77, 512, 8, True),
    (4, 128, 256, 2, False),
    # Dh = 40: padded to 48 columns; Dh = 20: rows of 40 bytes in bf16, not
    # 16-byte aligned, so the kernel takes its element-load path
    (12, 50, 80, 2, False), (12, 50, 40, 2, True),
])
def test_fused_mha_kernel_on_card(cuda, b, l, e, h, causal, dtype_name):
    tdt = DTYPES[dtype_name]
    qkv = torch.randn(b, l, 3 * e, generator=torch.Generator().manual_seed(l))
    q, k, v = qkv.to(cuda, tdt).chunk(3, dim=-1)
    n = ops.fused_mha.launches
    out = ops.fused_mha(q, k, v, h, causal)
    torch.cuda.synchronize()
    assert ops.fused_mha.launches == n + 1
    assert_close(out, ops.fused_mha_plain(q, k, v, h, causal), dtype_name, ulps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("b,l,e,h,causal", [
    # ViT-B/16 and ViT-L/14 heads; one key past the tile, a ragged last tile
    (4, 197, 768, 12, False), (2, 257, 1024, 16, False), (3, 129, 256, 4, True),
    (2, 393, 512, 8, True),
    # Dh = 128 (the larger register bucket); Dh = 20: element loads in bf16
    (2, 200, 256, 2, False), (2, 150, 40, 2, True),
])
def test_fused_mha_long_kernel_on_card(cuda, b, l, e, h, causal, dtype_name):
    """Past L = 128 ``fused_mha`` launches the long route, not the short
    tile: strided q/k/v views of one qkv tensor against the plain version."""
    tdt = DTYPES[dtype_name]
    qkv = torch.randn(b, l, 3 * e, generator=torch.Generator().manual_seed(l))
    q, k, v = qkv.to(cuda, tdt).chunk(3, dim=-1)
    n_short, n_long = ops.fused_mha.launches, ops.fused_mha_long.launches
    out = ops.fused_mha(q, k, v, h, causal)
    torch.cuda.synchronize()
    assert (ops.fused_mha.launches, ops.fused_mha_long.launches) == (n_short, n_long + 1)
    assert_close(out, ops.fused_mha_plain(q, k, v, h, causal), dtype_name, ulps=2)


@pytest.mark.cuda
def test_backward_through_cuda_kernel_raises(cuda):
    """On the card the sweep's designs refuse a backward; the model path's
    ``layernorm`` takes one, the backward of ``layernorm_plain``."""
    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    for fn in (ops.ln_mxu, ops.ln_mxu_bf16):
        with pytest.raises(NotImplementedError, match="LN sweep"):
            fn(x.to(torch.bfloat16), w, b).float().sum().backward()
    w.requires_grad_()
    g = torch.randn(4, 64, device=cuda)
    ours = torch.autograd.grad(ops.layernorm(x, w, b), (x, w), g)
    ref = torch.autograd.grad(ops.layernorm_plain(x, w, b), (x, w), g)
    for o, r in zip(ours, ref):
        assert_close(o, r, "fp32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_attention_backward_on_card(cuda, dtype_name):
    """``fused_mha`` (strided qkv views, causal) and ``fused_attention``
    (4-D head views, additive mask) take a gradient on the card: their
    backward against autograd of the plain version, two ulps in bf16."""
    tdt = DTYPES[dtype_name]
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(8, 16, 3 * 512, generator=gen).to(cuda, tdt).requires_grad_()
    g = torch.randn(8, 16, 512, generator=gen).to(cuda, tdt)
    for fn, plain in (
        (lambda t: ops.fused_mha(*t.chunk(3, -1), 8, True),
         lambda t: ops.fused_mha_plain(*t.chunk(3, -1), 8, True, 64**-0.5)),
        (lambda t: _heads_attention(ops.fused_attention, t),
         lambda t: _heads_attention(ops.fused_attention_plain, t)),
    ):
        (ours,) = torch.autograd.grad(fn(qkv), qkv, g)
        (ref,) = torch.autograd.grad(plain(qkv), qkv, g)
        assert_close(ours, ref, dtype_name, ulps=2)


def _heads_attention(fn, qkv):
    b, l, e3 = qkv.shape
    mask = torch.randn(l, l, generator=torch.Generator().manual_seed(1)).to(qkv.device)
    q, k, v = (t.unflatten(-1, (8, -1)).transpose(1, 2) for t in qkv.chunk(3, -1))
    return fn(q, k, v, mask).transpose(1, 2).reshape(b, l, e3 // 3)
