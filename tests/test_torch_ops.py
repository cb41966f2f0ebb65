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
from vtc_tpu_torch.scripts import bench_long_variants

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


def test_cross_route_launch_refuses_cpu_tensors():
    """The cross route's launch takes CUDA tensors only; on the CPU
    ``fused_mha`` runs the plain version with fewer queries than keys."""
    q, k = torch.zeros(1, 1, 64), torch.zeros(1, 9, 64)
    with pytest.raises(ValueError, match="cuda tensors"):
        ops.fused_mha_cross(q, k, k, 4, 0.25)
    assert ops.fused_mha(q, k, k, 4).shape == q.shape


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,dh,dtype,want", [
    # the joint TimeSformer's CLS row at ViT-B/32, 8 frames: 2 CTAs of 197
    # keys, V in registers: K's rows of 128 bytes and in fp32 q, S (padded
    # to 200), 4 warps' and the CTA's (m, l), the inboxes of 2·2 statistics
    # and 2·32 outputs: 197·128 + 4·(64 + 200 + 8 + 2 + 4 + 64) = 26,584
    (1, 393, 64, torch.bfloat16, (2, 197, 128, 26584)),
    # fp32 keeps V in shared memory: 6 CTAs of 66 keys, rows of 256 bytes
    (1, 393, 64, torch.float32, (6, 66, 128, 34672)),
    # the edges: one key past the query; 16 queries over 17 keys (the 4
    # warps' 16·64 partial outputs, 16 KB, outgrow K's rows); Dh = 20 (rows
    # of 128 bytes); 16 queries over 393 keys; Dh = 128 (V in shared
    # memory) over 1,025 keys; past the 40 KB aim, 8 CTAs: 16 fp32 rows
    # over 1,100 keys
    (1, 2, 64, torch.bfloat16, (1, 2, 128, 1344)),
    (16, 17, 64, torch.bfloat16, (1, 17, 128, 22528)),
    (5, 9, 20, torch.float32, (1, 9, 128, 4832)),
    (16, 393, 64, torch.bfloat16, (3, 131, 128, 34440)),
    (1, 1025, 128, torch.bfloat16, (8, 129, 128, 67704)),
    (16, 1100, 128, torch.float32, (8, 138, 128, 168320)),
])
def test_cross_plan(cuda, lq, lk, dh, dtype, want):
    """The cross route's launch as the C entry reports it: the smallest
    cluster at which a CTA's shared memory is at most 40 KB, else 8 CTAs
    (``tests/test_torch_cross.py`` holds its Python copy to it)."""
    assert ops.cross_plan(lq, lk, dh, dtype) == want


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,dh,dtype,max_cluster,want", [
    # the joint TimeSformer's CLS row in one CTA (chip_smoke.py times it
    # beside the plan): 99 keys a warp put V in shared memory, 2·393·128 +
    # 4·(64 + 396 + 8 + 2 + 2) = 102,496
    (1, 393, 64, torch.bfloat16, 1, (1, 393, 128, 102496)),
    # fp32 at most 2 CTAs: 2 of 197 keys past the 40 KB aim
    (1, 393, 64, torch.float32, 2, (2, 197, 128, 102232)),
    # no cluster of at most 1 CTA holds 1,025 fp32 rows of Dh = 128
    (1, 1025, 128, torch.float32, 1, (0, 0, 0, 0)),
])
def test_cross_plan_at_a_smaller_cluster(cuda, lq, lk, dh, dtype, max_cluster, want):
    """The plan at a cap below 8 CTAs, as the C entry reports it: the
    smallest cluster under the cap at 40 KB a CTA, else the cap where it
    fits an SM, else no launch."""
    assert ops.cross_plan(lq, lk, dh, dtype, max_cluster) == want


@pytest.mark.cuda
def test_cross_plan_fits_an_sm_and_a_cluster(cuda):
    """Every plan for Lk <= 1,100, Lq <= 16 and Dh <= 128 fits an SM's 227
    KB and a portable cluster of at most 8 CTAs, and gives every CTA a key:
    every (Lq, Lk) at Dh on each side of the 128-byte row steps (and 20,
    100), every Dh at the lengths around a step of the cluster."""
    def check(lq, lk, dh, dtype):
        p = ops.cross_plan(lq, lk, dh, dtype)
        assert 1 <= p.cluster <= 8 and p.smem <= 232448, (lq, lk, dh, dtype)
        assert (p.cluster - 1) * p.keys < lk <= p.cluster * p.keys, (lq, lk, dh, dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for dh in (1, 20, 32, 33, 64, 65, 96, 97, 100, 127, 128):
            for lq in range(1, 17):
                for lk in range(lq + 1, 1101):
                    check(lq, lk, dh, dtype)
        for dh in range(1, 129):
            for lq in (1, 5, 16):
                for lk in (lq + 1, 197, 393, 394, 787, 1025, 1100):
                    check(lq, lk, dh, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("l,dh,dtype,want", [
    # ViT-B/16 and ViT-L/14: one block of 3 pairs of warps per (sequence,
    # head), K and V over the pairs' 2 × 8·T keys (L padded to 16); shared
    # rows of 144 bytes, 4,352 bytes of exchange a pair
    (197, 64, torch.bfloat16, (1, 13, 192, (2 * 208 + 48) * 144 + 3 * 4352)),
    (257, 64, torch.bfloat16, (1, 17, 192, (2 * 272 + 48) * 144 + 3 * 4352)),
    # the edges: the 13-tile bucket, the one-pass kernel's longest row and
    # the next, Dh = 20 (rows of Dh's 4 chunks), Dh = 128 (rows of 8 chunks,
    # O exchanged 64 columns at a time), fp32 at any L
    (208, 64, torch.bfloat16, (1, 13, 192, (2 * 208 + 48) * 144 + 3 * 4352)),
    (209, 64, torch.bfloat16, (1, 17, 192, (2 * 272 + 48) * 144 + 3 * 4352)),
    (240, 20, torch.bfloat16, (1, 17, 192, (2 * 272 + 48) * 144 + 3 * 4352)),
    (272, 128, torch.bfloat16, (1, 17, 192, (2 * 272 + 48) * 272 + 3 * 4352)),
    (273, 64, torch.bfloat16, (0, 0, 128, 320 * 144)),
    (393, 64, torch.bfloat16, (0, 0, 128, 320 * 144)),
    (197, 64, torch.float32, (0, 0, 128, 320 * 272)),
])
def test_long_plan(cuda, l, dh, dtype, want):
    """The long route's launch by L, as the C entry reports it: the one-pass
    kernel for bf16 up to L = 272, the two-pass kernel past it and in fp32;
    a row of shared memory is Dh padded to 16 (the one-pass kernel: to 64 or
    128) plus 16 bytes."""
    assert ops.long_plan(l, dh, dtype) == want


@pytest.mark.cuda
def test_long_plan_fits_an_sm(cuda):
    """Every launch the plan makes fits an SM's 227 KB of shared memory, and
    the one-pass kernel's pair of warps holds S for every key of the row
    (padded to 16) in its key tiles of 8."""
    for l in range(129, 400):
        for dh in range(1, 129):
            for dtype in (torch.float32, torch.bfloat16):
                p = ops.long_plan(l, dh, dtype)
                assert p.smem <= 232448, (l, dh, dtype)
                assert p.one_pass == (dtype == torch.bfloat16 and l <= 272), (l, dh, dtype)
                if p.one_pass:
                    assert 2 * 8 * p.key_tiles >= (l + 15) // 16 * 16


@pytest.mark.parametrize("name", list(bench_long_variants.VARIANTS))
def test_long_variants_patch_the_kernel(name):
    """Each variant of ``scripts/bench_long_variants.py`` finds the lines it
    replaces in ``csrc/long_attention.cuh``, once each, and changes the
    source (``kept`` alone leaves it as it is)."""
    text = (_build.CSRC_DIR / "long_attention.cuh").read_text()
    assert (bench_long_variants.patched(text, name) == text) == (name == "kept")


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
        "ln_mxu": 0, "ln_mxu_bf16": 0, "fused_mha_long": 0, "fused_mha_cross": 0,
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
    # the one-pass kernel (bf16): its longest row and the next (two passes),
    # the edge of its 13-tile bucket, last query tiles of 1 row (129, 193),
    # Dh = 128 and Dh = 20 in the 17-tile bucket, causal and not
    (2, 272, 512, 8, False), (2, 272, 512, 8, True), (2, 273, 512, 8, False),
    (2, 273, 512, 8, True), (3, 208, 256, 4, True), (3, 209, 256, 4, False),
    (3, 193, 768, 12, True), (3, 193, 768, 12, False), (2, 129, 256, 4, False),
    (2, 257, 256, 2, True), (2, 240, 40, 2, False),
])
def test_fused_mha_long_kernel_on_card(cuda, b, l, e, h, causal, dtype_name):
    """Past L = 128 ``fused_mha`` launches the long route, not the short
    tile: strided q/k/v views of one qkv tensor against the plain version,
    on the one-pass kernel (bf16, L <= 272) and the two-pass kernel."""
    tdt = DTYPES[dtype_name]
    qkv = torch.randn(b, l, 3 * e, generator=torch.Generator().manual_seed(l))
    q, k, v = qkv.to(cuda, tdt).chunk(3, dim=-1)
    n_short, n_long = ops.fused_mha.launches, ops.fused_mha_long.launches
    out = ops.fused_mha(q, k, v, h, causal)
    torch.cuda.synchronize()
    assert (ops.fused_mha.launches, ops.fused_mha_long.launches) == (n_short, n_long + 1)
    assert_close(out, ops.fused_mha_plain(q, k, v, h, causal), dtype_name, ulps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("dh", [64, 128, 20])
@pytest.mark.parametrize("lq,lk", [(1, 2), (5, 9), (16, 17), (16, 393), (1, 393), (1, 1025)])
def test_fused_mha_cross_kernel_on_card(cuda, lq, lk, dh, dtype_name):
    """Fewer queries than keys at Lq <= 16: ``fused_mha`` launches the
    cross route (counted on ``fused_mha_cross``, not the long route): q, k
    and v column views of one qkv tensor against the plain version, at Dh =
    64, 128 and 20 (rows of 40 bytes in bf16: element loads); two launches
    give the same bits."""
    tdt, h = DTYPES[dtype_name], 3
    qkv = torch.randn(2, lk, 3 * h * dh, generator=torch.Generator().manual_seed(lk))
    q, k, v = qkv.to(cuda, tdt).chunk(3, dim=-1)
    q = q[:, :lq]
    n_long, n_cross = ops.fused_mha_long.launches, ops.fused_mha_cross.launches
    out = ops.fused_mha(q, k, v, h)
    again = ops.fused_mha(q, k, v, h)
    torch.cuda.synchronize()
    assert (ops.fused_mha_long.launches, ops.fused_mha_cross.launches) == (n_long,
                                                                           n_cross + 2)
    assert torch.equal(out, again)
    assert_close(out, ops.fused_mha_plain(q, k, v, h), dtype_name, ulps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("lq,lk,dh", [(17, 393, 64), (17, 393, 20), (1, 4097, 128)])
def test_fused_mha_cross_leaves_the_rest_to_the_long_route(cuda, lq, lk, dh, dtype_name):
    """Fewer queries than keys where the cross route does not take them:
    more than 16 queries, or Lk past what 8 CTAs hold (1 query over 4,097
    keys of Dh = 128). ``fused_mha`` launches the long route's two-pass
    kernel (counted on ``fused_mha_long``, not the cross route), against
    the plain version."""
    tdt, h = DTYPES[dtype_name], 3
    if lq <= 16:
        assert ops.cross_plan(lq, lk, dh, tdt).cluster == 0
    qkv = torch.randn(2, lk, 3 * h * dh, generator=torch.Generator().manual_seed(lk + lq))
    q, k, v = qkv.to(cuda, tdt).chunk(3, dim=-1)
    q = q[:, :lq]
    n_long, n_cross = ops.fused_mha_long.launches, ops.fused_mha_cross.launches
    out = ops.fused_mha(q, k, v, h)
    torch.cuda.synchronize()
    assert (ops.fused_mha_long.launches, ops.fused_mha_cross.launches) == (n_long + 1,
                                                                           n_cross)
    assert_close(out, ops.fused_mha_plain(q, k, v, h), dtype_name, ulps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_fused_mha_cross_misaligned_views(cuda, dtype_name):
    """Views whose base is off 16 bytes (a qkv tensor sliced from its
    second column) take the element-wise loads, against the plain version."""
    tdt, h, dh, lk = DTYPES[dtype_name], 12, 64, 393
    e = h * dh
    qkv = torch.randn(3, lk, 3 * e + 1, generator=torch.Generator().manual_seed(5))
    q, k, v = qkv.to(cuda, tdt)[..., 1:].chunk(3, dim=-1)
    assert k.data_ptr() % 16
    out = ops.fused_mha(q[:, :1], k, v, h)
    assert_close(out, ops.fused_mha_plain(q[:, :1], k, v, h), dtype_name, ulps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("l,causal", [(1, False), (16, True), (100, False), (128, True)])
def test_long_route_takes_any_length(cuda, l, causal, dtype_name):
    """The long route's launch takes any L >= 1, as its C entry says, though
    ``fused_mha`` sends it only L > 128: at these lengths the one-pass
    kernel's second warp of each pair holds only padded keys."""
    tdt = DTYPES[dtype_name]
    qkv = torch.randn(3, l, 3 * 256, generator=torch.Generator().manual_seed(l))
    q, k, v = qkv.to(cuda, tdt).chunk(3, dim=-1)
    out = ops.fused_mha_long(q, k, v, 4, causal, 64**-0.5)
    torch.cuda.synchronize()
    assert_close(out, ops.fused_mha_plain(q, k, v, 4, causal), dtype_name, ulps=2)


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
