"""The LN sweep's designs (vtc_tpu_torch.ops.ln_designs) against the Pallas
kernel bodies of ``scripts/bench_ln_kernel.py``.

``make_pallas`` there has no ``interpret`` flag and cannot run on the CPU,
so each test runs ``mxu_kernel`` / ``mxu_bf16_kernel`` in its own
``pl.pallas_call(..., interpret=True)`` with ``make_pallas``'s BlockSpecs.
Tolerances, each with its reason:

* ``ln_mxu`` with fp32 rows: 2e-5, the repo's fp32 kernel tolerance. The
  sums are taken in another order, and ``E[x²] − E[x]²`` loses
  log2(E[x²]/var) bits to cancellation, under one bit for these rows (mean
  0.5, std 2);
* ``ln_mxu`` with bf16 rows, and ``ln_mxu_bf16``: one bf16 ulp at the
  output's largest magnitude. The sums' order moves the fp32 mean and rstd
  by an fp32 ulp, which can move a rounding to bf16 (of the output, or in
  ``ln_mxu_bf16`` of the mean and rstd) by one bf16 step.

The CPU also checks what the two CUDA kernels (``csrc/ln_mxu.cu``) rest on:
for ``ln_mxu`` the exact split of x and x·x into bf16 parts, for both a
PyTorch twin of their chunked sums against the plain version, their
shared-memory sizes and the wrappers' refusals, and ``ln_mxu_bf16``'s grid.
The ``cuda``-marked tests hold both kernels against the plain versions on
the card, also on row views, misaligned bases and parameters, small d
(their element paths) and ragged tiles, and ``ln_mxu_bf16`` also with one
block walking every tile; they skip without a card. Run them there with
``python -m pytest tests/test_torch_ln_designs.py -m cuda --noconftest``.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from vtc_tpu_torch import ops
from vtc_tpu_torch.ops import ln_designs
from vtc_tpu_torch.ops.ln_designs import (
    LN_MXU_BF16_CONFIG,
    LN_MXU_MAX_SMEM,
    ln_mxu_bf16_grid,
    ln_mxu_bf16_smem_bytes,
    ln_mxu_smem_bytes,
)
from vtc_tpu_torch.scripts.bench_ln_kernel import CONFIGS as SWEEP_CONFIGS

FP32_ATOL = 2e-5
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
BENCH_LN = Path(__file__).resolve().parent.parent / "scripts" / "bench_ln_kernel.py"


def _close(ours, ref, dtype_name):
    """fp32: FP32_ATOL; bf16: one bf16 ulp at the largest |ref|."""
    ours = ours.detach().float().cpu().numpy()
    ref = np.asarray(ref).astype(np.float32)
    atol = FP32_ATOL if dtype_name == "fp32" else 2.0**-7 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


def _rows(rows, d, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, d)) * 2 + 0.5).astype(np.float32)
    scale = rng.normal(1.0, 0.2, d).astype(np.float32)
    bias = rng.normal(0.0, 0.2, d).astype(np.float32)
    return x, scale, bias


@functools.lru_cache(maxsize=None)
def _bench_module():
    spec = importlib.util.spec_from_file_location("bench_ln_kernel", BENCH_LN)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pallas_body(name, x, scale, bias, block=8):
    """The JAX script's kernel body ``name`` under ``make_pallas``'s
    BlockSpecs, in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    rows, d = x.shape
    call = pl.pallas_call(
        functools.partial(getattr(_bench_module(), name), eps=1e-5),
        grid=(rows // block,),
        in_specs=[
            pl.BlockSpec((block, d), lambda i: (i, 0)),
            pl.BlockSpec((d,), lambda i: (0,)),
            pl.BlockSpec((d,), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((block, d), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, d), x.dtype),
        interpret=True,
    )
    return call(x, jnp.asarray(scale), jnp.asarray(bias))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels build and run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [256, 768])
def test_ln_mxu_matches_its_pallas_body(d, dtype_name):
    import jax.numpy as jnp

    x, scale, bias = _rows(32, d, seed=d)
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    ref = _pallas_body("mxu_kernel", jnp.asarray(x, jdt), scale, bias)
    before = ops.ln_mxu.launches
    ours = ops.ln_mxu(torch.from_numpy(x).to(DTYPES[dtype_name]),
                      torch.from_numpy(scale), torch.from_numpy(bias))
    assert ops.ln_mxu.launches == before  # the CPU runs no kernel
    assert ours.dtype == DTYPES[dtype_name]
    _close(ours, ref, dtype_name)


@pytest.mark.parametrize("d", [256, 768])
def test_ln_mxu_bf16_matches_its_pallas_body(d):
    import jax.numpy as jnp

    x, scale, bias = _rows(32, d, seed=d + 1)
    ref = _pallas_body("mxu_bf16_kernel", jnp.asarray(x, jnp.bfloat16), scale, bias)
    ours = ops.ln_mxu_bf16(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(scale), torch.from_numpy(bias))
    assert ours.dtype == torch.bfloat16
    _close(ours, ref, "bf16")


def test_ln_mxu_bf16_rounds_where_the_design_rounds():
    """The bf16 design's plain version rounds where the JAX body rounds: it
    equals the body bit for bit on these rows, and differs from the
    fp32-statistics LN by those roundings."""
    import jax.numpy as jnp

    x, scale, bias = _rows(32, 256, seed=7)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    ours = ops.ln_mxu_bf16(xt, st, bt).float()
    fp32_stats = ops.layernorm(xt, st, bt).float()
    ref = np.asarray(_pallas_body("mxu_bf16_kernel", jnp.asarray(x, jnp.bfloat16),
                                  scale, bias)).astype(np.float32)
    assert (ours - fp32_stats).abs().max().item() > 0
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_ln_designs_refuse_what_they_do_not_take():
    x = torch.zeros(32, 64)
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.ln_mxu_bf16(x, w, b)
    with pytest.raises(ValueError, match="power of two >= 16"):
        ops.ln_mxu(x, w, b, rows_per_program=8)


def test_sweep_needs_a_card(monkeypatch):
    from vtc_tpu_torch.scripts import bench_ln_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_ln_kernel.main(64, 256)
    names = {name for name, *_ in bench_ln_kernel.designs(768)}
    assert names == {"vpu", "mxu", "mxu_bf16"}


# ---- ln_mxu's CUDA kernel, as far as the CPU can check it ------------------

def _bf16_parts(v, n):
    """fp32 ``v`` as ``n`` bf16 parts, largest first: each part is ``v``
    less the parts before it, rounded to bf16 (the kernel's split2/split3)."""
    parts = []
    for _ in range(n):
        parts.append(v.to(torch.bfloat16))
        v = v - parts[-1].float()
    return parts


def _near_zero_and_extremes(d, seed):
    """Seeded fp32 rows [16, d] with 0, values near 0, ±1e±30 and values
    that need all 24 bits of fp32 in the first row."""
    x, _, _ = _rows(16, d, seed=seed)
    x[0, :10] = [0.0, 1e-30, -1e-30, 1e30, -1e30, 1e-12, -3e-8,
                 1 + 2.0**-23, -(2 - 2.0**-22), 0.1]
    return torch.from_numpy(x)


@pytest.mark.parametrize("d", [100, 768])
def test_ln_mxu_split_of_fp32_rows_is_exact(d):
    x = _near_zero_and_extremes(d, seed=d)
    h, m, l = _bf16_parts(x, 3)
    assert torch.equal(h.double() + m.double() + l.double(), x.double())
    # x·x as the kernel takes it: the fp32 product, where it is finite
    q = x * x
    q = torch.where(torch.isfinite(q), q, torch.zeros(()))
    h, m, l = _bf16_parts(q, 3)
    assert torch.equal(h.double() + m.double() + l.double(), q.double())


@pytest.mark.parametrize("d", [100, 768])
def test_ln_mxu_split_of_bf16_squares_is_exact(d):
    x = _near_zero_and_extremes(d, seed=d + 2)
    x[0, 3:5] = torch.tensor([3e15, -3e15])  # squares finite in fp32
    q = x.to(torch.bfloat16).float() ** 2  # exact: 16 significant bits
    hi, lo = _bf16_parts(q, 2)
    assert torch.equal(hi.double() + lo.double(), q.double())


def _kernel_sums_twin(x, scale, bias, eps=1e-5):
    """``ln_mxu``'s arithmetic as the CUDA kernel runs it: per 16-column
    chunk, the bf16 parts (x and x·x in three for fp32 rows; x, and x² in
    two, for bf16 rows) each summed against ones in fp32, smallest first;
    the chunk sums added into the row's fp32 sums in order."""
    x32 = x.float()
    rows, d = x32.shape
    xp = torch.nn.functional.pad(x32, (0, -d % 16)).view(rows, -1, 16)
    n = 3 if x.dtype == torch.float32 else 1
    ones = torch.ones(16, 1)

    def sums(parts):
        chunk = torch.zeros(rows, xp.shape[1])
        for p in reversed(parts):
            chunk = chunk + (p.float() @ ones)[..., 0]
        total = torch.zeros(rows)
        for c in range(xp.shape[1]):
            total = total + chunk[:, c]
        return total[:, None]

    mean = sums(_bf16_parts(xp, n)) / d
    var = sums(_bf16_parts(xp * xp, max(n, 2))) / d - mean * mean
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [100, 768])
def test_ln_mxu_kernel_sums_match_plain(d, dtype_name):
    x, scale, bias = _rows(64, d, seed=d + 3)
    xt = torch.from_numpy(x).to(DTYPES[dtype_name])
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    twin = _kernel_sums_twin(xt, st, bt)
    assert twin.dtype == xt.dtype
    _close(twin, ops.ln_mxu_plain(xt, st, bt).float().numpy(), dtype_name)


@pytest.mark.parametrize("rows,warps,d,dtype,want", [
    (16, 4, 768, torch.float32, 16 * 772 * 4 + 8 * (64 + 16)),
    (16, 1, 768, torch.bfloat16, 16 * 776 * 2 + 8 * (16 + 16)),
    (64, 8, 768, torch.bfloat16, 64 * 776 * 2 + 8 * (128 + 64)),
    (16, 4, 100, torch.float32, 16 * 116 * 4 + 8 * (64 + 16)),
])
def test_ln_mxu_smem_bytes(rows, warps, d, dtype, want):
    assert ln_mxu_smem_bytes(rows, warps, d, dtype) == want
    if (d, dtype) == (768, torch.float32):  # one fp32 tile is past the default 48 KB
        assert 16 * 772 * 4 == 49408 > 48 * 1024


@pytest.mark.parametrize("rows,warps,d,dtype,match", [
    (8, 1, 64, torch.float32, "power of two >= 16"),
    (32, 1, 64, torch.float32, "multiple of rows_per_program / 16 = 2"),
    (128, 4, 64, torch.bfloat16, "multiple of rows_per_program / 16 = 8"),
    (16, 16, 64, torch.float32, "at most 8"),
    (16, 4, 3700, torch.float32, "shared memory"),
    (64, 4, 1024, torch.float32, "shared memory"),
    (128, 8, 768, torch.float32, "shared memory"),
])
def test_ln_mxu_refuses_configurations_the_kernel_does_not_take(rows, warps, d, dtype,
                                                               match):
    x = torch.zeros(2, d, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        ops.ln_mxu(x, torch.ones(d), torch.zeros(d), rows_per_program=rows,
                   num_warps=warps)


def test_ln_mxu_takes_rows_up_to_its_shared_memory():
    d = 3600  # 16 fp32 rows at 4 warps: 231,296 bytes of 232,448
    assert ln_mxu_smem_bytes(16, 4, d, torch.float32) <= LN_MXU_MAX_SMEM
    x, scale, bias = _rows(2, d)
    args = [torch.from_numpy(a) for a in (x, scale, bias)]
    y = ops.ln_mxu(*args, rows_per_program=16, num_warps=4)
    torch.testing.assert_close(y, ops.ln_mxu_plain(*args), rtol=0, atol=0)


# ---- ln_mxu_bf16's CUDA kernel, as far as the CPU can check it -------------

def _bf16_kernel_twin(x, scale, bias, eps=1e-5):
    """``ln_mxu_bf16``'s arithmetic as the CUDA kernel runs it: per 16-column
    chunk, Σx and Σ bf16(x²) each from zero (one part each), the chunk sums
    added into the row's fp32 sums in order; mean, var and rstd in fp32;
    then the five roundings to bf16 (mean, rstd, x − mean, ·rstd, ·scale,
    + bias, with scale and bias rounded to bf16)."""
    rows, d = x.shape
    xp = torch.nn.functional.pad(x, (0, -d % 16)).view(rows, -1, 16)
    ones = torch.ones(16, 1)

    def sums(part):
        chunk = (part.float() @ ones)[..., 0]
        total = torch.zeros(rows)
        for c in range(chunk.shape[1]):
            total = total + chunk[:, c]
        return total[:, None]

    mean = sums(xp) / d
    var = sums(xp * xp) / d - mean * mean  # xp * xp: the bf16 product
    rstd = torch.rsqrt(var + eps)
    bf16 = torch.bfloat16
    y = (x - mean.to(bf16)) * rstd.to(bf16)
    return y * scale.to(bf16) + bias.to(bf16)


@pytest.mark.parametrize("d", [100, 768])
def test_ln_mxu_bf16_kernel_sums_match_plain(d):
    x, scale, bias = _rows(64, d, seed=d + 5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    twin = _bf16_kernel_twin(xt, st, bt)
    assert twin.dtype == torch.bfloat16
    _close(twin, ops.ln_mxu_bf16_plain(xt, st, bt).float().numpy(), "bf16")


@pytest.mark.parametrize("rows,warps,d,want", [
    (16, 4, 768, 2 * 16 * 776 * 2 + 2 * 768 * 2 + 8 * (64 + 16)),
    (16, 1, 100, 2 * 16 * 120 * 2 + 2 * 112 * 2 + 8 * (16 + 16)),
    (64, 8, 768, 2 * 64 * 776 * 2 + 2 * 768 * 2 + 8 * (128 + 64)),
    (32, 2, 16, 2 * 32 * 24 * 2 + 2 * 16 * 2 + 8 * (32 + 32)),
])
def test_ln_mxu_bf16_smem_bytes(rows, warps, d, want):
    assert ln_mxu_bf16_smem_bytes(rows, warps, d) == want
    # both stages: twice ln_mxu's rows
    rows_bytes = ln_mxu_smem_bytes(rows, warps, d, torch.bfloat16) - 8 * (16 * warps + rows)
    assert want == 2 * rows_bytes + 2 * -(-d // 16) * 16 * 2 + 8 * (16 * warps + rows)


@pytest.mark.parametrize("rows,warps,d,match", [
    (8, 1, 64, "power of two >= 16"),
    (48, 3, 64, "power of two >= 16"),
    (32, 1, 64, "multiple of rows_per_program / 16 = 2"),
    (128, 4, 64, "multiple of rows_per_program / 16 = 8"),
    (16, 16, 64, "at most 8"),
    (128, 8, 768, "shared memory"),  # two stages of 128 rows: 397,312 bytes
    (16, 4, 3393, "shared memory"),  # 232,896 bytes
])
def test_ln_mxu_bf16_refuses_configurations_the_kernel_does_not_take(rows, warps, d, match):
    x = torch.zeros(2, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        ops.ln_mxu_bf16(x, torch.ones(d), torch.zeros(d), rows_per_program=rows,
                        num_warps=warps)


def test_ln_mxu_bf16_takes_rows_up_to_its_shared_memory():
    d = 3392  # two stages of 16 rows at 4 warps: 231,808 bytes of 232,448
    assert ln_mxu_bf16_smem_bytes(16, 4, d) <= LN_MXU_MAX_SMEM
    x, scale, bias = _rows(2, d)
    args = [torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale),
            torch.from_numpy(bias)]
    y = ops.ln_mxu_bf16(*args, rows_per_program=16, num_warps=4)
    torch.testing.assert_close(y, ops.ln_mxu_bf16_plain(*args), rtol=0, atol=0)


@pytest.mark.parametrize("rows_per_program,num_warps", SWEEP_CONFIGS)
@pytest.mark.parametrize("rows,d", [(8000, 768), (15360, 512), (37, 100), (1, 16)])
def test_ln_mxu_bf16_grid(rows, d, rows_per_program, num_warps):
    """Blocks of one launch on 132 SMs: at least one, no more than the tiles,
    and no more than the SMs hold by shared memory and threads."""
    sms = 132
    tiles = -(-rows // rows_per_program)
    blocks = ln_mxu_bf16_grid(rows, rows_per_program, num_warps, d, sms)
    assert 1 <= blocks <= tiles
    smem = ln_mxu_bf16_smem_bytes(rows_per_program, num_warps, d) + 1024
    assert blocks <= sms * (233472 // smem)
    assert blocks * 32 * num_warps <= sms * 2048


@pytest.mark.parametrize("rows,walk,more", [(8000, 1, 236), (64000, 15, 40)])
def test_ln_mxu_bf16_blocks_walk_the_tiles(rows, walk, more):
    """At the default configuration each SM keeps ``LN_MXU_BF16_IN_FLIGHT``
    bytes of tile loads in flight, one tile per block, rounded up to whole
    blocks; the blocks walk the tiles a grid apart, so the next tile's copy
    overlaps the current one: of the 264 blocks at the sweep's [8000, 768]
    236 walk two tiles and 28 one; at [64000, 768] 40 walk 16 and the rest
    15."""
    rows_per_program, num_warps = LN_MXU_BF16_CONFIG
    tiles = rows // rows_per_program
    blocks = ln_mxu_bf16_grid(rows, rows_per_program, num_warps, 768, 132)
    per_sm, tile_bytes = blocks // 132, rows_per_program * 768 * 2
    assert blocks == 132 * per_sm
    assert per_sm * tile_bytes >= ln_designs.LN_MXU_BF16_IN_FLIGHT
    assert (per_sm - 1) * tile_bytes < ln_designs.LN_MXU_BF16_IN_FLIGHT
    assert blocks == 264
    assert tiles // blocks == walk and tiles - walk * blocks == more


# ---- on the card: each kernel against its plain version -------------------

# rows, d, row stride, x's offset and the parameters' offset in elements
LN_MXU_CARD_CASES = {
    "8000x768": (8000, 768, 768, 0, 0),
    "960x512": (960, 512, 512, 0, 0),
    "37x100": (37, 100, 100, 0, 0),  # bf16: 200-byte rows, the element path
    "50x16": (50, 16, 16, 0, 0),
    "row stride 800": (300, 768, 800, 0, 0),  # a row view, 16-byte copies
    "row stride 770": (300, 768, 770, 0, 0),  # a row view, element loads
    "base off 16 bytes": (300, 768, 768, 1, 0),  # element loads in
    "params off 16 bytes": (300, 768, 768, 0, 1),  # element stores out
}


def _card_case(case, dtype, dev):
    rows, d, width, offset, p_offset = LN_MXU_CARD_CASES[case]
    rng = np.random.default_rng(rows + width + offset + p_offset)
    flat = (rng.normal(size=rows * width + offset) * 2 + 0.5).astype(np.float32)
    x = torch.from_numpy(flat).to(dev).to(dtype)[offset:].view(rows, width)[:, :d]
    scale, bias = (torch.from_numpy(rng.normal(mu, 0.2, d + p_offset).astype(np.float32))
                   .to(dev)[p_offset:] for mu in (1.0, 0.0))
    return x, scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_program,num_warps", [(16, 1), (16, 4), (32, 2), (64, 8)])
@pytest.mark.parametrize("case", list(LN_MXU_CARD_CASES))
def test_ln_mxu_on_card(cuda, case, rows_per_program, num_warps):
    for dtype_name, dtype in DTYPES.items():
        x, scale, bias = _card_case(case, dtype, cuda)
        n = ops.ln_mxu.launches
        out = ops.ln_mxu(x, scale, bias, rows_per_program=rows_per_program,
                         num_warps=num_warps)
        torch.cuda.synchronize()
        assert ops.ln_mxu.launches == n + 1
        assert out.shape == x.shape and out.dtype == dtype and out.is_contiguous()
        _close(out, ops.ln_mxu_plain(x, scale, bias).float().cpu().numpy(), dtype_name)


@pytest.mark.cuda
@pytest.mark.parametrize("one_sm", [False, True], ids=["grid", "one SM"])
@pytest.mark.parametrize("rows_per_program,num_warps", [(16, 1), (16, 4), (32, 2), (64, 8)])
@pytest.mark.parametrize("case", list(LN_MXU_CARD_CASES))
def test_ln_mxu_bf16_on_card(cuda, case, rows_per_program, num_warps, one_sm, monkeypatch):
    """With ``one_sm`` the grid is sized for one SM: its blocks walk every
    tile, so both stages, the ragged last tile and the element path's
    copies are taken in one walk."""
    if one_sm:
        monkeypatch.setattr(ln_designs, "_sm_count", lambda device: 1)
    x, scale, bias = _card_case(case, torch.bfloat16, cuda)
    n = ops.ln_mxu_bf16.launches
    out = ops.ln_mxu_bf16(x, scale, bias, rows_per_program=rows_per_program,
                          num_warps=num_warps)
    torch.cuda.synchronize()
    assert ops.ln_mxu_bf16.launches == n + 1
    assert out.shape == x.shape and out.dtype == torch.bfloat16 and out.is_contiguous()
    _close(out, ops.ln_mxu_bf16_plain(x, scale, bias).float().cpu().numpy(), "bf16")
