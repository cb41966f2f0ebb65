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

The ``cuda``-marked tests hold the Triton kernels against the plain versions
on the card and skip without one; run them there with
``python -m pytest tests/test_torch_ln_designs.py -m cuda --noconftest``.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from vtc_tpu_torch import ops

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


# ---- on the card: each kernel against its plain version -------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_program,num_warps", [(16, 4), (64, 4), (128, 8)])
@pytest.mark.parametrize("rows,d", [(8000, 768), (960, 512), (37, 100)])
def test_ln_designs_on_card(cuda, rows, d, rows_per_program, num_warps):
    x, scale, bias = _rows(rows, d, seed=rows)
    scale, bias = torch.from_numpy(scale).to(cuda), torch.from_numpy(bias).to(cuda)
    x32 = torch.from_numpy(x).to(cuda)
    x16 = x32.to(torch.bfloat16)
    kw = dict(rows_per_program=rows_per_program, num_warps=num_warps)
    n = ops.ln_mxu.launches, ops.ln_mxu_bf16.launches
    outs = (ops.ln_mxu(x32, scale, bias, **kw), ops.ln_mxu(x16, scale, bias, **kw),
            ops.ln_mxu_bf16(x16, scale, bias, **kw))
    torch.cuda.synchronize()
    assert (ops.ln_mxu.launches, ops.ln_mxu_bf16.launches) == (n[0] + 2, n[1] + 1)
    refs = (ops.ln_mxu_plain(x32, scale, bias), ops.ln_mxu_plain(x16, scale, bias),
            ops.ln_mxu_bf16_plain(x16, scale, bias))
    for out, ref, dtype_name in zip(outs, refs, ("fp32", "bf16", "bf16")):
        _close(out, ref.float().cpu().numpy(), dtype_name)
