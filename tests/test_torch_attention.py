"""The port's ``fused_attention`` (vtc_tpu_torch.ops) against the JAX Pallas
kernel it replaces, ``vtc_tpu.ops.pallas_attention.fused_attention``.

On the CPU the wrapper runs its plain version; the JAX wrapper runs its
Pallas kernel in interpret mode by itself there. Tolerances: fp32 atol 2e-5
(the repo's kernel tolerance, tests/test_pallas_attention.py); bf16 one bf16
ulp at the output's largest magnitude (both sides round P and the output to
bf16 from fp32 sums taken in another order).

The ``cuda``-marked tests hold the kernel against its plain version on the
card and skip without one; run them there with
``python -m pytest tests/test_torch_attention.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from vtc_tpu_torch import ops
from vtc_tpu_torch.ops import _build

FP32_ATOL = 2e-5
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _close(ours, ref, dtype_name, ulps=1):
    ours = ours.detach().float().cpu().numpy()
    ref = np.asarray(ref).astype(np.float32)
    atol = FP32_ATOL if dtype_name == "fp32" else (
        ulps * 2.0**-7 * max(1.0, float(np.abs(ref).max())))
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


def _mask(kind, length, seed=0):
    """None, the causal mask, or a seeded additive mask with -inf entries
    (about a third of them) and a finite diagonal, so no row is masked
    whole."""
    if kind == "none":
        return None
    if kind == "causal":
        return np.triu(np.full((length, length), -np.inf, np.float32), 1)
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(length, length)).astype(np.float32)
    m[rng.uniform(size=(length, length)) < 0.3] = -np.inf
    np.fill_diagonal(m, 0.0)
    return m


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels build and run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "additive"])
@pytest.mark.parametrize("length", [8, 16, 50, 77])
def test_fused_attention_matches_pallas(length, mask_kind, dtype_name):
    import jax.numpy as jnp

    from vtc_tpu.ops.pallas_attention import fused_attention as jax_fused_attention

    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    rng = np.random.default_rng(length)
    q, k, v = (rng.normal(size=(6, length, 32)).astype(np.float32) for _ in range(3))
    mask = _mask(mask_kind, length, seed=length)
    ref = jax_fused_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        None if mask is None else jnp.asarray(mask),
    )
    before = ops.fused_attention.launches
    ours = ops.fused_attention(
        *(torch.from_numpy(a).to(DTYPES[dtype_name]) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask),
    )
    assert ops.fused_attention.launches == before  # the CPU runs no kernel
    assert ours.dtype == DTYPES[dtype_name] and ours.shape == q.shape
    _close(ours, ref, dtype_name)


def test_fused_attention_scales_the_fp32_scores():
    """The contract scales the fp32 scores, not q in its dtype: at Dh = 48
    (scale 48^-0.5, not a power of two) in bf16 the two differ, and the
    plain version follows the JAX reference."""
    import jax.numpy as jnp

    from vtc_tpu.ops.pallas_attention import _reference_attention

    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(4, 16, 48)).astype(np.float32) for _ in range(3))
    ref = _reference_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                               None, 48**-0.5)
    ours = ops.fused_attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    _close(ours, ref, "bf16")


def test_fused_attention_takes_strided_head_views():
    """q, k, v as [B, H, L, Dh] views of the column slices of one merged qkv
    tensor (strides (L·3E, Dh, 3E, 1)), as the TimeSformer's ``timeattn``
    hands them over, give the result of the contiguous [B·H, L, Dh] call."""
    b, l, h, dh = 5, 8, 4, 16
    qkv = torch.from_numpy(np.random.default_rng(5).normal(size=(b, l, 3 * h * dh))
                           .astype(np.float32))
    q, k, v = (t.unflatten(-1, (h, dh)).transpose(1, 2) for t in qkv.chunk(3, -1))
    assert q.stride() == (l * 3 * h * dh, dh, 3 * h * dh, 1)
    mask = torch.from_numpy(_mask("additive", l))
    out = ops.fused_attention(q, k, v, mask)
    flat = [t.contiguous().reshape(b * h, l, dh) for t in (q, k, v)]
    ref = ops.fused_attention(*flat, mask)
    torch.testing.assert_close(out.reshape(b * h, l, dh), ref, atol=0, rtol=0)


@pytest.mark.parametrize("shape,match", [
    ((2, 129, 64), "L <= 128"), ((2, 8, 129), "D <= 128"), ((2, 8), r"\[B, L, D\]"),
])
def test_fused_attention_rejects_what_the_kernel_does_not_take(shape, match):
    q = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        ops.fused_attention(q, q, q)
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="mask must be"):
        ops.fused_attention(q, q, q, torch.zeros(4, 4))


def test_fused_attention_backward_raises():
    """A launch wrapped as forward-only (the LN sweep's designs) refuses a
    gradient loudly; ``fused_attention`` itself now takes one, through its
    own backward (tests/test_torch_training.py holds it against JAX)."""
    q = torch.randn(2, 8, 16, requires_grad=True)
    y = _build.forward_only(
        "ln_mxu_bf16", lambda a: ops.fused_attention_plain(a, a, a), q)
    with pytest.raises(NotImplementedError, match="ln_mxu_bf16 has no backward"):
        y.sum().backward()
    (grad,) = torch.autograd.grad(ops.fused_attention(q, q, q).sum(), q)
    assert grad.shape == q.shape and bool(torch.isfinite(grad).all())


# ---- on the card: the kernel against its plain version ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "additive"])
@pytest.mark.parametrize("b,h,l,dh", [
    # h = 0: contiguous [B, L, Dh]; h > 0: [B, H, L, Dh] head views of the
    # column slices of one [B, L, 3·H·Dh] buffer, as the TimeSformer's
    (96, 0, 8, 64), (64, 0, 16, 64), (8, 0, 77, 32), (4, 0, 128, 128),
    (16, 0, 1, 64),
    # head views at L = 8 with an odd B·H = 35, and at L = 128
    (7, 5, 8, 64), (3, 2, 128, 64),
])
def test_fused_attention_kernel_on_card(cuda, b, h, l, dh, mask_kind, dtype_name):
    tdt = DTYPES[dtype_name]
    g = torch.Generator().manual_seed(l)
    if h:
        qkv = torch.randn(b, l, 3 * h * dh, generator=g).to(cuda, tdt)
        q, k, v = (t.unflatten(-1, (h, dh)).transpose(1, 2) for t in qkv.chunk(3, -1))
    else:
        q, k, v = (torch.randn(b, l, dh, generator=g).to(cuda, tdt) for _ in range(3))
    mask = _mask(mask_kind, l, seed=l)
    mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    n = ops.fused_attention.launches
    out = ops.fused_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert ops.fused_attention.launches == n + 1
    _close(out, ops.fused_attention_plain(q, k, v, mask).float().cpu().numpy(),
           dtype_name, ulps=2)


@pytest.mark.cuda
def test_fused_attention_head_views_on_card(cuda):
    """The 4-D strided call writes [B, L, H, Dh] memory, so merging the
    heads back is a view, and agrees with the contiguous 3-D call."""
    b, l, h, dh = 50, 8, 12, 64
    qkv = torch.randn(b, l, 3 * h * dh, device=cuda)
    q, k, v = (t.unflatten(-1, (h, dh)).transpose(1, 2) for t in qkv.chunk(3, -1))
    out = ops.fused_attention(q, k, v)
    merged = out.transpose(1, 2)
    assert merged.is_contiguous()
    flat = ops.fused_attention(*(t.contiguous().reshape(b * h, l, dh) for t in (q, k, v)))
    torch.testing.assert_close(out.reshape(b * h, l, dh), flat, atol=0, rtol=0)


@pytest.mark.cuda
def test_fused_attention_backward_raises_on_card(cuda):
    """On the card the gradient runs the backward of the plain version (it
    raised before the port had one); shapes the kernel refuses still
    raise."""
    q = torch.randn(4, 8, 16, device=cuda, requires_grad=True)
    (grad,) = torch.autograd.grad(ops.fused_attention(q, q, q).sum(), q)
    (ref,) = torch.autograd.grad(ops.fused_attention_plain(q, q, q).sum(), q)
    _close(grad, ref.cpu().numpy(), "fp32")
    with pytest.raises(ValueError, match="L <= 128"):
        ops.fused_attention(*(torch.zeros(2, 129, 16, device=cuda),) * 3)
