"""The cross route of ``fused_mha`` (``csrc/cross_attention.cuh``: few queries
over many keys, the joint TimeSformer's CLS row) on the CPU: a PyTorch twin
of the kernel's order of arithmetic, held against
``vtc_tpu.models.timesformer_joint._attn`` and against the fp64 contract.

The twin splits each sequence-head's keys as ``plan_copy`` (the Python copy
of the C plan, ``ca::plan``) does: C contiguous ranges of ``keys``, each
range split again over the CTA's 4 warps in whole 8-key periods. Each range gives
its row max m_c and its sum l_c of exp(S − m_c); the cluster's pairs are
combined in rank order, m = max m_c and l = Σ l_c·exp(m_c − m); P = exp(S −
m) / l is normalised, then rounded to q's type; each warp's P·V is summed in
fp32, the warps' in order, then the ranges' in rank order, and rounded once.
The kernel's sums inside a range run in another order than torch's (one
FMA chain a key, a shuffle tree a warp): the twin is the split, not the bits.

Tolerances: fp32 2e-5 (``tests/test_pallas_attention.py``'s); bf16 one bf16
ulp of the largest output, as ``tests/test_torch_timesformer_joint.py``
holds the plain version; and at most ``ATTN_BF16_SHARE`` of the outputs
beyond one ulp at the median against the fp64 contract (``chip_smoke.py``'s
limit for the kernel on the card). Torch runs on one thread here.
"""

import numpy as np
import pytest
import torch

from vtc_tpu_torch import ops
from vtc_tpu_torch.ops.attention import CrossPlan

ATOL = 2e-5  # tests/test_pallas_attention.py:114
ATTN_BF16_SHARE = 1e-4  # chip_smoke.py: the attention kernels' bf16 one-ulp share
# csrc/cross_attention.cuh: ca::kThreads, kWarps, kMaxCluster, kTargetBytes,
# kSmemMax, kRegKeys
THREADS, WARPS, MAX_CLUSTER, TARGET, SMEM_MAX, REG_KEYS = 128, 4, 8, 40 * 1024, 232448, 56
# the share's check: 384 sequences of ViT-B/32's 12 heads over 393 keys,
# 294,912 outputs. The share is a count of flips: over the first 64 or 128
# sequences it read 0, from 384 on it stayed within 3.4e-5 to 5.2e-5 up to
# 2,048 sequences (the plain version's 4.2e-5 to 6.6e-5), half the limit
SHARE_BATCH, SHARE_CHUNK = 384, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one thread per op while this module runs, the
    setting restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def plan_copy(queries: int, keys: int, head_dim: int, dtype: torch.dtype) -> CrossPlan:
    """``ca::plan`` in Python, without the library (``test_plan_copy_
    equals_the_c_plan`` holds it to the C plan on the card): the smallest
    cluster (up to 8) at which a CTA's shared memory is at most 40 KB, else
    8 where a CTA of 8 fits an SM; ``cluster`` 0 where none does. A CTA's
    shared memory: K's rows (Dh rounded up to 128-byte lines), which the
    warps' partial outputs take over; V's rows, unless V is held in
    registers (bf16 at Dh <= 64 and at most 56 keys a warp); in fp32 q, S
    (rows padded to 4), the warps' and the CTA's row statistics and their
    inbox, and with a cluster the inbox of the CTA's slice of the outputs."""
    es = 2 if dtype == torch.bfloat16 else 4
    row = -(-head_dim * es // 128) * 128
    cols = row // es

    def smem(n, c):
        slice_ = -(-queries * head_dim // c)
        k_rows = max(n * row, 4 * WARPS * queries * cols)  # later the warps' outputs
        v_regs = es == 2 and head_dim <= 64 and -(-n // WARPS) <= REG_KEYS
        return k_rows + (0 if v_regs else n * row) + 4 * (
            queries * cols + queries * -(-n // 4) * 4 + 2 * WARPS * queries
            + 2 * queries + 2 * c * queries + (c * slice_ if c > 1 else 0))

    for c in range(1, MAX_CLUSTER + 1):
        n = -(-keys // c)
        ctas = -(-keys // n)  # none of them empty
        s = smem(n, ctas)
        if s <= TARGET or (c == MAX_CLUSTER and s <= SMEM_MAX):
            return CrossPlan(ctas, n, THREADS, s)
    return CrossPlan(0, 0, 0, 0)


def cross_twin(q, k, v, heads: int) -> torch.Tensor:
    """The cross route's arithmetic in PyTorch: q ``[B, Lq, E]``, k and v
    ``[B, Lk, E]`` in fp32 or bf16 -> ``[B, Lq, E]`` in q's dtype."""
    b, lq, e = q.shape
    lk, dh = k.shape[1], e // heads
    plan = plan_copy(lq, lk, dh, q.dtype)
    assert plan.cluster >= 1

    def rounded(x):
        return x.to(q.dtype).float()

    qs = rounded(q.float() * rounded(torch.tensor(dh ** -0.5))).reshape(b, lq, heads, dh)
    kh = k.float().reshape(b, lk, heads, dh)
    vh = v.float().reshape(b, lk, heads, dh)
    s = torch.einsum("blhd,bmhd->bhlm", qs, kh)  # [B, H, Lq, Lk]
    ranges = [(c * plan.keys, min(lk, (c + 1) * plan.keys)) for c in range(plan.cluster)]
    m_c = [s[..., k0:k1].amax(-1, keepdim=True) for k0, k1 in ranges]
    l_c = [torch.exp(s[..., k0:k1] - mc).sum(-1, keepdim=True)
           for (k0, k1), mc in zip(ranges, m_c)]
    m = torch.stack(m_c).amax(0)  # every CTA combines the C pairs: m first,
    l = torch.zeros_like(m)  # then l in rank order
    for mc, lc in zip(m_c, l_c):
        l = l + lc * torch.exp(mc - m)
    p = rounded(torch.exp(s - m) / l)
    out = torch.zeros(b, heads, lq, dh)
    for k0, k1 in ranges:
        n = k1 - k0
        per_warp = -(-(-(-n // WARPS)) // 8) * 8  # whole 8-key periods
        cta = torch.zeros(b, heads, lq, dh)
        for w in range(WARPS):
            j0, j1 = min(n, w * per_warp) + k0, min(n, (w + 1) * per_warp) + k0
            cta = cta + torch.einsum("bhlm,bmhd->bhld", p[..., j0:j1], vh[:, j0:j1])
        out = out + cta
    return out.transpose(1, 2).reshape(b, lq, e).to(q.dtype)


def contract_fp64(q, k, v, heads: int):
    """The contract in fp64: q scaled in its dtype, S and the softmax in
    fp64, P rounded to q's dtype, P·V in fp64, the output rounded once; and
    beside it the same with P left unrounded, the fault the bf16 rule must
    see. -> (contract, fault), each in q's dtype."""
    b, lq, e = q.shape
    lk, dh = k.shape[1], e // heads
    qs = (q * torch.tensor(dh ** -0.5, dtype=q.dtype)).double().reshape(b, lq, heads, dh)
    s = torch.einsum("blhd,bmhd->bhlm", qs, k.double().reshape(b, lk, heads, dh))
    p = torch.softmax(s, -1)
    vh = v.double().reshape(b, lk, heads, dh)
    return tuple(torch.einsum("bhlm,bmhd->blhd", pp, vh).reshape(b, lq, e).to(q.dtype)
                 for pp in (p.to(q.dtype).double(), p))


def jax_reference(q, k, v, heads: int, dtype) -> np.ndarray:
    """``_attn`` on the heads split out, q scaled first as the JAX model
    does (``vtc_tpu/models/timesformer_joint.py:85-97``), as fp32 numpy."""
    import jax.numpy as jnp  # here, so that the card tests collect without JAX

    from vtc_tpu.models.timesformer_joint import _attn as jax_attn

    b, lq, e = q.shape
    dh = e // heads
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def heads_of(z):
        z = jnp.asarray(z).astype(jdt)
        return jnp.moveaxis(z.reshape(b, -1, heads, dh), 2, 1).reshape(b * heads, -1, dh)

    out = jax_attn(heads_of(q) * (dh ** -0.5), heads_of(k), heads_of(v))
    out = jnp.moveaxis(out.reshape(b, heads, lq, dh), 1, 2).reshape(b, lq, e)
    return np.asarray(out.astype(jnp.float32))


def inputs(b, lq, lk, e, seed, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, e), dtype=np.float32) for n in (lq, lk, lk))
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,e,heads", [
    (1, 393, 768, 12),  # the joint tower's CLS row at ViT-B/32, 8 frames
    (1, 2, 64, 4), (5, 9, 64, 4), (16, 33, 80, 4),  # Dh = 20: rows padded
])
def test_twin_against_jax(lq, lk, e, heads, dtype):
    """The twin of the kernel's split against ``_attn``: fp32 within 2e-5,
    bf16 within one bf16 ulp of the largest output."""
    q, k, v = inputs(3, lq, lk, e, lq * 1000 + lk, dtype)
    ours = cross_twin(q, k, v, heads).float().numpy()
    theirs = jax_reference(*(t.float().numpy() for t in (q, k, v)), heads, dtype)
    tol = ATOL if dtype == torch.float32 else 2.0 ** -7 * np.abs(theirs).max()
    np.testing.assert_allclose(ours, theirs, atol=tol, rtol=0)


@pytest.mark.parametrize("lq,lk,dh,dtype", [
    (1, 393, 64, torch.bfloat16), (1, 393, 64, torch.float32), (16, 393, 64, torch.bfloat16),
    (1, 1025, 64, torch.bfloat16), (16, 1100, 128, torch.float32),
])
def test_twin_splits_the_keys(lq, lk, dh, dtype):
    """The shapes the card's tests take split the keys over a cluster, and
    the twin's split result stays within the tolerance of the one-range
    plain version at them."""
    plan = plan_copy(lq, lk, dh, dtype)
    assert plan.cluster >= 2
    q, k, v = inputs(1, lq, lk, 2 * dh, lk, dtype)
    ours = cross_twin(q, k, v, 2).float()
    ref = ops.fused_mha_plain(q, k, v, 2).float()
    tol = ATOL if dtype == torch.float32 else 2.0 ** -7 * ref.abs().max().item()
    assert (ours - ref).abs().max().item() <= tol


def test_twin_share_against_the_fp64_contract():
    """bf16 at the joint tower's shape, (1, 393), E 768, 12 heads, on
    ``SHARE_BATCH`` sequences: at most ``ATTN_BF16_SHARE`` of the twin's
    outputs lie beyond one bf16 ulp at the median from the fp64 contract,
    and P left unrounded (the fault the rule must see) lies far beyond."""
    beyond = unrounded = total = 0
    outs = []
    for start in range(0, SHARE_BATCH, SHARE_CHUNK):
        q, k, v = inputs(SHARE_CHUNK, 1, 393, 768, 7000 + start, torch.bfloat16)
        ref, fault = contract_fp64(q, k, v, 12)
        outs.append((cross_twin(q, k, v, 12).float(), ref.float(), fault.float()))
    median = torch.cat([r.flatten() for _, r, _ in outs]).abs().median().item()
    ulp = 2.0 ** (np.floor(np.log2(median)) - 7)
    for ours, ref, fault in outs:
        beyond += int(((ours - ref).abs() > ulp).sum())
        unrounded += int(((fault - ref).abs() > ulp).sum())
        total += ref.numel()
    assert beyond / total <= ATTN_BF16_SHARE, (beyond, total)
    assert unrounded / total > ATTN_BF16_SHARE, (unrounded, total)


def test_plan_copy_fits():
    """Every plan of the Python copy for Lk <= 1,100, Lq <= 16 and Dh <=
    128 fits an SM's 227 KB and a portable cluster, and gives every CTA a
    key (the card's test holds the C plan equal to it)."""
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (1, 20, 64, 65, 128):
            for lq in (1, 16):
                for lk in range(lq + 1, 1101):
                    p = plan_copy(lq, lk, dh, dtype)
                    assert 1 <= p.cluster <= 8 and p.smem <= 232448, (lq, lk, dh, dtype)
                    assert (p.cluster - 1) * p.keys < lk <= p.cluster * p.keys


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels build and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_plan_copy_equals_the_c_plan(cuda):
    """The twin's plan is the one the card launches: the Python copy equals
    ``ops.cross_plan`` (the C entry) at every (Lq, Lk <= 1,100) at Dh on
    each side of the 128-byte row steps (and 20, 100), and at every Dh at
    the lengths around a step of the cluster."""
    def check(lq, lk, dh, dtype):
        assert plan_copy(lq, lk, dh, dtype) == ops.cross_plan(lq, lk, dh, dtype), (
            lq, lk, dh, dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for dh in (1, 20, 32, 33, 64, 65, 96, 97, 100, 127, 128):
            for lq in range(1, 17):
                for lk in range(lq + 1, 1101):
                    check(lq, lk, dh, dtype)
        for dh in range(1, 129):
            for lq in (1, 5, 16):
                for lk in (lq + 1, 197, 393, 394, 787, 1025, 1100):
                    check(lq, lk, dh, dtype)


def test_profile_family_of_the_cross_kernel():
    """``profile_trace`` charges the cross route's device kernel to its own
    family, not to the short tile's or the long route's."""
    from vtc_tpu_torch.scripts import profile_trace

    assert profile_trace.family("fused_mha_cross_kernel<__nv_bfloat16, true>") == (
        "fused_mha_cross")


def test_cpu_fused_mha_takes_the_plain_version():
    """On the CPU ``fused_mha`` at Lq <= 16, Lq < Lk runs its plain version and
    launches nothing: the cross route's counter stays."""
    q, k, v = inputs(2, 1, 393, 768, 1, torch.bfloat16)
    n = ops.fused_mha_cross.launches
    assert torch.equal(ops.fused_mha(q, k, v, 12), ops.fused_mha_plain(q, k, v, 12))
    assert ops.fused_mha_cross.launches == n
