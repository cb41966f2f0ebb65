"""The sequence axis: ring attention over a block stack's sequence shards,
the port of ``vtc_tpu/parallel/sequence.py`` on ``torch.distributed``, one
process per card.

``create_sp_mesh(n_data, n_seq)`` lays the group out as a ``("data",
"seq")`` ``DeviceMesh``, rank ``d·n_seq + s`` at ``(d, s)``; the ranks of a
seq group hold the same rows of the batch. ``train.py --sp S`` turns the
stacks' ring on (``parallel.stack``): each ``models.layers.Transformer``
(the text tower, the ViT tower, the CAM's adapter) then runs
``sp_transformer``:

* the stack's input ``[B, L, E]`` is padded so that ``L`` divides over the
  ``S`` shards (``pad_for_sp``: CLIP's 77 tokens divide over no degree) and
  each rank keeps its ``L/S`` rows of the sequence (``_Scatter``, whose
  backward gathers the rows' gradients, so every rank holds the whole
  input gradient);
* each block runs its own ``forward`` on the shard: the LayerNorms, the qkv
  and out projections and the MLP are pointwise over the sequence, so they
  run locally, through the same kernels. The ring (``Ring``, handed to the
  blocks in place of ``causal``) replaces the ``fused_mha`` call alone:
  step 0 attends over the local K/V, then ``S - 1`` rotate-then-accumulate
  steps send K and V to the next rank of the ring and take the previous
  rank's, each step adding its ``[rows(me), cols(src)]`` tile of the
  additive mask; the running max, denominator and numerator are fp32, the
  logits and ``P·V`` fp32 products as ``vtc_tpu``'s
  ``preferred_element_type=jnp.float32`` einsums (``_ring_attention``,
  ``:97-159``), and the output ``num/den`` where ``den > 0``;
* the shards are gathered at the end (``_Gather``, whose backward keeps this
  rank's rows) and the padding dropped.

The rotation is an autograd function (``_Rotate``): its forward sends to
rank ``i + 1`` of the seq group and receives from ``i - 1``, its backward
sends the gradient the other way, as JAX's autodiff of ``ppermute`` does.
The messages go through the host where the backend is gloo and the tensor
is on a card (gloo's point-to-point aborts on CUDA tensors), straight over
NCCL. The running max only stabilises the exponentials (the output does
not depend on it), so it is taken without a graph.

A ring-sharded stack's block parameters see only their rank's share of the
sequence: ``sync_ring_gradients`` sums their gradients over the seq group.
Every other gradient is already whole and equal on the seq ranks (the
embeddings above the scatter, ``ln_post``, ``ln_final`` and the
projections below the gather, the TimeSformer, the loss).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.attention import causal_mask
from .mesh import SEQ_AXIS, _make_mesh, axis_place
from .pipeline import _all_reduce, _via_host
from .tensor import ModelAxis, _gather, local_part, own_part


def create_sp_mesh(n_data=None, n_seq: int = 1, *, device):
    """The process group as a ``("data", "seq")`` ``DeviceMesh`` of
    ``n_data × n_seq`` ranks, rank ``d·n_seq + s`` at ``(d, s)``, kept as the
    current mesh (``parallel.mesh``); None for one process."""
    return _make_mesh(n_data, n_seq, SEQ_AXIS, device)


def seq_axis(mesh=None) -> ModelAxis:
    """This rank's place on the seq axis of ``mesh`` (default: the current
    mesh; without a seq axis, this rank alone)."""
    return axis_place(SEQ_AXIS, mesh)


def pad_for_sp(x: torch.Tensor, mask, n_seq: int):
    """``x`` [B, L, E] padded on the sequence so that it divides over
    ``n_seq`` shards, the additive ``[L', L']`` fp32 mask for it (``mask``,
    or zeros where None) and ``L``: the padded columns are ``-inf`` for
    every real query, each padded row sees only itself (its softmax stays
    defined; its output is dropped with the original length)."""
    length = x.shape[1]
    padded = -(-length // n_seq) * n_seq
    base = torch.zeros((length, length), device=x.device) if mask is None \
        else mask.to(x.device, torch.float32)
    if padded == length:
        return x, base, length
    x = F.pad(x, (0, 0, 0, padded - length))
    big = torch.full((padded, padded), float("-inf"), device=x.device)
    big[:length, :length] = base
    diag = torch.arange(length, padded, device=x.device)
    big[diag, diag] = 0.0
    return x, big, length


def _shift(x: torch.Tensor, axis: ModelAxis, step: int) -> torch.Tensor:
    """``x`` sent to rank ``i + step`` of ``axis``'s ring and the tensor of
    rank ``i - step`` received, in one batch of the two (every rank posts
    the same pair, so no hop waits on another)."""
    x = x.detach().contiguous()
    host = _via_host(x, axis.group)
    send = x.cpu() if host else x
    recv = torch.empty_like(send)
    to = dist.get_global_rank(axis.group, (axis.rank + step) % axis.size)
    frm = dist.get_global_rank(axis.group, (axis.rank - step) % axis.size)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, axis.group),
                                       dist.P2POp(dist.irecv, recv, frm, axis.group)]):
        req.wait()
    return recv.to(x.device) if host else recv


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _shift(x, axis, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.axis, -1), None


class _Scatter(torch.autograd.Function):
    """This rank's rows of the sequence; the backward gathers every rank's."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return own_part(x, axis.rank, axis.size, 1)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, 1, ctx.axis), None


class _Gather(torch.autograd.Function):
    """Every rank's rows of the sequence; the backward keeps this rank's."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather(x, 1, axis)

    @staticmethod
    def backward(ctx, grad):
        return own_part(grad, ctx.axis.rank, ctx.axis.size, 1), None


@dataclasses.dataclass(frozen=True)
class Ring:
    """The ring of one stack's forward: ``axis`` (this rank's place on the
    seq group) and the padded stack's additive ``[L, L]`` fp32 ``mask``.
    A block hands it to its attention in place of ``causal``
    (``models.layers.MultiHeadAttention``), which then attends here."""

    axis: ModelAxis
    mask: torch.Tensor

    def attend(self, q, k, v, heads: int) -> torch.Tensor:
        return ring_attention(q, k, v, heads, self.mask, self.axis)


def ring_attention(q, k, v, heads: int, mask: torch.Tensor, axis: ModelAxis):
    """Attention of this rank's queries over every rank's keys (the module
    docstring): ``q``, ``k``, ``v`` are the local ``[B, l, E]`` shards (head
    ``h`` at columns ``h·Dh …``), ``mask`` the whole additive fp32 mask;
    returns the local ``[B, l, E]`` output in ``q``'s dtype."""
    b, l, e = q.shape
    dh = e // heads
    dtype = q.dtype

    def heads_of(t):
        return t.unflatten(-1, (heads, dh)).float()

    qf = heads_of(q * dh ** -0.5)  # scaled in its dtype, as vtc_tpu's
    me, s = axis.rank, axis.size
    rows = mask[me * l:(me + 1) * l]
    m = torch.full((b, heads, l), float("-inf"), device=q.device)
    den = torch.zeros((b, heads, l), device=q.device)
    num = torch.zeros((b, heads, l, dh), device=q.device)
    kv = torch.stack([k, v])
    for t in range(s):
        if t:  # rotate, then accumulate: s - 1 hops
            kv = _Rotate.apply(kv, axis)
        src = (me - t) % s
        logits = torch.einsum("blhd,bmhd->bhlm", qf, heads_of(kv[0]))
        logits = logits + rows[:, src * l:(src + 1) * l]
        with torch.no_grad():  # a stabiliser: the output does not depend on it
            m_new = torch.maximum(m, logits.amax(-1))
            # rows masked everywhere so far: exp against 0 keeps num/den at 0
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            corr = torch.exp(m - m_safe)
            m = m_new
        p = torch.exp(logits - m_safe[..., None])
        den = den * corr + p.sum(-1)
        num = num * corr[..., None] + torch.einsum("bhlm,bmhd->bhld", p, heads_of(kv[1]))
    live = den > 0
    out = torch.where(live[..., None], num / torch.where(live, den, 1.0)[..., None], 0.0)
    return out.transpose(1, 2).reshape(b, l, e).to(dtype)


def sp_transformer(stack, x: torch.Tensor, causal: bool, *, axis: ModelAxis):
    """``stack``'s blocks (a ``models.layers.Transformer``) on ``x`` [B, L,
    E] with the sequence sharded over ``axis`` (the module docstring); every
    rank of the seq group returns the stack's output."""
    from ..models.layers import run_block

    mask = causal_mask(x.shape[1], x.device) if causal else None
    x, mask, length = pad_for_sp(x, mask, axis.size)
    ring = Ring(axis, mask)
    h = _Scatter.apply(x, axis)
    for block in stack.resblocks:
        h = run_block(block, h, ring)
    return _Gather.apply(h, axis)[:, :length]


def sync_ring_gradients(model: torch.nn.Module) -> None:
    """Each ring-sharded stack's block gradients summed over the seq group
    (a ZeRO-3 shard's local part), which makes them the whole sequence's; a
    parameter without a gradient keeps none."""
    axis = seq_axis()
    if axis.size == 1:
        return
    grads = [local_part(p.grad) for m in model.modules() if getattr(m, "ring", False)
             for p in m.resblocks.parameters() if p.grad is not None]
    _all_reduce(grads, axis.group)
