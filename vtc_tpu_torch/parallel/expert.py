"""A mixture-of-experts MLP on one device.

Port of ``vtc_tpu/parallel/expert.py:MoEMLP`` without its mesh (an expert
mesh, ``create_ep_mesh`` and the expert shardings wait for the port of
distribution, ``device.DISTRIBUTION``). The math is the JAX package's,
GShard/Switch dispatch:

* the router in fp32: ``probs = softmax(x @ router)``;
* top-k experts per token, ties broken by the lower index as
  ``jax.lax.top_k`` breaks them (a stable descending sort), with the gates
  renormalized over the k selected;
* capacity ``ceil(cf · k · T / nE)`` over the ``T`` tokens of the call; slot
  ``s`` of every token queues after all slot ``< s`` assignments, in token
  order, and a token whose queue position reaches the capacity is dropped
  (its output is zero);
* each expert's FFN ``E -> 4E -> QuickGELU -> E`` as batched products on the
  dispatched ``[nE, C, E]``;
* the load-balance loss ``nE · Σ_e f_e · P_e`` (``f``: the share of tokens
  whose first choice is ``e``; ``P``: the mean router probability), kept in
  ``aux_loss`` after each call for the train step to add.

The JAX package dispatches and combines with one-hot products; here they are
an index scatter and gather, which select the same entries: in fp32 a one-hot
product adds exact zeros to the one term it selects.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from ..models.layers import quick_gelu


def route(probs: torch.Tensor, top_k: int, capacity: int):
    """Routing of ``probs`` [T, nE] -> ``(idx, gates, pos, keep)``, each
    [T, k]: the experts in descending probability (ties to the lower
    index), the renormalized gates, each assignment's queue position in its
    expert and whether it is within ``capacity``."""
    n_exp = probs.shape[-1]
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :top_k], idx[:, :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    counts = torch.zeros(n_exp, dtype=torch.long, device=probs.device)
    pos = []
    for s in range(top_k):
        one_hot = nn.functional.one_hot(idx[:, s], n_exp)  # [T, nE]
        queue = torch.cumsum(one_hot, dim=0) - 1 + counts
        counts = counts + one_hot.sum(dim=0)
        pos.append(torch.gather(queue, 1, idx[:, s:s + 1])[:, 0])
    pos = torch.stack(pos, dim=1)
    return idx, gates, pos, pos < capacity


class MoEMLP(nn.Module):
    """Drop-in mixture-of-experts replacement for ``layers.MLPBlock``:
    ``n_experts`` FFNs of ``MLPBlock``'s shape, ``top_k`` per token.
    Parameters: ``router`` [E, nE], ``w_fc`` [nE, E, 4E], ``bias_fc``
    [nE, 4E], ``w_proj`` [nE, 4E, E], ``bias_proj`` [nE, E] (the JAX
    package's layout)."""

    def __init__(self, width: int, n_experts: int, top_k: int = 1,
                 capacity_factor: float = 1.25, dtype=torch.float32):
        super().__init__()
        n_experts, top_k = int(n_experts), int(top_k)
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"router_top_k={top_k} with {n_experts} experts")
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        e = width
        self.router = nn.Parameter(torch.empty(e, n_experts))
        self.w_fc = nn.Parameter(torch.empty(n_experts, e, 4 * e))
        self.bias_fc = nn.Parameter(torch.zeros(n_experts, 4 * e))
        self.w_proj = nn.Parameter(torch.empty(n_experts, 4 * e, e))
        self.bias_proj = nn.Parameter(torch.zeros(n_experts, e))
        self.aux_loss: Optional[torch.Tensor] = None

    def capacity(self, tokens: int) -> int:
        return int(math.ceil(self.capacity_factor * self.top_k * tokens / self.n_experts))

    def forward(self, x):
        lead, e = x.shape[:-1], x.shape[-1]
        xt = x.reshape(-1, e)
        t, n_exp, cap = xt.shape[0], self.n_experts, self.capacity(xt.shape[0])
        probs = torch.softmax(xt.float() @ self.router.float(), dim=-1)
        idx, gates, pos, keep = route(probs, self.top_k, cap)
        top1 = nn.functional.one_hot(idx[:, 0], n_exp).float()
        self.aux_loss = n_exp * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))

        # dispatch: token t's slot s lands at [expert, position] of [nE, C, E]
        dt = self.dtype
        tok = torch.arange(t, device=x.device)[:, None].expand(-1, self.top_k)
        kept_tok, kept_e, kept_pos = tok[keep], idx[keep], pos[keep]
        xe = xt.new_zeros((n_exp, cap, e), dtype=dt)
        xe[kept_e, kept_pos] = xt[kept_tok].to(dt)
        h = torch.bmm(xe, self.w_fc.to(dt)) + self.bias_fc.to(dt)[:, None]
        out = torch.bmm(quick_gelu(h), self.w_proj.to(dt)) + self.bias_proj.to(dt)[:, None]

        # combine: the gate-weighted sum of each token's kept expert outputs,
        # gates in the activation dtype and the sum in fp32, as the JAX
        # one-hot product accumulates
        w = (gates.to(dt).float() * keep)[..., None]  # [T, k, 1]
        sel = out[idx, pos.clamp(max=cap - 1)].float()  # [T, k, E]
        y = (w * sel).sum(dim=1).to(dt)
        return y.reshape(*lead, e)


def moe_layers(model: nn.Module) -> List[MoEMLP]:
    """The model's ``MoEMLP`` layers (empty for a dense model)."""
    return [m for m in model.modules() if isinstance(m, MoEMLP)]
