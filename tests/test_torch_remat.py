"""``VTC_REMAT=1`` on the CPU: the port's transformer blocks under
``torch.utils.checkpoint`` give the plain step's loss and gradients (fp32,
within 1e-6), for the flagship and the TimeSformer at test-tiny, and the
flagship's step gives the loss of JAX's step under the same switch
(``make_step_fns`` with ``nn.remat`` blocks), atol 1e-5 as
tests/test_torch_training.py's steps. The CAM (and the TimeSformer's
temporal branch) are moved off their zero-init by seeded noise so every
block takes part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.models.retrieval import PretrainedCLIP_finaltf as JaxFlagship
from vtc_tpu.ops import losses as jax_losses
from vtc_tpu_torch.data import extract_patches, synthetic_tokens
from vtc_tpu_torch.models import create_model, state_dict_from_jax
from vtc_tpu_torch.models.layers import ResidualAttentionBlock, use_remat
from vtc_tpu_torch.models.retrieval import PretrainedCLIP_finaltf
from vtc_tpu_torch.models.timesformer import TimeSformerBlock
from vtc_tpu_torch.ops import losses
from vtc_tpu_torch.training import build_optimizer, train_step

TINY = "test-tiny"
GRAD_ATOL = 1e-6


def _inputs(batch=6, seed=0, frames=0):
    rng = np.random.default_rng(seed)
    lead = (batch, frames) if frames else (batch,)
    vis = extract_patches(rng.integers(0, 256, lead + (32, 32, 3), dtype=np.uint8), 8)
    title = synthetic_tokens((batch,), 16, 14, rng)
    comments = synthetic_tokens((batch, 5), 16, 14, rng)
    return [torch.from_numpy(a) for a in (vis, title, comments)]


def _perturbed(model, seed=0):
    """Every zero-init weight (the CAM's projections, ``temporal_fc``,
    ``temporal_embed``) moved by seeded noise."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("final_") or "temporal" in name:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _loss_and_grads(model, data, monkeypatch, remat: bool):
    """One training forward (the adapter-skip draws from a generator seeded
    alike), ``clip_loss`` and its backward; counts each block's forwards."""
    monkeypatch.setenv("VTC_REMAT", "1" if remat else "0")
    assert use_remat() == remat
    calls = []
    # a pre-hook: the recompute stops once it has what the backward needs
    hooks = [m.register_forward_pre_hook(lambda *_: calls.append(1))
             for m in model.modules()
             if isinstance(m, (ResidualAttentionBlock, TimeSformerBlock))]
    model.zero_grad(set_to_none=True)
    out = model(*data, generator=torch.Generator().manual_seed(3))
    loss = losses.clip_loss(out)
    forwards = len(calls)
    loss.backward()
    for h in hooks:
        h.remove()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return loss.item(), grads, forwards, len(calls) - forwards


@pytest.mark.parametrize("arch,frames", [("PretrainedCLIP_finaltf", 0),
                                         ("PretrainedCLIP_TimeSformer_finaltf", 4)])
def test_remat_gives_the_plain_step(monkeypatch, arch, frames):
    kwargs = {"nframes": frames} if frames else {}
    model = _perturbed(create_model(arch, model_type=TINY, device="cpu", **kwargs)).train()
    data = _inputs(frames=frames)
    loss, grads, fwd, recomputed = _loss_and_grads(model, data, monkeypatch, remat=False)
    assert recomputed == 0
    loss_r, grads_r, fwd_r, recomputed_r = _loss_and_grads(model, data, monkeypatch,
                                                           remat=True)
    # each block runs again in the backward, and only under the switch
    assert fwd_r == fwd and recomputed_r == fwd
    assert abs(loss_r - loss) <= GRAD_ATOL
    assert sorted(grads_r) == sorted(grads)
    for name, g in grads.items():
        torch.testing.assert_close(grads_r[name], g, atol=GRAD_ATOL, rtol=0, msg=name)


def test_remat_off_without_a_gradient(monkeypatch):
    """Inference takes no checkpoint: the blocks run once."""
    monkeypatch.setenv("VTC_REMAT", "1")
    model = create_model("PretrainedCLIP_finaltf", model_type=TINY, device="cpu").eval()
    calls = []
    for m in model.modules():
        if isinstance(m, ResidualAttentionBlock):
            m.register_forward_pre_hook(lambda *_: calls.append(1))
    with torch.no_grad():
        model(*_inputs(batch=2))
    assert len(calls) == 2 + 2 + 2  # vision, text, CAM


def test_remat_step_matches_jax_remat_step(monkeypatch):
    """One ``train_step`` of the flagship (adapter skip off) against
    ``make_step_fns``' step, both under ``VTC_REMAT=1``."""
    from vtc_tpu.training.optim import build_optimizer as jax_build_optimizer
    from vtc_tpu.training.trainer import TrainState, make_step_fns

    monkeypatch.setenv("VTC_REMAT", "1")
    _, variables = jax_create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=0)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    variables["params"])
    rng = np.random.default_rng(0)
    params["cam"] = jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), params["cam"])
    opt = {"type": "Adam", "args": {"lr": 1e-3, "amsgrad": True}}
    module = JaxFlagship(model_type=TINY, random_skip_adapter=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_build_optimizer(jparams, opt, None, steps_per_epoch=2)
    jax_step, _ = make_step_fns(module, jax_losses.clip_loss, tx, donate=False)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams), batch_stats={})
    data = _inputs(seed=1)
    _, loss_j, _ = jax_step(state, tuple(jnp.asarray(t.numpy()) for t in data), {},
                            jax.random.PRNGKey(0))
    port = PretrainedCLIP_finaltf(model_type=TINY, random_skip_adapter=False)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    optimizer, scheduler = build_optimizer(port, opt, None, steps_per_epoch=2)
    loss, _ = train_step(port, losses.clip_loss, optimizer, scheduler, data, {})
    np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-5, rtol=1e-5)
