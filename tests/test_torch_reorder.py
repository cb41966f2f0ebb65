"""The data axis's reorder floor of ``chip_smoke.py`` phase 11's step on the
card, read per leaf (``chip_smoke.reorder_floor``), at the CAM's last
LayerNorm weight: the worst leaf of the split steps of phases 38-42.

The floor that holds every split step (8× the whole step's largest share
when phase 11's batch has its two halves swapped) reads 0 at that leaf:
a swap of two halves commutes at the top of each reduction over the batch
and keeps every GEMM's shape. Phase 11's step in two microbatches of half
the rows (GradCache at ``accum_steps`` 2: the shapes a data rank's GEMMs
see) moves it, as the split steps do. The test pins both readings. Card
only (``-m cuda``; no JAX import, so it collects with ``--noconftest``).
"""

import pytest
import torch


@pytest.mark.cuda
def test_swap_floor_is_blind_to_the_cam_last_layernorm_weight():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the floor is the card's")
    import chip_smoke as c
    from vtc_tpu_torch import ops
    from vtc_tpu_torch.models.cam import draw_adapter_skip

    inputs = c.bench_inputs(c.PARITY_BATCH, 32, seed=6)
    skip = draw_adapter_skip(c.PARITY_BATCH, torch.Generator().manual_seed(6))
    one = c.train_run(ops, "cuda", inputs, [{"adapter_skip": skip}])
    half = c.PARITY_BATCH // 2
    order = torch.cat([torch.arange(half, c.PARITY_BATCH), torch.arange(half)])
    swap = c.train_run(ops, "cuda", [x[order] for x in inputs], [{"adapter_skip": skip[order]}])
    split = c.train_run(ops, "cuda", inputs,
                        [[{"adapter_skip": skip[i::2]} for i in range(2)]], accum_steps=2)
    assert c.leaf_shares(swap["grads"], one["grads"])[c.CAM_LAST_LN] == 0
    assert c.leaf_shares(split["grads"], one["grads"])[c.CAM_LAST_LN] > 1e-6
