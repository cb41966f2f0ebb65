"""The replica axis of the port (``vtc_tpu_torch.parallel.mesh.create_mesh(...,
n_replica=R)``, ``train.py --slices``) on the CPU: one spawn of 4 ranks of a
gloo group from ``tests/torch_dist_ranks.py`` (torch on one thread), laid
out as ``create_mesh(1, 2, n_replica=2)``, then ``create_mesh(2, 1,
n_replica=2)``, against ``vtc_tpu.parallel.mesh.create_mesh``'s layout and
the port's one-process step, computed in the test process beside them.

* The mesh's axes: ``("replica", "data", "model")``, rank ``r·D·M + d·M +
  m`` as ``vtc_tpu``'s devices; the batch axis is the flattened replica ×
  data group of each model place, ranked ``r·D + d`` (``batch_pspec``'s
  ``P(("replica", "data"))``).
* The flagship's 2 train steps at replica2×dp1×tp2 and, under ``--fsdp``, at
  replica2×dp2 (FSDP2's HSDP: sharded over data, replicated over replica),
  against the one-process step: losses within 2e-6, step-1 gradients within
  the model axis's reorder floor (1e-5 of each parameter's largest), every
  rank's parameters equal after.
* Under HSDP each rank holds half of each parameter and of each Adam moment
  (its data rank's rows), the same half as its replica twin.
* The train twin at ``--slices 2 --n_devices 2 --fsdp 1``: a single-card
  ``.pth`` gathered from the HSDP shards that a whole model loads strictly,
  and a resume that restores it.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from test_torch_pipeline import _cli_config, _inputs, _state_dict

GRAD_RTOL = 1e-5  # the model axis's reorder floor (tests/test_torch_tp.py)
LOSS_ATOL = 2e-6
TIMEOUT = 300
MESHES = {"replica2xdp1xtp2": (2, 1, 2), "replica2xdp2": (2, 2, 1)}


@pytest.fixture(scope="module")
def slices_runs(tmp_path_factory):
    """The spawn of 4 ranks (``R.run_slices``) beside the one-process step;
    returns (the one-process step, each rank's results)."""
    tmp = tmp_path_factory.mktemp("slices")
    gen = torch.Generator().manual_seed(3)
    skip = [{"adapter_skip": torch.rand((8, 1), generator=gen) > 0.5} for _ in range(2)]
    case = dict(state_dict=_state_dict(), data=_inputs(), steps=2, draws=skip)
    _cli_config(tmp)
    torch.save({"meshes": [("replica2xdp1xtp2", MESHES["replica2xdp1xtp2"], {"plain": case}),
                           ("replica2xdp2", MESHES["replica2xdp2"],
                            {"fsdp": dict(case, fsdp=True)})],
                "cli": True}, tmp / "slices.pt")
    context = R.spawn(R.run_slices, 4, tmp, join=False)
    single = R.step_case(case)
    R.wait(context, timeout=TIMEOUT)
    return single, [torch.load(tmp / f"slices_rank{r}.pt", weights_only=False)
                    for r in range(4)]


@pytest.mark.parametrize("name", list(MESHES))
def test_replica_mesh_lays_ranks_out_as_vtc_tpu(slices_runs, name):
    import jax

    from vtc_tpu.parallel.mesh import create_mesh as jax_create_mesh

    n_replica, n_data, n_model = MESHES[name]
    jax_mesh = jax_create_mesh(n_data, n_model, devices=jax.devices()[:4], n_replica=n_replica)
    ids = np.vectorize(lambda d: d.id)(jax_mesh.devices)
    _, ranks = slices_runs
    for r, out in enumerate(ranks):
        axes = out[name]["axes"]
        assert axes["names"] == tuple(jax_mesh.axis_names) == ("replica", "data", "model")
        np.testing.assert_array_equal(axes["ranks"].numpy(), ids)
        rep, d, m = (int(i[0]) for i in np.nonzero(ids == r))
        assert axes["model"] == (m, n_model)
        # the batch axis: this model place's ranks, replica-major
        assert axes["data"] == (rep * n_data + d, n_replica * n_data)
        assert axes["data_ranks"] == ids[:, :, m].flatten().tolist()


@pytest.mark.parametrize("name, case", [("replica2xdp1xtp2", "plain"),
                                        ("replica2xdp2", "fsdp")])
def test_slices_step_matches_one_rank(slices_runs, name, case):
    single, ranks = slices_runs
    for out in ranks:
        res = out[name][case]
        np.testing.assert_allclose(res["losses"], single["losses"], atol=LOSS_ATOL, rtol=0)
        assert sorted(res["grads"]) == sorted(single["grads"])
        for n, g in single["grads"].items():
            assert (res["grads"][n] is None) == (g is None), n
            if g is not None:
                err = float((res["grads"][n] - g).abs().max())
                assert err <= GRAD_RTOL * float(g.abs().max()), (n, err)
        for n, p in res["params"].items():  # every replica, data and model rank alike
            assert torch.equal(p, ranks[0][name][case]["params"][n]), n


def test_hsdp_rank_holds_half_of_each_parameter_and_moment(slices_runs):
    """Each rank holds its data rank's ⌈n/2⌉ (or the rest) dim-0 rows of
    every parameter and moment, whichever replica it sits in, and about
    half of the bytes; ``logit_scale`` (0-dim) stays whole."""
    _, ranks = slices_runs
    held = whole = 0
    for r, out in enumerate(ranks):
        res = out["replica2xdp2"]["fsdp"]
        d = out["replica2xdp2"]["axes"]["data"][0] % 2
        twin = ranks[r ^ 2]["replica2xdp2"]["fsdp"]  # the other replica's same data rank
        for n, full in res["params"].items():
            local = res["local_params"][n]
            if full.dim() == 0:
                assert local.shape == full.shape, n
                continue
            rows = math.ceil(full.shape[0] / 2)
            want = rows if d == 0 else full.shape[0] - rows
            assert local.shape == (want,) + full.shape[1:], n
            assert torch.equal(local, full[d * rows:d * rows + want]), n
            assert torch.equal(local, twin["local_params"][n]), n
            for k, shape in res["local_moments"].get(n, {}).items():
                assert shape == tuple(local.shape), (n, k)
            held += local.numel()
            whole += full.numel()
    assert 0.5 <= held / whole <= 0.5005


def test_twin_at_slices2_fsdp_writes_single_card_checkpoints(slices_runs):
    from vtc_tpu_torch.training import load_checkpoint

    _, ranks = slices_runs
    outs = [out["cli"] for out in ranks]
    assert all(o["dirs"] == outs[0]["dirs"] and o["start"] == 2 for o in outs)
    ckpt = load_checkpoint(Path(outs[0]["dirs"][0]) / "checkpoint-epoch1.pth")
    model = R.flagship_port(ckpt["state_dict"], random_skip_adapter=False)  # strict
    for o in outs:
        state, opt = o["resumed"][0]
        for n, p in model.state_dict().items():
            assert torch.equal(state[n], p) and torch.equal(o["epochs"][0][n], p), n
        assert opt["state"].keys() == ckpt["optimizer"]["state"].keys()
        for i, entry in ckpt["optimizer"]["state"].items():
            for k, v in entry.items():
                assert torch.equal(opt["state"][i][k], v), (i, k)


def test_slices_compose_with_dp_tp_and_fsdp(caplog):
    from vtc_tpu_torch.parallel.mesh import check_axes, check_data_devices, create_mesh

    check_axes(2, slices=2)
    check_axes(1, slices=4, fsdp=True)
    check_axes(2, slices=2, fsdp=True)
    with pytest.raises(ValueError, match="composes with dp/tp/fsdp"):
        check_axes(1, sp=2, slices=2)
    # no group: a machine with fewer cards warns and runs unsharded
    check_data_devices(2, torch.device("cpu"), __import__("logging").getLogger("t"),
                       "training", "vtc_tpu_torch.train", 1, "--n_model", 2)
    assert "2x2x1 (slices x data x second-axis)" in caplog.text
    with pytest.raises(RuntimeError, match="--slices 2"):
        create_mesh(2, 1, n_replica=2, device="cpu")
