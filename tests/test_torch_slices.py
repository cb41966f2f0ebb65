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
* The multi-chip dry run's twin (``vtc_tpu_torch.scripts.dryrun_multichip``,
  ``__graft_entry__.dryrun_multichip``) at N = 4 in the same spawn, fed the
  weights and the adapter-skip draws of JAX's one-device ``make_step_fns``
  step of the TimeSformer flagship: its dp×tp loss within rtol 2e-5 of
  JAX's, each of its checks at the JAX function's limits, the current mesh
  and the stacks' switch left as it found them.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from test_torch_pipeline import _cli_config, _inputs, _state_dict
from vtc_tpu_torch.scripts import dryrun_multichip as D

GRAD_RTOL = 1e-5  # the model axis's reorder floor (tests/test_torch_tp.py)
LOSS_ATOL = 2e-6
TIMEOUT = 300
MESHES = {"replica2xdp1xtp2": (2, 1, 2), "replica2xdp2": (2, 2, 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread in the test process, as in the spawned ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def slices_runs(tmp_path_factory):
    """The spawn of 4 ranks (``R.run_slices``) beside the one-process step
    and JAX's step of the dry run, whose weights and draws the ranks wait
    for after their own groups; returns (the one-process step, each rank's
    results, JAX's dry-run step)."""
    tmp = tmp_path_factory.mktemp("slices")
    gen = torch.Generator().manual_seed(3)
    skip = [{"adapter_skip": torch.rand((8, 1), generator=gen) > 0.5} for _ in range(2)]
    case = dict(state_dict=_state_dict(), data=_inputs(), steps=2, draws=skip)
    _cli_config(tmp)
    torch.save({"meshes": [("replica2xdp1xtp2", MESHES["replica2xdp1xtp2"], {"plain": case}),
                           ("replica2xdp2", MESHES["replica2xdp2"],
                            {"fsdp": dict(case, fsdp=True)})],
                "cli": True, "dryrun": True}, tmp / "slices.pt")
    context = R.spawn(R.run_slices, 4, tmp, join=False)
    single = R.step_case(case)
    jax_run = _jax_dryrun_step()
    torch.save(jax_run, tmp / "dryrun.part")
    (tmp / "dryrun.part").replace(tmp / "dryrun.pt")  # whole when it appears
    R.wait(context, timeout=TIMEOUT)
    return single, [torch.load(tmp / f"slices_rank{r}.pt", weights_only=False)
                    for r in range(4)], jax_run


def _jax_dryrun_step():
    """``__graft_entry__.dryrun_multichip``'s dp×tp step on one device:
    ``make_step_fns``' step of the test-tiny TimeSformer flagship (4 frames)
    on the dry run's batch at N = 4 with its optimizer and
    ``PRNGKey(0)``, on the port's seeded weights brought over by
    ``vtc_tpu``'s ``import_vtc_state_dict`` (no JAX init to compile): its
    loss, and the weights (``state_dict_from_jax`` of its params) and
    adapter-skip draws (read from its output) for the port's dry run."""
    import jax
    import jax.numpy as jnp

    from test_torch_training import _skipped_rows
    from vtc_tpu.models.factory import ARCHS
    from vtc_tpu.models.torch_import import import_vtc_state_dict
    from vtc_tpu.ops.losses import clip_loss
    from vtc_tpu.training.optim import build_optimizer
    from vtc_tpu.training.trainer import TrainState, make_step_fns
    from vtc_tpu_torch.models import create_model
    from vtc_tpu_torch.models.from_jax import state_dict_from_jax

    port = create_model("PretrainedCLIP_TimeSformer_finaltf", model_type=R.TINY,
                        nframes=D.NFRAMES, device="cpu").state_dict()
    params = import_vtc_state_dict({k: v.numpy() for k, v in port.items()},
                                   timesformer=True)["params"]
    module = ARCHS["PretrainedCLIP_TimeSformer_finaltf"](model_type=R.TINY,
                                                         nframes=D.NFRAMES)
    tx = build_optimizer(params, D.OPTIMIZER, D.SCHEDULER, steps_per_epoch=4,
                         adapter_lr=1e-2, time_lr=1e-4)
    step, evaluate = make_step_fns(module, clip_loss, tx, donate=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams), batch_stats={})
    data = D._Checks("cpu", 4, None, None).data  # default_rng(0)'s, as the JAX function's
    title = evaluate(state, data, {}, branch_override="skip")[1][1]
    _, loss, out = step(state, data, {}, jax.random.PRNGKey(0))
    draws = {"adapter_skip": _skipped_rows(out[1], title)}
    return {"loss": float(loss), "draws": draws,
            "state_dict": state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))}


@pytest.mark.parametrize("name", list(MESHES))
def test_replica_mesh_lays_ranks_out_as_vtc_tpu(slices_runs, name):
    import jax

    from vtc_tpu.parallel.mesh import create_mesh as jax_create_mesh

    n_replica, n_data, n_model = MESHES[name]
    jax_mesh = jax_create_mesh(n_data, n_model, devices=jax.devices()[:4], n_replica=n_replica)
    ids = np.vectorize(lambda d: d.id)(jax_mesh.devices)
    _, ranks, _ = slices_runs
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
    single, ranks, _ = slices_runs
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
    _, ranks, _ = slices_runs
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

    _, ranks, _ = slices_runs
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


# (the dry run's number, its limit against the reference): the losses at
# rtol 2e-5 of step 1's, the stacks and the MoE layer at atol 2e-5
DRYRUN_CHECKS = {"fsdp_loss": "loss", "slices_loss": "loss", "pp_loss": "loss",
                 "sp_loss": "loss", "moe_ep_loss": "moe_ref_loss",
                 "accum_loss": "plain_loss", "pp_stack_err": None, "sp_stack_err": None,
                 "ep_layer_err": None}


def test_dryrun_multichip_dp_tp_step_matches_jax(slices_runs):
    """The twin's dp×tp step (2×2 ranks), fed JAX's weights and draws, gives
    JAX's one-device loss within rtol 2e-5 on every rank; the CAM probe
    moved (or the twin would have raised) and R@1 is 1; the closing line is
    the JAX function's; the mesh and the switch are as the twin found
    them."""
    _, ranks, jax_run = slices_runs
    for out in ranks:
        run = out["dryrun"]
        np.testing.assert_allclose(run["loss"], jax_run["loss"], rtol=D.RTOL)
        assert dict(run["recalls"])[1] == 1.0
        assert run["line"].startswith("dryrun_multichip(4) ok: mesh=DeviceMesh(")
        assert run["line"].endswith("accum2 loss exact on the dp mesh")
        assert run["kept"]
        # every rank of a group the same numbers (the launches: none on the CPU)
        assert {k: v for k, v in run.items() if k not in ("kept",)} == {
            k: v for k, v in ranks[0]["dryrun"].items() if k not in ("kept",)}
        assert all(not any(c.values()) for c in run["launches"].values())


@pytest.mark.parametrize("key", list(DRYRUN_CHECKS))
def test_dryrun_multichip_checks_hold_the_jax_limits(slices_runs, key):
    _, ranks, _ = slices_runs
    for out in ranks:
        run, ref = out["dryrun"], DRYRUN_CHECKS[key]
        if ref is None:
            assert 0 <= run[key] <= D.ATOL, (key, run[key])
        else:
            np.testing.assert_allclose(run[key], run[ref], rtol=D.RTOL, err_msg=key)


def test_dryrun_multichip_embedding_shard(slices_runs):
    """ZeRO-3 on the 2×2 mesh: the token embedding's local shard is a
    quarter of the table (a half over model, a half of that over data)."""
    _, ranks, _ = slices_runs
    for out in ranks:
        shard, table = out["dryrun"]["emb_shard"]
        assert shard * 4 == table


def test_dryrun_multichip_cli_needs_a_card_or_the_cpu(monkeypatch, capsys):
    """Without a card and without ``--device cpu`` the twin raises, never
    dropping to the CPU; ``main`` prints the checks' closing line."""
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.run(4)
    monkeypatch.setattr(D, "run", lambda n, device: {"line": f"dryrun_multichip({n}) ok: x",
                                                     "backend": "gloo"})
    D.main(["4", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("dryrun_multichip(4) ok: x; gloo ")
