"""The benchmark and profile twins on the CPU at test-tiny: ``vtc_tpu_torch.
bench`` (its FLOP count against ``torch.utils.flop_counter.FlopCounterMode``,
its JSON line against ``bench.py``'s keys), ``scripts.profile_eval``,
``scripts.bench_video_eval`` and ``scripts.bench_optim_update`` once each,
the trace window (``VTC_TRACE=1``) of ``bench_train_step`` and
``bench_video_eval``,
the video pipeline's ``VTC_REMAT`` default, and the checkpoint refusal. No
number here is a device metric: the card's come from ``chip_smoke.py``.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vtc_tpu_torch import bench
from vtc_tpu_torch.models import create_model
from vtc_tpu_torch.models.clip_model import CLIP_VARIANTS
from vtc_tpu_torch.scripts import bench_optim_update, bench_video_eval, profile_eval
from vtc_tpu_torch.training import load_checkpoint

TINY = "test-tiny"
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread in the test process, as in the spawned ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("batch,ntoks", [(3, 16), (5, 77)])
def test_forward_flops_match_the_flop_counter(batch, ntoks):
    """Every GEMM of the eval forward on the CPU (the plain attention's
    einsums included) is what ``forward_flops`` counts from the shapes."""
    v = CLIP_VARIANTS[TINY]
    model = create_model("PretrainedCLIP_finaltf", model_type=TINY, device="cpu").eval()
    inputs = bench.bench_inputs(v, batch, ntoks, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(*inputs)
    assert counter.get_total_flops() == bench.forward_flops(v, batch, ntoks)


def _bench_py_keys():
    """The keys of ``bench.py``'s result dict, read from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
              and node.value.id == "result" and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def test_bench_line_has_bench_py_keys(capsys, monkeypatch):
    """Every branch of ``bench.main``; its train companion and full-context
    pass run through the real code at batch 4 and 1 iteration, since their
    sizes are the card's, not ``BENCH_BATCH``'s."""
    from vtc_tpu_torch.scripts import bench_train_step

    run, train = bench.run, bench_train_step.main

    def small_run(batch, iters, warmup, dtype_name, ntoks=16, **kw):
        if ntoks == 77:  # the full-context pass
            batch, iters, warmup, kw["windows"] = 4, 1, 0, 1
        return run(batch, iters, warmup, dtype_name, ntoks, **kw)

    def small_train(batch, ntoks, **kw):
        return train(4, ntoks, **dict(kw, iters=1, warmup=0, windows=1))

    monkeypatch.setattr(bench, "run", small_run)
    monkeypatch.setattr(bench_train_step, "main", small_train)
    env = {"BENCH_BATCH": "4", "BENCH_ITERS": "1"}
    result = bench.main(env, device="cpu", flagship=TINY)
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and json.loads(line[0]) == result
    want = {"metric", "value", "unit", "vs_baseline", "full_context_pairs_per_sec",
            "quality_parity", "mfu", "train_samples_per_sec", "train_mfu"}
    assert want <= _bench_py_keys()
    assert want <= set(result) and result["device"] == "cpu"
    assert result["value"] > 0 and result["vs_baseline"] > 0
    assert result["mfu"] is None and result["train_mfu"] is None  # no card, no peak
    single = bench.main(dict(env, BENCH_MODEL=TINY), device="cpu", flagship="ViT-B/32")
    assert single["model"] == TINY and single["vs_baseline"] is None


def test_no_tpu_peak_in_the_port():
    """The port's MFU is against the card's peak; the TPU figure of
    ``bench.py`` (197 TFLOP/s) appears nowhere in the package."""
    for f in (ROOT / "vtc_tpu_torch").rglob("*.py"):
        text = f.read_text()
        assert "197e12" not in text and "197 TFLOP" not in text, f


def test_profile_eval_runs():
    ms = profile_eval.main(batch=2, iters=1, model_type=TINY, device="cpu", log=lambda m: None)
    assert set(ms) == {"full", "image", "text_x6", "title", "cam"}
    assert all(t > 0 for t in ms.values())


@pytest.mark.parametrize("patches", ["0", "1"])
def test_profile_trace_runs(monkeypatch, patches):
    """The ``profile_trace`` twin at test-tiny on the CPU (the CPU's
    operators in place of the card's kernels), NCHW bf16 images and the
    uint8 patch input: the families, the top kernels and the idle share."""
    from vtc_tpu_torch.scripts import profile_trace

    monkeypatch.setenv("VTC_PROFILE_PATCHES", patches)
    lines = []
    prof = profile_trace.main(batch=2, iters=2, model_type=TINY, device="cpu",
                              log=lines.append)
    assert prof["family_ms"] and all(ms >= 0 for ms in prof["family_ms"].values())
    assert 0 < len(prof["kernel_ms"]) <= profile_trace.TOP
    assert 0 <= prof["idle_share"] < 1 and prof["launches"] > 0
    assert any(line.startswith("profile bf16 batch 2, 2 forwards") for line in lines)
    assert sum(line.startswith("profile device ms per forward:") for line in lines) == len(
        prof["family_ms"])
    assert profile_trace.family("triton_per_fused_ln_kernel_0") == "layernorm"
    assert profile_trace.family("x_addln_kernel") == "add_layernorm"
    assert profile_trace.family("fused_mha_long_onepass_kernel<64>") == "fused_mha_long"
    assert profile_trace.family("nvjet_tst_128x64") == "gemm"


def test_bench_video_eval_runs():
    out = bench_video_eval.main(batch=2, frames=2, iters=1, warmup=1, model_type=TINY,
                                device="cpu", log=lambda m: None)
    assert out["videos_per_s"] > 0 and len(out["window_rates"]) == 3


@pytest.mark.parametrize("script", ["bench_train_step", "bench_video_eval"])
def test_bench_twins_trace_one_window(monkeypatch, script):
    """``VTC_TRACE=1``: after the warm-up one window of ``iters`` calls runs
    under the profiler (the CPU's operators standing in for the card's
    kernels), printed as ``profile_trace`` prints it (top kernels, families,
    idle share), and its profile comes back in place of the rates."""
    from vtc_tpu_torch.scripts import bench_train_step, profile_trace

    monkeypatch.setenv("VTC_TRACE", "1")
    lines = []
    if script == "bench_train_step":
        out = bench_train_step.main(batch=4, iters=2, warmup=1, model_type=TINY,
                                    device="cpu", log=lines.append)
        assert len(out["losses"]) == 3 and "samples_per_s" not in out
        what = "train step batch 4, accum_steps 1"
    else:
        out = bench_video_eval.main(batch=2, frames=2, iters=2, warmup=1, model_type=TINY,
                                    device="cpu", log=lines.append)
        assert "videos_per_s" not in out
        what = "video eval batch 2, 2 frames"
    prof = out["profile"]
    assert prof["family_ms"] and all(ms >= 0 for ms in prof["family_ms"].values())
    assert 0 < len(prof["kernel_ms"]) <= profile_trace.TOP
    assert 0 <= prof["idle_share"] < 1 and prof["launches"] > 0
    assert lines[0] == f"top {len(prof['kernel_ms'])} kernels by self device time, ms per " \
                       f"call ({what}):"
    assert any(line.startswith(f"profile {what}, 2 forwards") for line in lines)
    assert sum(line.startswith("profile device ms per forward:") for line in lines) == len(
        prof["family_ms"])


def test_bench_optim_update_runs():
    out = bench_optim_update.main(iters=1, model_type=TINY, device="cpu",
                                  log=lambda m: None)
    model = create_model("PretrainedCLIP_finaltf", model_type=TINY, device="cpu")
    assert out["params"] == sum(p.numel() for p in model.parameters())
    assert all(out[k] > 0 for k in ("adam_ms", "bf16_moments_ms", "merged_ms"))


def test_merged_adam_step_is_amsgrad():
    """The merged buffer's math is ``torch.optim.Adam(amsgrad=True)``'s."""
    rng = np.random.default_rng(0)
    p0 = torch.from_numpy(rng.normal(size=1000).astype(np.float32))
    state = {"p": p0.clone(), "t": 0,
             **{k: torch.zeros(1000) for k in ("mu", "nu", "numax")}}
    ref = p0.clone().requires_grad_()
    opt = torch.optim.Adam([ref], lr=bench_optim_update.LR, amsgrad=True)
    for step in range(3):
        g = torch.from_numpy(rng.normal(size=1000).astype(np.float32))
        bench_optim_update.merged_adam_step(state, g)
        ref.grad = g
        opt.step()
    torch.testing.assert_close(state["p"], ref.detach(), atol=1e-7, rtol=1e-6)


def test_video_pipeline_takes_remat_by_default(monkeypatch):
    """The video pipeline twin measures the step the JAX script measures:
    ``VTC_REMAT=1`` unless the caller set it."""
    import os

    from vtc_tpu_torch.scripts import bench_video_pipeline

    monkeypatch.delenv("VTC_REMAT", raising=False)
    with bench_video_pipeline.remat_default():
        assert os.environ["VTC_REMAT"] == "1"
    assert "VTC_REMAT" not in os.environ  # the caller's environment, as it was
    monkeypatch.setenv("VTC_REMAT", "0")
    with bench_video_pipeline.remat_default():
        assert os.environ["VTC_REMAT"] == "0"


@pytest.mark.parametrize("host", [True, False])
def test_video_pipeline_host_pass_is_optional(tmp_path, host):
    """``host=False`` leaves out the loader-alone pass (a second run under
    another ``VTC_REMAT`` repeats only the step); ``host=True`` counts every
    clip of every epoch."""
    from vtc_tpu_torch.scripts import bench_video_pipeline

    # 10 videos: the training split holds 2 of them
    csv_file, root = bench_video_pipeline.make_corpus(str(tmp_path), 10, w=64, h=48)
    res = bench_video_pipeline.main(workers=0, batch=2, epochs=2, csv_file=csv_file,
                                    root=root, log=lambda msg: None, host=host)
    assert (res["host_videos_per_s"] is not None) == host
    assert res["host_videos_per_s"] is None or res["host_videos_per_s"] > 0
    assert res["device_videos_per_s"] is res["meets_demand"] is None


def test_checkpoint_directory_refusal_names_the_export(tmp_path):
    with pytest.raises(NotImplementedError, match="Orbax.*export_torch_checkpoint.py"):
        load_checkpoint(tmp_path)
