"""The port's CLIP weight import and its ``train.py`` twin
(``vtc_tpu_torch.train``) against the JAX package's, on the CPU.

* Weight import: one seeded openai-layout test-tiny state dict in a file
  (plain, under ``{"state_dict": ...}``, and wrapped under ``model.`` as a
  reference retrieval checkpoint), loaded by ``vtc_tpu``'s
  ``create_model(clip_weights=...)`` and the port's: the port's ``model.*``
  state equals ``state_dict_from_jax`` of JAX's params exactly; the same
  through a tiny ``transformers.CLIPModel`` saved to a directory (the HF
  route) and for a TimeSformer arch (the tensors copied from CLIP); the CAM
  keeps its zero-init; ``VTC_CLIP_WEIGHTS`` is found; without
  ``transformers`` the HF route raises the same ``RuntimeError``.
* The twin against ``train.main`` on the corpus and config of
  ``tests/test_cli.py`` (``random_skip_adapter`` off), both starting from
  the JAX ``create_model``'s weights of the same seed: each epoch's train
  and validation loss within 1e-5 and the validation R@K equal over 2
  epochs (``test_trainer_matches_jax_trainer``'s tolerance); both write
  their epoch checkpoints.
* The refusals: ``loader: grain``, ``--multihost`` without the process
  topology ``torchrun`` exports, ``pp``, ``sp``, ``ep``, ``slices``, the
  R(2+1)D video datasets, ``--n_devices`` on a machine with
  the cards but no process group (the ``torchrun`` line); the unsharded
  warning on one without them; the MSRVTT probe off without its root.
  ``fsdp`` (alone and beside ``n_model``) passes the mesh check; its runs
  on a group are in ``tests/test_torch_fsdp.py``. The twin on a group's
  ranks is in ``tests/test_torch_dist.py``.
"""

import inspect
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax

from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu_torch import train as twin
from vtc_tpu_torch.config import ConfigParser
from vtc_tpu_torch.models import create_model, state_dict_from_jax
from vtc_tpu_torch.models.clip_import import openai_from_hf

REPO = Path(__file__).resolve().parents[1]
BASE36 = "0123456789abcdefghijklmnopqrstuvwxyz"
TINY = "test-tiny"
LOSS_ATOL = 1e-5  # test_torch_trainer.py::test_trainer_matches_jax_trainer


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _clip_state(model) -> dict:
    return {k: v for k, v in model.state_dict().items() if k.startswith("model.")}


def _seeded_openai_sd(seed=0, arch="PretrainedCLIP_finaltf"):
    """An openai-layout state dict at test-tiny: the port's ``model.*``
    names without the prefix, seeded normal values, and the TorchScript
    archive's three extra entries."""
    g = torch.Generator().manual_seed(seed)
    names = _clip_state(create_model(arch, model_type=TINY, device="cpu"))
    sd = {k[len("model."):]: torch.randn(v.shape, generator=g) for k, v in names.items()
          if ".temporal" not in k and ".timeattn." not in k and ".ln_time." not in k}
    sd.update(input_resolution=torch.tensor(32), context_length=torch.tensor(77),
              vocab_size=torch.tensor(49408))
    return sd


@pytest.mark.parametrize("wrap", ["plain", "state_dict", "model."])
def test_openai_weights_import_like_jax(tmp_path, wrap):
    sd = _seeded_openai_sd()
    obj = {"plain": sd, "state_dict": {"state_dict": sd},
           "model.": {"state_dict": {f"model.{k}": v for k, v in sd.items()}}}[wrap]
    path = tmp_path / "clip.pt"
    torch.save(obj, path)
    _, variables = jax_create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=1,
                                    clip_weights=str(path))
    ref = state_dict_from_jax(_np_tree(variables["params"]))
    model = create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=1,
                         clip_weights=str(path), device="cpu")
    ours = _clip_state(model)
    assert sorted(ours) == sorted(k for k in ref if k.startswith("model."))
    for k, v in ours.items():
        assert torch.equal(v, ref[k]), k
        assert torch.equal(v, sd[k[len("model."):]]), k
    assert not model.final_linear.weight.any()  # the CAM keeps its zero-init


def test_weights_found_through_the_environment(tmp_path, monkeypatch, caplog):
    sd = _seeded_openai_sd(seed=2, arch="PretrainedCLIP")
    torch.save(sd, tmp_path / "clip.pt")
    monkeypatch.setenv("VTC_CLIP_WEIGHTS", str(tmp_path / "clip.pt"))
    with caplog.at_level(logging.WARNING):
        model = create_model("PretrainedCLIP", model_type=TINY, device="cpu")
    assert "FALLBACK byte-level BPE" in caplog.text
    assert torch.equal(model.model.text_projection, sd["text_projection"])
    monkeypatch.setenv("VTC_CLIP_WEIGHTS", str(tmp_path / "absent.pt"))
    seeded = create_model("PretrainedCLIP", model_type=TINY, device="cpu")
    assert not torch.equal(seeded.model.text_projection, sd["text_projection"])


def test_missing_or_misshapen_weights_raise(tmp_path):
    sd = _seeded_openai_sd()
    del sd["ln_final.bias"]
    torch.save(sd, tmp_path / "short.pt")
    with pytest.raises(KeyError, match="ln_final.bias"):
        create_model("PretrainedCLIP_finaltf", model_type=TINY,
                     clip_weights=str(tmp_path / "short.pt"), device="cpu")
    sd = _seeded_openai_sd()
    sd["ln_final.bias"] = torch.zeros(3)
    torch.save(sd, tmp_path / "bad.pt")
    with pytest.raises(RuntimeError, match="size mismatch"):
        create_model("PretrainedCLIP_finaltf", model_type=TINY,
                     clip_weights=str(tmp_path / "bad.pt"), device="cpu")


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from transformers import CLIPConfig, CLIPModel

    config = CLIPConfig(
        projection_dim=32,
        text_config=dict(vocab_size=49408, hidden_size=64, intermediate_size=256,
                         num_hidden_layers=2, num_attention_heads=4,
                         max_position_embeddings=77, hidden_act="quick_gelu",
                         eos_token_id=49407, bos_token_id=49406),
        vision_config=dict(hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                           num_attention_heads=4, image_size=32, patch_size=8,
                           hidden_act="quick_gelu"),
    )
    torch.manual_seed(0)
    path = tmp_path_factory.mktemp("hf") / "hf_clip"
    CLIPModel(config).eval().save_pretrained(path)
    return str(path)


@pytest.mark.parametrize("arch", ["PretrainedCLIP_finaltf", "PretrainedCLIP"])
def test_hf_directory_imports_like_jax(hf_dir, arch):
    _, variables = jax_create_model(arch, model_type=TINY, seed=0, clip_weights=hf_dir)
    ref = state_dict_from_jax(_np_tree(variables["params"])) if "cam" in variables[
        "params"] else None
    model = create_model(arch, model_type=TINY, seed=0, clip_weights=hf_dir, device="cpu")
    ours = _clip_state(model)
    if ref is None:  # no CAM: state_dict_from_jax needs one; compare the CLIP tree
        params = _np_tree(variables["params"])
        params["cam"] = _np_tree(jax_create_model(
            "PretrainedCLIP_finaltf", model_type=TINY, seed=0)[1]["params"]["cam"])
        ref = state_dict_from_jax(params)
    for k, v in ours.items():
        assert torch.equal(v, ref[k]), k


def test_hf_names_map_onto_openai(hf_dir):
    from transformers import CLIPModel

    hf = CLIPModel.from_pretrained(hf_dir).state_dict()
    sd = openai_from_hf(hf)
    names = _clip_state(create_model("PretrainedCLIP_finaltf", model_type=TINY,
                                     device="cpu"))
    assert sorted(sd) == sorted(k[len("model."):] for k in names)
    assert torch.equal(sd["visual.proj"], hf["visual_projection.weight"].T)
    q = hf["vision_model.encoder.layers.1.self_attn.q_proj.weight"]
    assert torch.equal(sd["visual.transformer.resblocks.1.attn.in_proj_weight"][:64], q)


def test_hf_route_without_transformers_raises_as_jax(hf_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    for build in (lambda: jax_create_model("PretrainedCLIP_finaltf", model_type=TINY,
                                           clip_weights=hf_dir),
                  lambda: create_model("PretrainedCLIP_finaltf", model_type=TINY,
                                       clip_weights=hf_dir, device="cpu")):
        with pytest.raises(RuntimeError, match="transformers is unavailable"):
            build()


@pytest.mark.parametrize("arch", ["PretrainedCLIP_TimeSformer_finaltf",
                                  "PretrainedCLIP_TimeSformer"])
def test_timesformer_takes_clip_like_jax(tmp_path, arch):
    """The tensors copied from CLIP equal JAX's; the surgery's new
    time/temporal tensors come from each package's own generator, so only
    their zero and identity parts are compared."""
    sd = _seeded_openai_sd(seed=3, arch=arch)
    torch.save(sd, tmp_path / "clip.pt")
    kw = dict(model_type=TINY, seed=0, nframes=4, clip_weights=str(tmp_path / "clip.pt"))
    _, variables = jax_create_model(arch, **kw)
    params = _np_tree(variables["params"])
    if "cam" not in params:
        params["cam"] = _np_tree(jax_create_model(
            "PretrainedCLIP_finaltf", model_type=TINY, seed=0)[1]["params"]["cam"])
    ref = state_dict_from_jax(params)
    ours = _clip_state(create_model(arch, device="cpu", **kw))
    assert sorted(ours) == sorted(k for k in ref if k.startswith("model."))
    n_copied = 0
    for k, v in ours.items():
        if ".timeattn." in k:
            assert ("bias" in k) == (not v.any()), k
        elif ".temporal" in k or ".ln_time." in k:
            assert torch.equal(v, ref[k]), k
        else:
            assert torch.equal(v, ref[k]) and torch.equal(v, sd[k[len("model."):]]), k
            n_copied += 1
    assert n_copied == len(sd) - 3


# ---- the train.py twin -------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_cli.py's corpus: image + title + comments, base-36 ids."""
    tmp_path = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    root = tmp_path / "media"
    (root / "vids").mkdir(parents=True)
    rows = []
    for i in range(72):
        rid_str = "ab" + BASE36[(i * 7) % 36] + BASE36[i % 36]
        rid = int(rid_str, 36)
        if any(r["reddit_id"] == rid for r in rows):
            continue
        rows.append({"reddit_id": rid, "video_path": f"results/vids/{rid_str}.mp4",
                     "title": f"a video about topic {i}", "video_length": 10.0,
                     "comments": str([f"this is about topic {i}", f"great {i}"])})
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            root / "vids" / f"{rid_str}.jpg")
    csv = tmp_path / "posts.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    return tmp_path, csv, root


def _config(save_dir, csv, root, **extra):
    """tests/test_cli.py's ``_config`` at 2 epochs, without the adapter's
    random skip."""
    cfg = {
        "name": "cli_twin", "n_gpu": 1, "batch_size": 4, "num_workers": 0,
        "arch": {"type": "PretrainedCLIP_finaltf",
                 "args": {"model_type": TINY, "freeze": "all", "branch_to_adapt": "text",
                          "branch_to_adapt_val": "text", "random_skip_adapter": False}},
        "dataset": {"type": "ImTextDataset",
                    "args": {"root": str(root), "csv_file": str(csv),
                             "add_comments": "always", "comment_sampling": "random",
                             "num_comms": 2, "image_size": 32}},
        "optimizer": {"type": "Adam",
                      "args": {"lr": 0.001, "weight_decay": 0, "amsgrad": True}},
        "loss": "clip_loss", "loss_args": {},
        "metrics": [{"type": "RecallAtK", "args": {"name_a": "visual", "name_b": "titles",
                                                   "k_vals": [1, 10]}}],
        "lr_scheduler": {"type": "StepLR", "args": {"step_size": 10, "gamma": 0.1}},
        "trainer": {"epochs": 2, "save_dir": str(save_dir), "save_period": 1,
                    "verbosity": 2, "monitor": "max val_titles_from_visual-recall_at_10",
                    "early_stop": 10, "tensorboard": False},
    }
    cfg.update(extra)
    return cfg


def _record(monkeypatch, trainer_cls) -> list:
    logs = []
    run_epoch = trainer_cls._train_epoch

    def record(self, epoch):
        logs.append(run_epoch(self, epoch))
        return logs[-1]

    monkeypatch.setattr(trainer_cls, "_train_epoch", record)
    return logs


@pytest.fixture(scope="module")
def jax_run(corpus, tmp_path_factory):
    """``train.main`` (the JAX package's CLI) over 2 epochs: each epoch's
    log and the run directory."""
    sys.path.insert(0, str(REPO))
    import train as jax_train
    from vtc_tpu.config import ConfigParser as JaxConfigParser
    from vtc_tpu.training.trainer import Trainer as JaxTrainer

    _, csv, root = corpus
    mp = pytest.MonkeyPatch()
    try:
        logs = _record(mp, JaxTrainer)
        config = JaxConfigParser(_config(tmp_path_factory.mktemp("jax"), csv, root))
        jax_train.main(config)
    finally:
        mp.undo()
    return logs, config.save_dir


def test_twin_tracks_jax_train_main(corpus, jax_run, tmp_path, monkeypatch):
    from vtc_tpu_torch.training import Trainer

    logs_j, run_dir_j = jax_run
    _, csv, root = corpus

    def from_jax_weights(arch, seed, device, **args):
        """The port's model with the JAX factory's weights of ``seed``."""
        _, variables = jax_create_model(arch, seed=seed, **args)
        model = create_model(arch, seed=seed, device=device, **args)
        model.load_state_dict(state_dict_from_jax(_np_tree(variables["params"]),
                                                  variables.get("batch_stats")))
        return model

    monkeypatch.setattr(twin, "create_model", from_jax_weights)
    logs = _record(monkeypatch, Trainer)
    cfg_path = tmp_path / "cfg.jsonc"
    cfg_path.write_text(json.dumps(_config(tmp_path / "saved", csv, root)))
    trainer = twin.cli(["-c", str(cfg_path)], device="cpu")

    assert len(logs) == len(logs_j) == 2
    for ours, ref in zip(logs, logs_j):
        assert sorted(ours) == sorted(ref)
        np.testing.assert_allclose(ours["loss"], ref["loss"], atol=LOSS_ATOL)
        np.testing.assert_allclose(ours["val_loss"], ref["val_loss"], atol=LOSS_ATOL)
        recall = {k: v for k, v in ref.items() if "recall" in k}
        assert len(recall) == 4 and {k: ours[k] for k in recall} == recall
    for epoch in (1, 2):
        assert (trainer.checkpoint_dir / f"checkpoint-epoch{epoch}.pth").exists()
        assert (run_dir_j / f"checkpoint-epoch{epoch}").exists()


def _moe_config(save_dir, csv, root):
    """The test config with configs/pretrained_clip_comments_attn_moe.jsonc's
    adapter: 4 experts, top 2, the aux loss at 0.01. Adam at lr 1e-6 (the
    audio config's): Adam moves a parameter whose gradient sits at rounding
    level by ``lr`` either way, and at lr 1e-3 that moved a router's near-tie
    across within 14 steps, a different expert for one token in one package
    (a loss jump of 1.2e-5 at step 5, from 6e-7 before it)."""
    cfg = _config(save_dir, csv, root, moe_aux_loss_weight=0.01)
    cfg["arch"]["args"].update(moe_experts=4, moe_top_k=2)
    cfg["optimizer"]["args"]["lr"] = 1e-6
    return cfg


def test_twin_tracks_jax_train_main_on_the_moe_config(corpus, tmp_path, monkeypatch):
    """The MoE adapter through both CLIs over 2 epochs: each epoch's loss
    (the load-balance losses in it) within 1e-5 and the recalls equal."""
    sys.path.insert(0, str(REPO))
    import train as jax_train
    from vtc_tpu.config import ConfigParser as JaxConfigParser
    from vtc_tpu.training.trainer import Trainer as JaxTrainer
    from vtc_tpu_torch.training import Trainer

    _, csv, root = corpus
    logs_j = _record(monkeypatch, JaxTrainer)
    jax_train.main(JaxConfigParser(_moe_config(tmp_path / "jax", csv, root)))

    def from_jax_weights(arch, seed, device, **args):
        _, variables = jax_create_model(arch, seed=seed, **args)
        model = create_model(arch, seed=seed, device=device, **args)
        model.load_state_dict(state_dict_from_jax(_np_tree(variables["params"])))
        return model

    monkeypatch.setattr(twin, "create_model", from_jax_weights)
    logs = _record(monkeypatch, Trainer)
    cfg_path = tmp_path / "cfg.jsonc"
    cfg_path.write_text(json.dumps(_moe_config(tmp_path / "saved", csv, root)))
    trainer = twin.cli(["-c", str(cfg_path)], device="cpu")
    assert trainer.moe_aux_loss_weight == 0.01
    assert len(logs) == len(logs_j) == 2
    for ours, ref in zip(logs, logs_j):
        np.testing.assert_allclose(ours["loss"], ref["loss"], atol=LOSS_ATOL)
        np.testing.assert_allclose(ours["val_loss"], ref["val_loss"], atol=LOSS_ATOL)
        recall = {k: v for k, v in ref.items() if "recall" in k}
        assert len(recall) == 4 and {k: ours[k] for k in recall} == recall


def test_twin_and_eval_twin_run_the_audio_config(corpus, tmp_path):
    """The audio config's model and dataset (cached GDT clip features joined
    to the comments, ``audio_with_comms``) through the train twin for an
    epoch: the audio MLP's BatchNorm moves once per clip per step; then the
    eval twin on its checkpoint gives the trainer's model's features."""
    from vtc_tpu_torch.data.table import read_csv
    from vtc_tpu_torch.evaluation import eval as eval_twin

    _, csv, root = corpus
    ids = np.asarray(read_csv(csv).reddit_id, np.int64)
    audio = tmp_path / "audio.npz"
    np.savez(audio, reddit_ids=ids, embeddings=np.random.default_rng(1).normal(
        size=(len(ids), 5, 512)).astype(np.float32))
    cfg = _config(tmp_path / "saved", csv, root)
    cfg["trainer"]["epochs"] = 1
    cfg["arch"]["args"].update(init_audio_model=True, freeze=False)
    cfg["dataset"]["args"].update(cached_audio_features=str(audio), audio_with_comms=True)
    cfg_path = tmp_path / "cfg.jsonc"
    cfg_path.write_text(json.dumps(cfg))
    trainer = twin.cli(["-c", str(cfg_path)], device="cpu")
    bn = trainer.model.audio_model.mlp.layers[2]
    steps = trainer.len_epoch
    assert int(bn.num_batches_tracked) == 5 * steps > 0
    assert bn.running_mean.abs().max() > 0
    ckpt = trainer.checkpoint_dir / "checkpoint-epoch1.pth"
    res = eval_twin.cli(["-c", str(cfg_path), "-r", str(ckpt), "-d", "cpu"])
    assert all(0 <= v <= 100 for k, v in res.items() if k.startswith("R"))


def test_twin_cli_overrides(corpus, tmp_path, monkeypatch):
    """``--csv_file``/``--root``/``--epochs``/``--save_dir``/``-d`` reach the
    config as ``;``-paths, and ``main`` builds the datasets from them."""
    _, csv, root = corpus
    cfg = _config("unused", "unused.csv", "unused")
    cfg_path = tmp_path / "cfg.jsonc"
    cfg_path.write_text(json.dumps(cfg))
    seen = {}
    monkeypatch.setattr(twin, "main", lambda config, device=None: seen.update(
        config=config, device=device))
    twin.cli(["-c", str(cfg_path), "--csv_file", str(csv), "--root", str(root),
              "--epochs", "3", "--save_dir", str(tmp_path / "s"), "-d", "2"], device="cpu")
    config = seen["config"]
    assert config["dataset"]["args"]["csv_file"] == str(csv)
    assert config["dataset"]["args"]["root"] == str(root)
    assert config["trainer"]["epochs"] == 3 and config["n_devices"] == 2
    assert str(config.save_dir).startswith(str(tmp_path / "s"))


@pytest.mark.parametrize("extra, match", [
    ({"loader": "grain"}, "grain"),
    ({"sp": 2}, "distribution"),
    ({"slices": 2}, "distribution"),
    ({"fsdp": 1, "pp": 2}, "Queue 1 item 9"),
    ({"slices": 2, "n_model": 2}, "Queue 1 item 9"),
])
def test_twin_refusals(tmp_path, extra, match):
    """What the port does not shard raises by name: the sequence and
    multi-slice axes (also beside the model axis) and ZeRO-3 beside the
    pipe axis (``--pp`` and ``--ep`` train: tests/test_torch_pipeline.py,
    tests/test_torch_ep.py)."""
    config = ConfigParser(_config(tmp_path, "x.csv", "x", **extra))
    with pytest.raises(NotImplementedError, match=match):
        twin.main(config, device="cpu")


@pytest.mark.parametrize("extra", [{"fsdp": 1}, {"n_model": 2, "fsdp": 1}])
def test_twin_fsdp_gets_past_the_mesh_check(tmp_path, extra):
    """``--fsdp 1``, alone and with the model axis, is no refusal: one
    process without a group passes ``_check_mesh`` (ZeRO-3 runs under a
    group: tests/test_torch_fsdp.py) and ``main`` goes on to read its data,
    here a CSV that is not there."""
    config = ConfigParser(_config(tmp_path, tmp_path / "x.csv", tmp_path, **extra))
    twin._check_mesh(config, torch.device("cpu"), logging.getLogger("test"))
    with pytest.raises(FileNotFoundError):
        twin.main(config, device="cpu")


def test_twin_refuses_multihost(tmp_path, monkeypatch):
    """``--multihost`` joins the group that torchrun describes: without its
    variables it raises by name, before any run dir exists."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    cfg_path = tmp_path / "cfg.jsonc"
    cfg_path.write_text(json.dumps(_config(tmp_path, "x.csv", "x")))
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node N"):
        twin.cli(["-c", str(cfg_path), "--multihost", "1"], device="cpu")
    assert not (tmp_path / "models").exists()
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="missing: \\['WORLD_SIZE'"):
        twin.cli(["-c", str(cfg_path), "--multihost", "1"], device="cpu")


def test_msrvtt_probe_off_without_root_refused_with_it(tmp_path):
    """Without the MSRVTT root no probe; with it the probe, a callable of the
    trainer and the CAM branch (run against train.main in
    tests/test_torch_video.py)."""
    assert twin._make_probe({"msrvtt_root": str(tmp_path / "absent")}) is None
    (tmp_path / "train_val_videodatainfo.json").write_text("{}")
    probe = twin._make_probe({"msrvtt_root": str(tmp_path)})
    assert callable(probe)
    assert list(inspect.signature(probe).parameters) == ["trainer", "branch_override"]


def test_mesh_warns_without_the_devices_and_refuses_with_them(tmp_path, monkeypatch):
    config = ConfigParser(_config(tmp_path, "x.csv", "x", n_devices=2))
    logger = logging.getLogger("twin-test")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    try:
        twin._check_mesh(config, torch.device("cpu"), logger)
    finally:
        logger.removeHandler(handler)
    assert any("training UNSHARDED" in r.getMessage() for r in records)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2 -m vtc_tpu_torch.train"):
        twin._check_mesh(config, torch.device("cuda"), logger)
