"""The port's evaluation (``vtc_tpu_torch.evaluation``, ``ops.retrieval.
recall_at_k_chunked``) against the JAX package's, on the CPU, at test-tiny
with the JAX weights carried across by ``state_dict_from_jax``.

* ``recall_at_k_chunked`` against JAX's: ties across tiles, a gallery that
  is not a multiple of ``chunk``, targets, non-finite rows, a gallery
  smaller than k;
* ``chunk_frames``, ``compute_recall`` (columns, index, values and the CSV
  bytes of ``DataFrame.to_csv``) and ``retrieval_evaluation`` against
  ``vtc_tpu.evaluation.retrieval_eval`` on the injected datasets of
  ``tests/test_retrieval_evaluation.py``: the CAM model, the skip probe
  equal to the plain model, ragged captions, first-frame and first-chunk
  modes, the image branch, uint8 frames, and every decode failing; the
  encoded features within 2e-5 and the recall tables equal;
* ``add_irrelevant_comms`` equal to ``evaluation/eval.py``'s; the
  ``eval.py`` twin's JSON and file name equal to ``evaluation/eval.py``'s
  on ``tests/test_cli.py``'s corpus from one ``.pth``, with the probe on
  and off; the twin of ``evaluation/retrieval_evaluation.py``'s ``main``
  against the JAX one;
* the refusals: a mesh, a process count without its process group, a
  tensor-parallel axis, ``--n_devices`` on a machine with the cards but no
  group (the ``torchrun`` line), Orbax directories, a 1-element tail; a
  named video dataset whose root is absent raises what the JAX package
  raises. The evaluations on a group's processes are in
  ``tests/test_torch_dist.py``.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from vtc_tpu.data import tokenizer as jax_tk
from vtc_tpu.evaluation import retrieval_eval as jax_re
from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.ops.retrieval import recall_at_k_chunked as jax_recall_chunked
from vtc_tpu_torch.config import ConfigParser
from vtc_tpu_torch.evaluation import eval as port_eval
from vtc_tpu_torch.evaluation import retrieval_eval as port_re
from vtc_tpu_torch.evaluation import retrieval_evaluation as port_cli
from vtc_tpu_torch.models import create_model, state_dict_from_jax
from vtc_tpu_torch.models.retrieval import PretrainedCLIP, PretrainedCLIP_finaltf
from vtc_tpu_torch.ops.retrieval import recall_at_k, recall_at_k_chunked

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "evaluation"))
import eval as jax_eval  # noqa: E402  (evaluation/eval.py)
import retrieval_evaluation as jax_cli  # noqa: E402

TINY = "test-tiny"
RES = 32
FEAT_ATOL = 2e-5  # the repo's fp32 kernel tolerance
BASE36 = "0123456789abcdefghijklmnopqrstuvwxyz"


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


# ---- recall_at_k_chunked ------------------------------------------------------------

def _ties_case(ng, nq, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(ng, 8)).astype(np.float32)
    q = (g[:nq] + 0.7 * rng.normal(size=(nq, 8))).astype(np.float32)
    # rows 3, 11 and the last repeat row 2: equal scores in three tiles
    dup = [i for i in (3, 11, ng - 1) if i < ng and i != 2]
    g[dup] = g[2]
    q[[i for i in (2, 3, 11) if i < nq]] = g[2]
    return g, q


@pytest.mark.parametrize("ng,chunk", [(37, 8), (37, 37), (37, 64), (64, 16), (5, 2)])
def test_recall_at_k_chunked_matches_jax(ng, chunk):
    g, q = _ties_case(ng, min(ng, 20), ng + chunk)
    for targets in (None, np.random.default_rng(1).integers(0, ng, q.shape[0])):
        ref = jax_recall_chunked(g, q, (1, 5, 10), targets=targets, chunk=chunk)
        ours = recall_at_k_chunked(g, q, (1, 5, 10), targets=targets, chunk=chunk,
                                   device="cpu")
        assert ours == ref
        assert ours == recall_at_k(g, q, (1, 5, 10), targets=targets, device="cpu")


def test_recall_at_k_chunked_ranks_non_finite_rows_last():
    g, q = _ties_case(40, 12, 3)
    g[[0, 17]] = -np.inf
    ref = jax_recall_chunked(g, q, (1, 5, 10), chunk=16)
    assert recall_at_k_chunked(g, q, (1, 5, 10), chunk=16, device="cpu") == ref
    with pytest.raises(ValueError, match="chunk"):
        recall_at_k_chunked(g, q, chunk=0, device="cpu")


# ---- chunking and the recall table --------------------------------------------------

@pytest.mark.parametrize("t,stride", [(70, 4), (24, 4), (8, 1), (3, 16), (64, 16)])
def test_chunk_frames_matches_jax(t, stride):
    frames = np.random.default_rng(t).integers(0, 256, (t, 5, 6, 3), dtype=np.uint8)
    np.testing.assert_array_equal(port_re.chunk_frames(frames, stride),
                                  jax_re.chunk_frames(frames, stride))


def test_compute_recall_table_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(13, 8)).astype(np.float32)
    t = (v + 0.8 * rng.normal(size=v.shape)).astype(np.float32)
    ours = port_re.compute_recall(v, t, split="test", dataset_name="Toy", device="cpu")
    ref = jax_re.compute_recall(v, t, split="test", dataset_name="Toy")
    assert ours.columns == list(ref.columns) and ours.index == list(ref.index)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours.to_numpy(), ref.to_numpy())
    assert ours.to_numpy()[0].tolist() == ref.loc["R@1"].tolist()
    ours.to_csv(tmp_path / "ours.csv")
    ref.to_csv(tmp_path / "ref.csv")
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    assert "R@10" in repr(ours)


# ---- retrieval_evaluation against vtc_tpu ------------------------------------------

class _SyntheticVideoDataset:
    """``tests/test_retrieval_evaluation.py``'s items: float frames
    ``[24, 3, 32, 32]``, one or more captions, comments or none."""

    def __init__(self, n=6, ncap=1, with_comments=True, seed=0, uint8=False):
        self.n, self.ncap, self.with_comments = n, ncap, with_comments
        rng = np.random.default_rng(seed)
        if uint8:  # decoded frames, preprocessed by the evaluation
            self.frames = [rng.integers(0, 256, (20, 40, 48, 3), dtype=np.uint8)
                           for _ in range(n)]
        else:
            self.frames = [rng.normal(size=(24, 3, RES, RES)).astype(np.float32)
                           for _ in range(n)]
        self.texts = [[f"unique video number {i} topic {i}"] * ncap for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        caps = jax_tk.tokenize(self.texts[i])
        if self.with_comments:
            return self.frames[i], caps, jax_tk.tokenize([f"comment about {i}", "more text"]), {}
        return self.frames[i], caps, str(i)


class _RaggedDataset(_SyntheticVideoDataset):
    def __getitem__(self, i):
        caps = jax_tk.tokenize([f"unique video number {i} caption {j}"
                                for j in range(1 + i % 3)])
        return self.frames[i], caps, jax_tk.tokenize(["a comment"]), {}


class _AllFailDataset:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        return None, jax_tk.tokenize(["caption"]), jax_tk.tokenize(["c", "d"]), {}


@pytest.fixture(scope="module")
def cam_pair():
    """The JAX CAM model at test-tiny, its CAM moved off the zero-init, and
    the port's on the same weights."""
    module, variables = jax_create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=0)
    params = _np_tree(variables["params"])
    rng = np.random.default_rng(0)
    params["cam"] = jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), params["cam"])
    model = PretrainedCLIP_finaltf(model_type=TINY)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return module, {"params": params}, model.eval()


def _same_encodings(jax_model, port_model, ds, **kw):
    """The per-video features of both packages' ``_encode_local``."""
    module, variables = jax_model
    defaults = dict(frame_stride=4, first_frame_only=False, first_chunk_only=False,
                    branch_override=None, needs_comments=True, image_size=RES,
                    nframes=8)
    defaults.update(kw)
    ref = jax_re._encode_local(module, variables, ds, range(len(ds)), **defaults)
    ours = port_re._encode_local(port_model, ds, range(len(ds)), device=torch.device("cpu"),
                                 **defaults)
    assert ours[0] == ref[0]
    for a, b in zip(ours[1] + ours[2], ref[1] + ref[2]):
        np.testing.assert_allclose(a, np.asarray(b), atol=FEAT_ATOL, rtol=0)


def _same_tables(ours, ref):
    assert ours.columns == list(ref.columns) and ours.index == list(ref.index)
    np.testing.assert_array_equal(ours.to_numpy(), ref.to_numpy())


@pytest.mark.parametrize("case", ["cam", "ragged", "first_frame", "first_chunk", "image",
                                  "skip", "uint8", "no_comments"])
def test_retrieval_evaluation_matches_jax(cam_pair, case, tmp_path):
    module, variables, model = cam_pair
    ds = {"ragged": _RaggedDataset(n=6), "uint8": _SyntheticVideoDataset(n=5, uint8=True),
          "image": _SyntheticVideoDataset(n=8, seed=3),
          "no_comments": _SyntheticVideoDataset(n=5, with_comments=False, seed=2),
          }.get(case, _SyntheticVideoDataset(n=6, seed=1))
    kw = {"first_frame": dict(first_frame_only=True),
          "first_chunk": dict(first_chunk_only=True, frame_stride=4),
          "image": dict(branch_override="image", frame_stride=4),
          "skip": dict(branch_override="skip", frame_stride=4),
          }.get(case, dict(frame_stride=4))
    enc_kw = dict(kw)
    if case == "uint8":
        kw["image_size"] = enc_kw["image_size"] = RES
    _same_encodings((module, variables), model, ds, **enc_kw)
    ref = jax_re.retrieval_evaluation(module, variables, "synthetic", "test", dataset=ds,
                                      out_csv=str(tmp_path / "ref.csv"), **kw)
    ours = port_re.retrieval_evaluation(model, "synthetic", "test", dataset=ds, device="cpu",
                                        out_csv=str(tmp_path / "ours.csv"), **kw)
    _same_tables(ours, ref)
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()


def test_skip_probe_equals_the_plain_model(cam_pair):
    """``branch_override='skip'`` matches the plain CLIP model on the same
    towers (the trainer's skip-probe invariant), in the port as in JAX."""
    module, variables, model = cam_pair
    ds = _SyntheticVideoDataset(n=5, seed=1)
    skip = port_re.retrieval_evaluation(model, "synthetic", "test", dataset=ds,
                                        frame_stride=4, branch_override="skip", device="cpu")
    plain = PretrainedCLIP(model_type=TINY)
    plain.load_state_dict({k: v for k, v in model.state_dict().items()
                           if k.startswith("model.")}, strict=True)
    ds2 = _SyntheticVideoDataset(n=5, with_comments=False, seed=1)
    plain_table = port_re.retrieval_evaluation(plain.eval(), "synthetic", "test", dataset=ds2,
                                               frame_stride=4, needs_comments=False,
                                               device="cpu")
    np.testing.assert_allclose(skip.to_numpy(), plain_table.to_numpy(), atol=1e-4)


def test_vt_recall_counts_ties_as_jax():
    """Video -> text with equal caption scores: the place of the video's
    first own caption, lower index first, as ``lax.top_k``."""
    rng = np.random.default_rng(5)
    videos = rng.normal(size=(6, 8)).astype(np.float32)
    caps = np.concatenate([videos, videos[[0, 0, 2, 5]]]).astype(np.float32)
    owner = np.array([0, 1, 2, 3, 4, 5, 1, 3, 0, 2])  # owners of the duplicates differ
    caps[9] = -np.inf
    ref = jax_re._vt_recall(videos, caps, owner, (1, 5, 10))
    np.testing.assert_array_equal(port_re._vt_recall(videos, caps, owner, (1, 5, 10), "cpu"),
                                  ref)


def test_all_decodes_failing_raises_clearly(cam_pair):
    _, _, model = cam_pair
    with pytest.raises(RuntimeError, match="no embeddings"):
        port_re.retrieval_evaluation(model, "synthetic", "test", dataset=_AllFailDataset(),
                                     device="cpu")


def test_retrieval_evaluation_refusals(cam_pair):
    _, _, model = cam_pair
    ds = _SyntheticVideoDataset(n=2)
    # a mesh is the process group's (create_mesh); the model axis runs in
    # tests/test_torch_tp.py
    with pytest.raises(ValueError, match="create_mesh"):
        port_re.retrieval_evaluation(model, "synthetic", "test", dataset=ds, mesh=object(),
                                     device="cpu")
    with pytest.raises(RuntimeError, match="runs under torchrun"):
        port_re.retrieval_evaluation(model, "synthetic", "test", dataset=ds, process_count=2,
                                     device="cpu")
    with pytest.raises(ValueError, match="create_mesh"):
        port_re.compute_recall(np.ones((2, 4)), np.ones((2, 4)), mesh=object(), device="cpu")
    # a named dataset whose root is absent raises what vtc_tpu raises
    module, variables, _ = cam_pair
    roots = {"MSRVTT": {"root": "/absent/MSRVTT"}, "K700": {"kinetics_csv": "/absent.csv"}}
    for name in port_re.DATASETS:
        split = "full-test" if name == "MSRVTT_videos" else "test"
        with pytest.raises(Exception) as ref:
            jax_re.retrieval_evaluation(module, variables, name, split, data_roots=roots)
        with pytest.raises(type(ref.value)):
            port_re.retrieval_evaluation(model, name, split, device="cpu", data_roots=roots)
        assert type(ref.value) in (FileNotFoundError, TypeError), (name, ref.value)
    with pytest.raises(ValueError, match="Unknown dataset"):
        port_re.retrieval_evaluation(model, "nope", "test", device="cpu")
    with pytest.raises(ValueError, match="the model is on cpu"):
        port_re.retrieval_evaluation(model, "synthetic", "test", dataset=ds,
                                     device="meta")


# ---- the retrieval_evaluation CLI ---------------------------------------------------

@pytest.fixture(scope="module")
def tiny_ckpt(cam_pair, tmp_path_factory):
    """One ``.pth`` of the CAM pair's weights, written by the JAX package."""
    from vtc_tpu.models.torch_export import save_torch_checkpoint

    _, variables, _ = cam_pair
    path = tmp_path_factory.mktemp("ckpt") / "model_best.pth"
    save_torch_checkpoint(path, variables["params"], arch="PretrainedCLIP_finaltf", epoch=1,
                          config={"arch": {"type": "PretrainedCLIP_finaltf",
                                           "args": {"init_from_avg": True}}})
    return path


def test_retrieval_evaluation_main_matches_jax(tiny_ckpt, monkeypatch, tmp_path):
    """Both ``main``s on one ``.pth`` at test-tiny (each package's
    ``create_model`` given the tiny type), an injected dataset, the CSV."""
    def tiny(create):
        return lambda arch, **kw: create(arch, **dict(kw, model_type=TINY))

    monkeypatch.setattr(jax_cli, "create_model", tiny(jax_create_model))
    monkeypatch.setattr(port_cli, "create_model", tiny(create_model))
    ds = _RaggedDataset(n=6)
    argv = ["-r", str(tiny_ckpt), "-m", "pretrained_clip_finaltf", "--frame_stride", "4"]
    ref = jax_cli.main(argv + ["--out_csv", str(tmp_path / "ref.csv")], dataset=ds)
    ours = port_cli.main(argv + ["--out_csv", str(tmp_path / "ours.csv"), "-d", "cpu"],
                         dataset=ds)
    _same_tables(ours, ref)
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    model = port_cli.load_model(tiny_ckpt, "pretrained_clip_finaltf", device="cpu")
    assert model.init_from_avg is True  # from the checkpoint's config


def test_retrieval_evaluation_cli_refusals(tmp_path, monkeypatch):
    """A strict graft, Orbax, no card; ``--n_devices 2`` on a machine with
    the cards but without a process group names the ``torchrun`` line."""
    from vtc_tpu_torch.training.checkpoints import save_checkpoint

    monkeypatch.setattr(port_cli, "create_model",
                        lambda arch, **kw: create_model(arch, **dict(kw, model_type=TINY)))
    plain = create_model("PretrainedCLIP", model_type=TINY, device="cpu")
    ckpt = save_checkpoint(tmp_path, "plain", arch="PretrainedCLIP", epoch=1,
                           state_dict=plain.state_dict())
    with pytest.raises(ValueError, match="missing"):  # grafted strictly
        port_cli.load_model(ckpt, "pretrained_clip_finaltf", device="cpu")
    port_cli.load_model(ckpt, "pretrained_clip", device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        port_cli.main(["-m", "pretrained_clip", "--n_devices", "2", "-d", "cuda"])
    with pytest.raises(NotImplementedError, match="Orbax"):
        port_cli.load_model(tmp_path, "pretrained_clip", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.load_model(None, "pretrained_clip")


def test_retrieval_evaluation_cli_device_flag(monkeypatch):
    """``-d`` names the torch device, as the ``eval.py`` twin's does: model
    and evaluation both get it; a name that is no device raises."""
    seen = []
    monkeypatch.setattr(port_cli, "load_model",
                        lambda *a, device=None, **kw: seen.append(device))
    monkeypatch.setattr(port_cli, "retrieval_evaluation",
                        lambda *a, device=None, **kw: seen.append(device))
    for name in ("cpu", "cuda:1"):
        port_cli.main(["-m", "pretrained_clip", "-d", name])
        assert seen[-2:] == [torch.device(name)] * 2
    with pytest.raises(RuntimeError, match="device"):
        port_cli.main(["-m", "pretrained_clip", "-d", "tpu"])


# ---- the eval.py twin ---------------------------------------------------------------

def test_add_irrelevant_comms_matches_jax():
    comments = np.random.default_rng(0).integers(0, 1000, (6, 3, 9), dtype=np.int32)
    for n, seed in ((1, 0), (4, 3), (7, 11)):
        np.testing.assert_array_equal(port_eval.add_irrelevant_comms(comments, n, seed),
                                      jax_eval.add_irrelevant_comms(comments, n, seed))
    with pytest.raises(ValueError, match=">= 2 items"):
        port_eval.add_irrelevant_comms(comments[:1], 2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``tests/test_cli.py``'s corpus: 72 rows over every split, 48x64
    thumbnails."""
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


def _eval_config(tmp_path, csv, root, **over):
    cfg = {
        "name": "eval_twin", "n_gpu": 1, "batch_size": 4, "num_workers": 0,
        "arch": {"type": "PretrainedCLIP_finaltf",
                 "args": {"model_type": TINY, "freeze": "all", "branch_to_adapt": "text",
                          "branch_to_adapt_val": "text"}},
        "dataset": {"type": "ImTextDataset",
                    "args": {"root": str(root), "csv_file": str(csv), "add_comments": "always",
                             "comment_sampling": "random", "num_comms": 2, "image_size": 32}},
        "trainer": {"save_dir": str(tmp_path / "saved")},
    }
    cfg.update(over)
    return cfg


class _Args:
    def __init__(self, num_irrelevant_comments=0):
        self.num_irrelevant_comments = num_irrelevant_comments


@pytest.mark.parametrize("irrelevant", [0, 2])
def test_eval_twin_matches_eval_py(corpus, tiny_ckpt, tmp_path, irrelevant):
    """Both ``main``s from one ``.pth``: the same six recalls and the same
    JSON file beside the checkpoint."""
    from vtc_tpu.config import ConfigParser as JaxConfigParser

    tmp, csv, root = corpus
    ckpt = tmp_path / "model_best.pth"
    ckpt.write_bytes(Path(tiny_ckpt).read_bytes())
    ref = jax_eval.main(JaxConfigParser(_eval_config(tmp, csv, root)), _Args(irrelevant),
                        str(ckpt))
    written = sorted(tmp_path.glob("*.json"))
    assert [p.name for p in written] == ["model_best.pth_res_adapted_text_2_comms.json"]
    ref_file = json.loads(written[0].read_text())
    written[0].unlink()
    ours = port_eval.main(ConfigParser(_eval_config(tmp, csv, root)), _Args(irrelevant),
                          str(ckpt), device="cpu")
    assert [p.name for p in sorted(tmp_path.glob("*.json"))] == [written[0].name]
    assert ours == ref and json.loads(written[0].read_text()) == ref_file


def test_eval_twin_cli_zero_shot_name(corpus, monkeypatch, tmp_path):
    """``cli`` with ``-c`` and ``-d cpu``: a run without a checkpoint
    writes ``zero_shot_res_<fusion>.json`` in the working directory."""
    tmp, csv, root = corpus
    monkeypatch.chdir(tmp_path)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_eval_config(tmp_path, csv, root)))
    out = port_eval.cli(["-c", str(cfg_path), "-d", "cpu"])
    assert set(out) == {"R1_title_from_im", "R5_title_from_im", "R10_title_from_im",
                        "R1_im_from_title", "R5_im_from_title", "R10_im_from_title"}
    assert json.loads((tmp_path / "zero_shot_res_None.json").read_text()) == out


def test_eval_twin_refusals(corpus, tmp_path, monkeypatch):
    tmp, csv, root = corpus
    # --n_model without a process group: on a machine with the cards, the
    # torchrun line that runs them (the mesh runs in tests/test_torch_tp.py)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2 .*--n_model 2"):
        port_eval.main(ConfigParser(_eval_config(tmp_path, csv, root, n_model=2)), _Args(),
                       None, device="cuda")
    # a multihost config waits for its process group to pick the run dir
    with pytest.raises(RuntimeError, match="finalize_run_dir"):
        ConfigParser(_eval_config(tmp_path, csv, root, multihost=1)).save_dir
    with pytest.raises(RuntimeError, match="runs under torchrun"):
        port_eval.main(ConfigParser(_eval_config(tmp_path, csv, root)), _Args(), None,
                       device="cpu", process_index=0, process_count=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        port_eval.main(ConfigParser(_eval_config(tmp_path, csv, root, n_devices=2)), _Args(),
                       None, device="cuda")
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="Orbax"):
        port_eval.main(ConfigParser(_eval_config(tmp_path, csv, root)), _Args(),
                       str(tmp_path), device="cpu")
    # 4 test items at batch 3 leave a 1-element tail: refused before encoding
    with pytest.raises(ValueError, match="1-element batch"):
        port_eval.main(ConfigParser(_eval_config(tmp_path, csv, root, batch_size=3)),
                       _Args(2), None, device="cpu")
