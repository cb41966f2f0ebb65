"""The port's video data path (``vtc_tpu_torch.data.video``,
``video_retrieval``, the video datasets, ``clip_preprocess_batch``) against
the JAX package's OpenCV route (``VTC_DECODE=cv2``), on the CPU, on videos
written with ``cv2.VideoWriter``: both packages call the same OpenCV, so
frames, preprocessed frames and tokens are equal (atol 0), and the random
draws too, from the same seeds.

* ``read_video_segment`` (whole, a segment, ``max_frames``, ``subsample_to``,
  resizes), ``video_duration_sec``, ``read_segment_with_fallbacks`` in
  training and evaluation with its two fallbacks (a zero-length segment
  retried on [0, 5] s, then black frames, each logged);
  ``VTC_DECODE=native`` and a missing ``cv2`` raise;
* ``clip_preprocess_batch`` against the JAX package's PIL route
  (``clip_preprocess_frames``) exactly; its native stage, which folds the
  normalization into one multiply and subtract, within 4.8e-7;
* ``VideoDatasetSegments`` (train, val, test, ``first_frame_only``, the
  kinetics and howto100m mixes), ``VideoDatasetReddit`` (its 8 frames decoded
  alone equal a full decode's first 8), ``VideoDatasetLivebot``, MSR-VTT on
  its four splits (and augment mode), MSVD, ActivityNet, K700 comments, and
  loader batches;
* ``retrieval_evaluation(model, "MSRVTT_videos", "full-val")`` against the
  JAX package's, recall tables equal; the ``train.py`` twin on both video
  configs against ``train.main`` over 2 epochs at test-tiny with the MSRVTT
  probe on: losses within 1e-5, recalls and probe results equal.

The JAX package's ``clip_preprocess_batch`` takes its native stage where its
library builds, else ``clip_preprocess_frames``, which resizes to 224
whatever ``size`` asks; the item tests pin it to the PIL transform at the
size asked (``jax_pil_batch``), the reference's arithmetic, which the port
follows. Torch runs on one thread.
"""

import copy
import functools
import json
import logging
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import pandas as pd  # noqa: E402

import vtc_tpu.data.datasets as jax_datasets  # noqa: E402
from vtc_tpu.data import native as jax_native  # noqa: E402
from vtc_tpu.data import preprocess as jax_pre  # noqa: E402
from vtc_tpu.data import video as jax_video  # noqa: E402
from vtc_tpu.data import video_retrieval as jax_vr  # noqa: E402
from vtc_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from vtc_tpu.evaluation import retrieval_eval as jax_re  # noqa: E402
from vtc_tpu.models import create_model as jax_create_model  # noqa: E402
from vtc_tpu_torch import train as twin  # noqa: E402
from vtc_tpu_torch.config import ConfigParser  # noqa: E402
from vtc_tpu_torch.data import DataLoader, datasets, preprocess, video  # noqa: E402
from vtc_tpu_torch.data import video_retrieval as vr  # noqa: E402
from vtc_tpu_torch.evaluation import retrieval_eval as port_re  # noqa: E402
from vtc_tpu_torch.models import create_model, state_dict_from_jax  # noqa: E402
from vtc_tpu_torch.models.retrieval import PretrainedCLIP_finaltf  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
BASE36 = "0123456789abcdefghijklmnopqrstuvwxyz"
TINY = "test-tiny"
RES = 32  # test-tiny's input resolution
LOSS_ATOL = 1e-5  # tests/test_torch_train_cli.py
NATIVE_ATOL = 4.8e-7  # the JAX package's native normalization against (x / 255 - mean) / std
VIDEO_CONFIGS = ("pretrained_clip_timesformer_comments_attention.jsonc",
                 "pretrained_clip_1frame_comments_attention.jsonc")


@pytest.fixture(autouse=True)
def _one_thread_cv2_route(monkeypatch):
    """Both packages on OpenCV; torch on one thread (the tier runs 6 files
    at once)."""
    monkeypatch.setenv("VTC_DECODE", "cv2")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_pil_batch(frames, size=224):
    """The JAX package's PIL transform (``preprocess.clip_preprocess``) of
    each frame at ``size``."""
    return np.stack([jax_pre.clip_preprocess(jax_pre.Image.fromarray(f), size)
                     for f in frames])


@pytest.fixture
def jax_pil_route(monkeypatch):
    """The JAX package's ``clip_preprocess_batch`` on the PIL transform."""
    monkeypatch.setattr(jax_datasets, "clip_preprocess_batch", jax_pil_batch)


def write_video(path, frames=60, w=64, h=48, fps=30, seed=0):
    """A smooth scene that moves: a gradient and a disc, with some noise,
    mp4v."""
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    yy, xx = np.mgrid[0:h, 0:w]
    base = rng.integers(0, 256, 3)
    for f in range(frames):
        img = np.stack([(xx * 4 + f * 3 + base[0]) % 256, (yy * 5 + base[1]) % 256,
                        ((xx + yy) * 2 + f + base[2]) % 256], -1).astype(np.uint8)
        cx, cy = (f * 2) % w, h // 2
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < 64] = (255, 255 - f % 256, 0)
        img = np.clip(img + rng.integers(0, 6, img.shape), 0, 255).astype(np.uint8)
        writer.write(img)
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clips")
    bad = tmp / "bad.mp4"
    bad.write_bytes(b"\x00\x00\x00\x18ftypmp42" + bytes(200))
    return {"long": write_video(tmp / "long.mp4", 90, 80, 60, seed=1),
            "short": write_video(tmp / "short.mp4", 20, 64, 48, seed=2),
            "wide": write_video(tmp / "wide.mp4", 45, 96, 40, fps=25, seed=3),
            "bad": str(bad)}


VIDEO_DIR = REPO / "tests" / "data" / "video"
# the committed fixture's decodes: (name, read_video_segment's keywords)
FIXTURE_CASES = {"full": {}, "segment": dict(start_sec=1.3, end_sec=2.5),
                 "subsample_to": dict(subsample_to=8)}


def make_video_fixture(out_dir):
    """The committed fixture ``clip_160x120.mp4`` (mp4v, 90 frames at 30 fps,
    a scrolling gradient and a moving disc: smooth, so its decodes compress)
    and ``cv2_decodes.npz``: the running OpenCV's decodes of it through the
    port's ``read_video_segment`` for each of ``FIXTURE_CASES`` (with the
    cases as JSON, the duration, and the index in the full decode of each
    frame of the other two)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "clip_160x120.mp4"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (160, 120))
    yy, xx = np.mgrid[0:120, 0:160]
    for f in range(90):
        img = np.stack([(xx + 2 * f) % 256, (yy * 2 + f) % 256, 128 + 0 * xx], -1)
        img[(xx - 20 - f) ** 2 + (yy - 60) ** 2 < 225] = (40, 200, 255)
        writer.write(img.astype(np.uint8))
    writer.release()
    decodes = {name: video.read_video_segment(str(path), **kw)
               for name, kw in FIXTURE_CASES.items()}
    full = decodes["full"].astype(np.int16)
    index = {f"{name}_index": np.array([int(np.abs(full - fr.astype(np.int16)).mean(
        axis=(1, 2, 3)).argmin()) for fr in decodes[name]]) for name in decodes}
    np.savez_compressed(out_dir / "cv2_decodes.npz", **decodes, **index,
                        cases=np.array(json.dumps(FIXTURE_CASES)),
                        duration=np.array(video.video_duration_sec(str(path))))
    return path


def test_committed_video_fixture_decodes_as_recorded(tmp_path):
    """The committed mp4 decodes as ``cv2_decodes.npz`` records, and its
    generator makes a file that decodes the same; the fixture stays small."""
    ref = np.load(VIDEO_DIR / "cv2_decodes.npz")
    assert json.loads(str(ref["cases"])) == FIXTURE_CASES
    path = str(VIDEO_DIR / "clip_160x120.mp4")
    for name, kw in FIXTURE_CASES.items():
        np.testing.assert_array_equal(video.read_video_segment(path, **kw), ref[name])
        np.testing.assert_array_equal(jax_video.read_video_segment(path, **kw), ref[name])
    assert ref["full"].shape == (90, 120, 160, 3) and len(ref["subsample_to"]) == 8
    assert ref["full_index"].tolist() == list(range(90))
    assert float(ref["duration"]) == video.video_duration_sec(path) == 3.0
    made = make_video_fixture(tmp_path)
    made_ref = np.load(tmp_path / "cv2_decodes.npz")
    for name in FIXTURE_CASES:
        np.testing.assert_array_equal(made_ref[name], ref[name])
    assert made.stat().st_size < 100_000
    assert sum(f.stat().st_size for f in VIDEO_DIR.iterdir()) < 4_000_000


# ---- decode -------------------------------------------------------------------------

SEGMENT_CASES = {
    "full": {},
    "segment": dict(start_sec=0.5, end_sec=1.6),
    "from 1.1 s": dict(start_sec=1.1),
    "max_frames": dict(max_frames=10),
    "subsample_to": dict(subsample_to=8),
    "segment subsample": dict(start_sec=0.3, end_sec=2.2, subsample_to=8),
    "resize height": dict(resize_height=300, subsample_to=8),
    "resize width": dict(resize_width=30, resize_height=0, max_frames=5),
    "resize both": dict(resize_width=50, resize_height=20, start_sec=0.2, end_sec=1.0),
    "past the end": dict(start_sec=9.0, end_sec=10.0),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_read_video_segment_matches_jax(clips, case):
    for name in ("long", "short", "wide", "bad"):
        kw = SEGMENT_CASES[case]
        ours = video.read_video_segment(clips[name], **kw)
        ref = jax_video.read_video_segment(clips[name], **kw)
        assert ours.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref, err_msg=f"{name} {case}")


def test_read_video_full_and_duration_match_jax(clips):
    for name in ("long", "short", "wide", "bad"):
        full = video.read_video_full(clips[name])
        np.testing.assert_array_equal(full, jax_video.read_video_full(clips[name]))
        assert video.video_duration_sec(clips[name]) == jax_video.video_duration_sec(
            clips[name])
        # the first 8 frames decoded alone are a full decode's first 8
        np.testing.assert_array_equal(video.read_video_full(clips[name], max_frames=8),
                                      full[:8])
    assert video.video_duration_sec(clips["long"]) == 3.0
    assert video.read_video_full(clips["long"]).shape == (90, 60, 80, 3)
    assert video.read_video_full(clips["bad"]).shape == (0, 300, 300, 3)


def _warnings(caplog, logger):
    return [r.getMessage().split(":")[0] for r in caplog.records
            if r.name == logger and r.levelno == logging.WARNING]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("reddit", [True, False])
def test_read_segment_with_fallbacks_matches_jax(clips, train, reddit, caplog):
    """The random stride and start from the same seed (and the generator
    left in the same state), the frames equal; past the video's end the
    segment is retried on [0, 5] s, a broken file gives black frames, each
    with its warning."""
    cases = [("long", 3.0, (4, 8, 16, 32)), ("short", 0.67, (4, 8)),
             ("wide", 1.8, (16,)), ("long", 45.0, (4, 8, 16, 32)), ("bad", 10.0, (4,))]
    for seed, (name, length, strides) in enumerate(cases):
        kw = dict(video_length=length, frame_strides=strides, is_reddit=reddit, train=train,
                  resize_height=40)
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            ours = video.read_segment_with_fallbacks(clips[name], rng=rng, **kw)
            ref = jax_video.read_segment_with_fallbacks(clips[name], rng=jrng, **kw)
            assert _warnings(caplog, video.logger.name) == _warnings(
                caplog, jax_video.logger.name)
            said = _warnings(caplog, video.logger.name)
        np.testing.assert_array_equal(ours, ref, err_msg=f"{name} {length}")
        assert ours.shape[0] == 8
        assert rng.random() == jrng.random()
        if name == "bad":
            assert said == ["zero-length segment, retrying [0, 5]s",
                            "decode fallback failed, emitting black frames"]
            assert ours.shape == (8, 300, 300, 3) and not ours.any()
        elif name == "long" and length == 45.0 and train:  # a start past the end
            assert said == ["zero-length segment, retrying [0, 5]s"]
            np.testing.assert_array_equal(ours, video.read_video_segment(
                clips[name], 0, 5, resize_height=40, subsample_to=8))


def test_native_backend_and_a_missing_cv2_raise(clips, monkeypatch):
    monkeypatch.setenv("VTC_DECODE", "native")
    with pytest.raises(NotImplementedError, match="libav worker"):
        video.read_video_segment(clips["long"])
    with pytest.raises(NotImplementedError, match="libav worker"):
        video.video_duration_sec(clips["long"])
    monkeypatch.setenv("VTC_DECODE", "auto")
    assert video.read_video_segment(clips["short"]).shape == (20, 48, 64, 3)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="decodes video with OpenCV"):
        video.read_video_segment(clips["long"])
    with pytest.raises(ImportError, match="decodes video with OpenCV"):
        video.read_segment_with_fallbacks(clips["long"], video_length=3.0)


def test_linspace_subsample_matches_jax():
    vid = np.arange(37)[:, None]
    for n in (1, 8, 37, 50):
        np.testing.assert_array_equal(video.linspace_subsample(vid, n),
                                      jax_video.linspace_subsample(vid, n))


# ---- preprocessing --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 48, 64), (3, 300, 533), (2, 97, 211), (1, 300, 300),
                                   (4, 256, 256), (2, 40, 96)])
def test_clip_preprocess_batch_is_pils(shape):
    frames = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    ours = datasets.clip_preprocess_batch(frames)
    assert ours.dtype == np.float32 and ours.shape == (shape[0], 3, 224, 224)
    np.testing.assert_array_equal(ours, jax_pre.clip_preprocess_frames(frames))
    np.testing.assert_array_equal(ours, preprocess.clip_preprocess_frames(frames))
    np.testing.assert_array_equal(datasets.clip_preprocess_batch(frames, 32),
                                  jax_pil_batch(frames, 32))
    np.testing.assert_array_equal(datasets.clip_preprocess_batch(frames, 32),
                                  preprocess.clip_preprocess_frames(frames, 32))
    if jax_native.get_lib() is not None:  # the JAX package's native stage
        np.testing.assert_allclose(ours, jax_datasets.clip_preprocess_batch(frames),
                                   atol=NATIVE_ATOL, rtol=0)


# ---- the reddit corpus and its datasets ------------------------------------------------

def _rid(i):
    return "vz" + BASE36[(i // 36) % 36] + BASE36[i % 36]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """36 reddit rows (one of each last base-36 digit: 28 train, 4 val, 4
    test), a video each (lengths 20-70 frames, one broken file), comments
    with a bot's, one over-long title; a kinetics and a howto100m CSV."""
    tmp = tmp_path_factory.mktemp("videos")
    root = tmp / "media"
    (root / "vids").mkdir(parents=True)
    rows = []
    for i in range(36):
        rid = _rid(i)
        path = root / "vids" / f"{rid}.mp4"
        if i == 9:
            path.write_bytes(bytes(100))
        else:
            write_video(path, 20 + (i * 7) % 50, 48 + 8 * (i % 3), 36 + 4 * (i % 2), seed=i)
        comments = [f"comment {i} alpha", "i am a bot, ignore", f"comment {i} beta",
                    f"and {i} gamma"][: 1 + i % 4]
        title = ("a very long title " * 12) if i == 10 else f"synthetic video {i}"
        rows.append({"reddit_id": int(rid, 36), "video_path": f"results/vids/{rid}.mp4",
                     "title": title, "video_length": (20 + (i * 7) % 50) / 30,
                     "comments": str(comments)})
    csv = tmp / "posts.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)

    long_desc = "y" * 61
    kroot, hroot = tmp / "kinetics", tmp / "howto"
    krows, hrows = [], []
    for i, (k7, k4, part) in enumerate([("train", "train", "k/train/a.mp4"),
                                         ("train", None, "k/train/b.mp4"),
                                         ("test", "train", "k/train/c.mp4"),
                                         ("train", "train", "k/test/d.mp4"),
                                         ("train", "train", "k/train/missing.mp4")]):
        if "missing" not in part:
            (kroot / part).parent.mkdir(parents=True, exist_ok=True)
            write_video(kroot / part, 30, 32, 32, seed=100 + i)
        krows.append({"video_path": part, "split_k700": k7, "split_k400": k4,
                      "title_en": f"kinetics video {i}", "video_length": 1.0,
                      "comments": None if i == 1 else json.dumps([f"k comment {i}"]),
                      "description_en": None if i == 0 else f"{long_desc}. short. {long_desc}z"})
    for i in range(3):
        (hroot / "h").mkdir(parents=True, exist_ok=True)
        write_video(hroot / "h" / f"{i}.mp4", 25, 40, 30, seed=200 + i)
        hrows.append({"video_path": f"h/{i}.mp4", "title": f"howto video {i}",
                      "video_length": 25 / 30, "comments": json.dumps([f"h comment {i}"]),
                      "description": f"{long_desc}x. tiny"})
    kcsv, hcsv = tmp / "kinetics.csv", tmp / "howto.csv"
    pd.DataFrame(krows).to_csv(kcsv, index=False)
    pd.DataFrame(hrows).to_csv(hcsv, index=False)
    return {"csv": str(csv), "root": str(root), "kinetics_csv": str(kcsv),
            "kinetics_root": str(kroot), "howto100m_csv": str(hcsv), "howto100m_root": str(hroot)}


def _same_items(ours, ref, indices):
    for i in indices:
        a, b = ours[i], ref[i]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, dict):
                assert x == y
            elif y is None or isinstance(y, (str, int, np.integer)):
                assert x == y
            else:
                assert np.asarray(x).dtype == np.asarray(y).dtype, i
                np.testing.assert_array_equal(x, y, err_msg=f"item {i}")


SEGMENT_DATASETS = {
    "train": dict(train=True, add_comments="always", num_comms=3),
    "val": dict(train=False, add_comments="always", num_comms=5),
    "test": dict(train=False, test=True, add_comments="train_only"),
    "first_frame_only": dict(train=True, add_comments="always", num_comms=5,
                             first_frame_only=True, comment_sampling=None),
    "test over 2 comments": dict(train=False, test=True, test_on_over_k_comms=2,
                                 test_set_limit=2, add_comments="always"),
    "kinetics and howto100m": dict(train=True, use_kinetics_train="combine",
                                   use_howto100m_train="combine", add_comments="always"),
    "kinetics only": dict(train=True, use_kinetics_train="only", add_comments="always"),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_DATASETS))
def test_video_dataset_segments_matches_jax(corpus, jax_pil_route, case):
    kw = dict(SEGMENT_DATASETS[case], seed=3)
    if "kinetics" in case:
        kw.update({k: corpus[k] for k in corpus if k.startswith(("kinetics", "howto"))})
    ours = datasets.VideoDatasetSegments(corpus["csv"], corpus["root"], **kw)
    ref = jax_datasets.VideoDatasetSegments(corpus["csv"], corpus["root"], **kw)
    assert len(ours) == len(ref) > 0
    for attr in ("ids", "filenames", "titles", "video_lengths", "comments"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    indices = list(range(len(ours))) if len(ours) <= 6 else [0, 1, 2, len(ours) - 1]
    if case == "train":
        indices.append(ours.filenames.index(f"{corpus['root']}/vids/{_rid(10)}.mp4"))
    _same_items(ours, ref, indices)
    vid = ours[0][0]
    assert vid.shape == ((3, 224, 224) if kw.get("first_frame_only") else (8, 3, 224, 224))
    if case == "kinetics and howto100m":
        assert ours.ids[-5:] == [-1] * 5  # a, b kinetics; 3 howto100m
        # kinetics b: no comments, its description's two long sentences
        assert ours.comments[-4] == ["y" * 61, "y" * 61 + "z"]


def test_broken_video_gives_black_frames_in_the_dataset(corpus, jax_pil_route, caplog):
    """Row 9's file is no video: both packages fall to black frames, logged."""
    ours = datasets.VideoDatasetSegments(corpus["csv"], corpus["root"], train=True, seed=1)
    ref = jax_datasets.VideoDatasetSegments(corpus["csv"], corpus["root"], train=True, seed=1)
    i = ours.filenames.index(f"{corpus['root']}/vids/{_rid(9)}.mp4")
    with caplog.at_level(logging.WARNING):
        _same_items(ours, ref, [i])
    assert "emitting black frames" in caplog.text


def test_loader_batches_match_jax(corpus, jax_pil_route):
    make = {"port": datasets.VideoDatasetSegments, "jax": jax_datasets.VideoDatasetSegments}
    args = (corpus["csv"], corpus["root"])
    kw = dict(train=True, add_comments="always", num_comms=2, seed=5)
    ours = DataLoader(make["port"](*args, **kw), 4, shuffle=True, drop_last=True,
                      num_workers=0, seed=2)
    ref = JaxDataLoader(make["jax"](*args, **kw), 4, shuffle=True, drop_last=True,
                        num_workers=0, seed=2)
    for epoch, (a, b) in enumerate(zip(ours, ref)):
        if epoch == 2:
            break
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3]["id"].tolist() == list(b[3]["id"])


def test_reddit_dataset_matches_jax(corpus, jax_pil_route):
    kw = dict(num_comms=2, test_on_over_k_comms=1, test_set_limit=3, seed=4)
    ours = datasets.VideoDatasetReddit(corpus["root"], corpus["csv"], **kw)
    ref = jax_datasets.VideoDatasetReddit(corpus["root"], corpus["csv"], **kw)
    assert len(ours) == len(ref) == 3
    _same_items(ours, ref, range(3))
    frames, title, comments, rid = ours[0]
    assert frames.shape == (8, 3, 224, 224) and title.shape == (1, 77)
    assert comments.shape == (2, 77) and rid == ours.ids[0]
    with pytest.raises(AssertionError):
        datasets.VideoDatasetReddit(corpus["root"], corpus["csv"], split="val")


def test_livebot_matches_jax(corpus, tmp_path):
    rows = [{"video_path": f"vids/{_rid(i)}.mp4", "title": f"livebot {i}",
             "comments": str([f"danmaku {i}", "second"])} for i in (0, 9, 12)]
    csv = tmp_path / "livebot.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    for add in (True, False):
        ours = datasets.VideoDatasetLivebot(corpus["root"], str(csv), add_comments=add)
        ref = jax_datasets.VideoDatasetLivebot(corpus["root"], str(csv), add_comments=add)
        assert len(ours) == len(ref) == 3
        _same_items(ours, ref, range(3))
    assert ours[1][0] is None  # row 9's file is no video
    assert ours[0][0].dtype == np.uint8 and ours[0][3] == _rid(0)


# ---- the transfer-evaluation datasets ----------------------------------------------------

@pytest.fixture(scope="module")
def msrvtt(tmp_path_factory):
    """An MSRVTT-format root (8 videos, 7 captions each, one over 77 tokens)
    and a meta dir with every split's list and the jsfusion caption index."""
    root = tmp_path_factory.mktemp("msrvtt")
    (root / "TrainValVideo").mkdir()
    (root / "TestVideo").mkdir()
    meta = root / "meta"
    meta.mkdir()
    sentences, test_sentences, ids = [], [], [f"video{i}" for i in range(8)]
    for i, vid in enumerate(ids):
        folder = "TestVideo" if i >= 6 else "TrainValVideo"
        write_video(root / folder / f"{vid}.mp4", 24 + 8 * i, 48, 36, seed=300 + i)
        for c in range(7):
            caption = ("word " * 90) if (i, c) == (1, 2) else f"video number {i} caption {c}"
            (test_sentences if i >= 6 else sentences).append({"video_id": vid,
                                                              "caption": caption})
    (root / "train_val_videodatainfo.json").write_text(json.dumps({"sentences": sentences}))
    (root / "test_videodatainfo.json").write_text(json.dumps({"sentences": test_sentences}))
    for name, chosen in (("train_list_full", ids[:4]), ("val_list_full", ids[4:6]),
                         ("test_list_full", ids[6:]), ("train_list_jsfusion", ids[:5]),
                         ("val_list_jsfusion", ids[5:]), ("train_list_miech", ids[:6]),
                         ("test_list_miech", ids[6:] + ids[1:2])):
        (meta / f"{name}.txt").write_text("\n".join(chosen) + "\n\n")
    with open(meta / "jsfusion_val_caption_idx.pkl", "wb") as f:
        pickle.dump({v: 2 for v in ids[5:]}, f)
    return root, meta


@pytest.mark.parametrize("split", ["miech", "jsfusion", "full-val", "full-test"])
@pytest.mark.parametrize("train", [True, False])
def test_msrvtt_matches_jax(msrvtt, split, train, jax_pil_route):
    root, meta = msrvtt
    kw = dict(root=str(root), train=train, split=split, meta_dir=str(meta), seed=7)
    ours, ref = vr.VideoDatasetMSRVTT(**kw), jax_vr.VideoDatasetMSRVTT(**kw)
    assert ours.video_files == ref.video_files and dict(ours.captions) == dict(ref.captions)
    _same_items(ours, ref, range(len(ours)))
    if train and split == "full-val":  # augment: 5 fake comments a video, 5 x the items
        ours, ref = (vr.VideoDatasetMSRVTT(augment=True, **kw),
                     jax_vr.VideoDatasetMSRVTT(augment=True, **kw))
        assert len(ours) == len(ref) == 20
        _same_items(ours, ref, [0, 5, 19])
        assert ours[0][0].shape == (8, 3, 224, 224) and ours[0][2].shape == (5, 77)


def test_msrvtt_refusals(msrvtt, tmp_path):
    root, meta = msrvtt
    with pytest.raises(ValueError, match="Unknown MSRVTT split"):
        vr.VideoDatasetMSRVTT(root=str(root), split="nope", meta_dir=str(meta))
    with pytest.raises(FileNotFoundError, match="train_val_videodatainfo.json"):
        vr.VideoDatasetMSRVTT(root=str(tmp_path), split="full-val", meta_dir=str(meta))
    # the packaged lists are the JAX package's, byte for byte
    for sub in ("msrvtt_meta", "msvd_meta", "activitynet_meta"):
        for f in (REPO / "vtc_tpu/data/meta" / sub).iterdir():
            assert (vr.META_DIR / sub / f.name).read_bytes() == f.read_bytes()
    assert len((vr.META_DIR / "msrvtt_meta/val_list_full.txt").read_text().split()) == 497


@pytest.fixture(scope="module")
def msvd_and_activitynet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("msvd")
    (tmp / "YouTubeClips").mkdir()
    (tmp / "videos").mkdir()
    ids = [f"clip{i}" for i in range(4)]
    captions = {v: [["a", "clip", str(i)], ["another", "one", str(i)]] + (
        [["long"] * 90] if i == 1 else []) for i, v in enumerate(ids)}
    for i, v in enumerate(ids):
        write_video(tmp / "YouTubeClips" / f"{v}.avi", 20 + 4 * i, 40, 32, seed=400 + i)
        write_video(tmp / "videos" / f"{v}.mp4", 20 + 4 * i, 40, 32, seed=500 + i)
    for name, chosen in (("train_list", ids[:2]), ("val_list", ids[2:3]),
                         ("test_list", ids[3:]), ("val_1_list", ids[2:]),
                         ("val_2_list", ids[:1])):
        (tmp / f"{name}.txt").write_text("\n".join(chosen))
    with open(tmp / "raw-captions.pkl", "wb") as f:
        pickle.dump(captions, f)
    return tmp


@pytest.mark.parametrize("split", ["val", "test"])
def test_msvd_and_activitynet_match_jax(msvd_and_activitynet, split, jax_pil_route):
    tmp = str(msvd_and_activitynet)
    for train in (True, False):
        kw = dict(root=tmp, train=train, split=split, meta_dir=tmp)
        ours, ref = vr.VideoDatasetMSVD(seed=2, **kw), jax_vr.VideoDatasetMSVD(seed=2, **kw)
        _same_items(ours, ref, range(len(ours)))
        ours, ref = vr.VideoDatasetActivityNet(**kw), jax_vr.VideoDatasetActivityNet(**kw)
        _same_items(ours, ref, range(len(ours)))
    kw = dict(root=tmp, train=True, split=split, meta_dir=tmp, augment=True, seed=2)
    ours, ref = vr.VideoDatasetMSVD(**kw), jax_vr.VideoDatasetMSVD(**kw)
    assert len(ours) == 10
    with pytest.raises(AssertionError):  # a video of 2 captions makes no 5 fake comments
        ours[0]
    with pytest.raises(FileNotFoundError, match="raw-captions.pkl"):
        vr.VideoDatasetMSVD(root=tmp, split=split, meta_dir=str(REPO / "tests"))
    with pytest.raises(FileNotFoundError, match="split videos missing"):
        vr.VideoDatasetMSVD(root=str(REPO), split=split, meta_dir=tmp)


def test_k700_comments_matches_jax(tmp_path):
    (tmp_path / "kinetics700" / "train" / "x").mkdir(parents=True)
    (tmp_path / "kinetics700" / "train" / "x" / "seen.mp4").write_bytes(b"")
    (tmp_path / "k700" / "test").mkdir(parents=True)
    rows = []
    for i, (vid, lang, comments) in enumerate([
            ("keep0", "en", ["a", "b", "c"]), ("seen", "en", ["a", "b", "c"]),
            ("fr", "fr", ["a", "b", "c"]), ("few", "en", ["a", "b"]), ("none", "en", None),
            ("keep1", "en", ["x", "y", "z", "w"])]):
        write_video(tmp_path / "k700" / "test" / f"{vid}.mp4", 16, 32, 24, seed=600 + i)
        rows.append({"video_path": f"k700/test/{vid}.mp4", "kinetics_id": vid, "title_lang": lang,
                     "title": f"kinetics {vid}", "description": f"about {vid}",
                     "comments": None if comments is None else json.dumps(comments)})
    csv = tmp_path / "k700.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    ours = vr.VideoDatasetK700Comments(root=str(tmp_path), kinetics_csv=str(csv))
    ref = jax_vr.VideoDatasetK700Comments(root=str(tmp_path), kinetics_csv=str(csv))
    assert ours.video_files == ref.video_files and len(ours) == 2
    assert ours.descriptions == ref.descriptions
    _same_items(ours, ref, range(2))


# ---- the entry points: MSRVTT by name, and the train.py twin ---------------------------

@pytest.fixture(scope="module")
def cam_pair():
    """The JAX CAM model at test-tiny, its CAM moved off the zero-init, and
    the port's on the same weights."""
    module, variables = jax_create_model("PretrainedCLIP_finaltf", model_type=TINY, seed=0)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), variables["params"])
    rng = np.random.default_rng(0)
    params["cam"] = jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), params["cam"])
    model = PretrainedCLIP_finaltf(model_type=TINY)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return module, {"params": params}, model.eval()


@pytest.mark.parametrize("branch", [None, "skip"])
def test_retrieval_evaluation_of_msrvtt_by_name_matches_jax(msrvtt, cam_pair, branch,
                                                            jax_pil_route):
    module, variables, model = cam_pair
    root, meta = msrvtt
    roots = {"MSRVTT": {"root": str(root), "meta_dir": str(meta)}}
    kw = dict(branch_override=branch, data_roots=roots, image_size=RES, frame_stride=4)
    ref = jax_re.retrieval_evaluation(module, variables, "MSRVTT_videos", "full-val", **kw)
    ours = port_re.retrieval_evaluation(model, "MSRVTT_videos", "full-val", device="cpu", **kw)
    assert ours.columns == list(ref.columns) and ours.index == list(ref.index)
    np.testing.assert_array_equal(ours.to_numpy(), ref.to_numpy())


def _video_config(name, save_dir, corpus, msrvtt_root):
    """The config file at test-tiny: batch 4, 2 epochs, no workers, the
    adapter's random skip off, the MSRVTT probe's root."""
    from vtc_tpu_torch.utils import jsonc

    cfg = jsonc.read_json(REPO / "configs" / name)
    cfg["arch"]["args"].update(model_type=TINY, random_skip_adapter=False)
    cfg["dataset"]["args"].update(csv_file=corpus["csv"], root=corpus["root"], num_comms=2)
    cfg["trainer"].update(epochs=2, save_dir=str(save_dir), tensorboard=False)
    cfg.update(batch_size=4, num_workers=0, msrvtt_root=str(msrvtt_root))
    return cfg


def _recorded(monkeypatch, trainer_cls, make_probe_owner, eval_module):
    """Each epoch's log and each probe's result; the probe's evaluation at
    test-tiny's resolution and frame stride."""
    logs, probes = [], []
    run_epoch = trainer_cls._train_epoch

    def record(self, epoch):
        logs.append(run_epoch(self, epoch))
        return logs[-1]

    make_probe = make_probe_owner._make_probe

    def recorded_probe(config):
        probe = make_probe(config)

        def call(trainer, branch_override=None):
            probes.append(probe(trainer, branch_override))
            return probes[-1]
        return call

    monkeypatch.setattr(trainer_cls, "_train_epoch", record)
    monkeypatch.setattr(make_probe_owner, "_make_probe", recorded_probe)
    monkeypatch.setattr(eval_module, "retrieval_evaluation", functools.partial(
        eval_module.retrieval_evaluation, image_size=RES, frame_stride=4))
    return logs, probes


def _small_frames(monkeypatch, module):
    """The datasets' frames at test-tiny's resolution."""
    full = module.clip_preprocess_batch
    monkeypatch.setattr(module, "clip_preprocess_batch",
                        lambda frames, size=224: full(frames, RES))


@pytest.mark.parametrize("config", VIDEO_CONFIGS)
def test_twin_on_video_configs_tracks_train_main(config, corpus, msrvtt, tmp_path,
                                                  monkeypatch, jax_pil_route):
    sys.path.insert(0, str(REPO))
    import train as jax_train
    import vtc_tpu.evaluation as jax_eval_pkg
    from vtc_tpu.config import ConfigParser as JaxConfigParser
    from vtc_tpu.training.trainer import Trainer as JaxTrainer
    from vtc_tpu_torch.training import Trainer

    msrvtt_root, meta = msrvtt
    monkeypatch.setattr(jax_vr, "META_DIR", meta.parent)
    monkeypatch.setattr(vr, "META_DIR", meta.parent)
    (meta.parent / "msrvtt_meta").mkdir(exist_ok=True)
    for f in meta.iterdir():
        (meta.parent / "msrvtt_meta" / f.name).write_bytes(f.read_bytes())
    _small_frames(monkeypatch, jax_datasets)
    _small_frames(monkeypatch, datasets)

    logs_j, probes_j = _recorded(monkeypatch, JaxTrainer, jax_train, jax_eval_pkg)
    cfg = _video_config(config, tmp_path / "jax", corpus, msrvtt_root)
    jax_train.main(JaxConfigParser(copy.deepcopy(cfg)))

    def from_jax_weights(arch, seed, device, **args):
        _, variables = jax_create_model(arch, seed=seed, **args)
        model = create_model(arch, seed=seed, device=device, **args)
        model.load_state_dict(state_dict_from_jax(
            jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), variables["params"]),
            variables.get("batch_stats")))
        return model

    monkeypatch.setattr(twin, "create_model", from_jax_weights)
    logs, probes = _recorded(monkeypatch, Trainer, twin, port_re)
    cfg["trainer"]["save_dir"] = str(tmp_path / "port")
    twin.main(ConfigParser(cfg), device="cpu")

    assert len(logs) == len(logs_j) == 2
    for ours, ref in zip(logs, logs_j):
        assert sorted(ours) == sorted(ref)
        np.testing.assert_allclose(ours["loss"], ref["loss"], atol=LOSS_ATOL)
        np.testing.assert_allclose(ours["val_loss"], ref["val_loss"], atol=LOSS_ATOL)
        recall = {k: v for k, v in ref.items() if "recall" in k}
        assert len(recall) == 4 and {k: ours[k] for k in recall} == recall
    assert len(probes) == len(probes_j) == 4  # each epoch: the model, then the skip
    assert probes == probes_j
