"""The port's HTTP serving (``serving/server.py``), ``scripts/serve.py`` and
embedding script twins against the JAX package's, on the CPU, at
test-tiny with the JAX weights carried across by ``state_dict_from_jax``.

* The JAX server and the port's over one gallery (6 self-encoded titles
  and 40 seeded rows), both on free local ports: ``/healthz``,
  ``/search/text`` and ``/search/image`` (floats) give equal ids and scores
  within 1e-5;
* ``images_b64`` (JPEG and PNG) on the port's CPU route equal, JSON for
  JSON, posting the floats that the port's ``clip_preprocess`` makes of
  PIL's decode of the same bytes (``tests/test_serving.py:230``), and the
  committed PNG fixtures too;
* every 400 and 404 of ``tests/test_serving.py:269-313``, on both servers;
* ``warmup`` runs each text bucket;
* ``scripts/serve.py``'s ``build_server`` from a config and a gallery
  ``.npz`` (``tests/test_serving.py:315``), with a ``.pth`` checkpoint, and
  its refusals;
* the embedding script on ``tests/test_feature_scripts.py``'s CSV: the
  ``reddit_ids``, the ``[10, 32]`` finite embeddings that round-trip
  through ``load_features``, equal within 2e-5 to the JAX script's in
  fp32 from one seeded CLIP file; its refusal of a mesh.
"""

import base64
import io
import json
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from vtc_tpu.data import tokenizer as jax_tk
from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.serving import ClipRetrievalService as JaxService
from vtc_tpu.serving import RetrievalIndex as JaxIndex
from vtc_tpu.serving.server import RetrievalHTTPServer as JaxServer
from vtc_tpu_torch.data import clip_preprocess, load_features, read_csv, tokenize
from vtc_tpu_torch.models import create_model, state_dict_from_jax
from vtc_tpu_torch.models.retrieval import PretrainedCLIP
from vtc_tpu_torch.scripts import get_clip_vit_embeddings, serve
from vtc_tpu_torch.serving import ClipRetrievalService, RetrievalHTTPServer, RetrievalIndex

REPO = Path(__file__).resolve().parents[1]
PNG_DIR = REPO / "tests" / "data" / "png"
TINY = "test-tiny"
DIM = 32
SCORE_ATOL = 1e-5
FEAT_ATOL = 2e-5


def _post(port, path, payload, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def servers():
    """The JAX server and the port's over one gallery, ``max_batch`` 8."""
    module, variables = jax_create_model("PretrainedCLIP", model_type=TINY, seed=0)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), variables["params"])
    model = PretrainedCLIP(model_type=TINY)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()
    titles = [f"a video about topic {i}" for i in range(6)]
    feats = np.asarray(module.apply(variables, jnp.asarray(jax_tk.tokenize(titles)),
                                    method="encode_text"))
    gallery = np.concatenate([feats, np.random.default_rng(0).normal(size=(40, DIM))])
    ids = np.concatenate([100 + np.arange(6), 1000 + np.arange(40)])
    jindex, index = JaxIndex(DIM), RetrievalIndex(DIM, device="cpu")
    jindex.add(gallery, ids)
    index.add(gallery, ids)
    kw = dict(port=0, max_k=10, max_batch=8, image_size=32)
    jserver = JaxServer(JaxService(module, variables, jindex), tokenizer=jax_tk.tokenize, **kw)
    server = RetrievalHTTPServer(ClipRetrievalService(model, index, device="cpu"),
                                 tokenizer=tokenize, **kw)
    jserver.start()
    server.start()
    yield jserver, server
    jserver.shutdown()
    server.shutdown()


def _same(ours, ref):
    assert ours[0] == ref[0] == 200, (ours, ref)
    assert ours[1]["ids"] == ref[1]["ids"]
    np.testing.assert_allclose(ours[1]["scores"], ref[1]["scores"], atol=SCORE_ATOL, rtol=0)


def test_healthz_and_text_search_match_jax(servers):
    jserver, server = servers
    assert _get(server.port, "/healthz") == _get(jserver.port, "/healthz") == {
        "status": "ok", "gallery_size": 46}
    for queries, k in ((["a video about topic 3", "a video about topic 0"], 3),
                       (["something else entirely"], 10), ([f"topic {i}" for i in range(5)], 1)):
        payload = {"queries": queries, "k": k}
        ours = _post(server.port, "/search/text", payload)
        _same(ours, _post(jserver.port, "/search/text", payload))
    ours = _post(server.port, "/search/text",
                 {"queries": ["a video about topic 3", "a video about topic 0"], "k": 3})[1]
    assert ours["ids"][0][0] == 103 and ours["ids"][1][0] == 100
    assert ours["scores"][0] == sorted(ours["scores"][0], reverse=True)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_image_search_matches_jax(servers, n):
    jserver, server = servers
    images = np.random.default_rng(n).normal(size=(n, 3, 32, 32)).astype(np.float32)
    payload = {"images": images.tolist(), "k": 4}
    _same(_post(server.port, "/search/image", payload),
          _post(jserver.port, "/search/image", payload))


def _encoded(raw: np.ndarray, fmt: str, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(raw).save(buf, format=fmt, **opts)
    return buf.getvalue()


@pytest.mark.parametrize("fmt,opts", [("JPEG", {}), ("JPEG", {"subsampling": 0}),
                                      ("PNG", {})])
def test_b64_images_equal_posting_preprocessed_floats(servers, fmt, opts):
    """The CPU route decodes with PIL: a base64 image gives the JSON that
    posting ``clip_preprocess`` of PIL's decode gives, bit for bit; and the
    JAX server, which decodes the same bytes, the same ids."""
    jserver, server = servers
    raw = np.random.default_rng(7).integers(0, 255, (48, 40, 3), dtype=np.uint8)
    data = _encoded(raw, fmt, **opts)
    b64 = _post(server.port, "/search/image",
                {"images_b64": [base64.b64encode(data).decode()], "k": 3})
    decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    floats = _post(server.port, "/search/image",
                   {"images": clip_preprocess(decoded, 32)[None].tolist(), "k": 3})
    assert b64[0] == floats[0] == 200
    assert b64[1] == floats[1]
    _same(b64, _post(jserver.port, "/search/image",
                     {"images_b64": [base64.b64encode(data).decode()], "k": 3}))


def test_png_fixtures_through_the_server(servers):
    """Each committed PNG (gray, gray+alpha, RGB, RGBA, palette) posted as
    base64 gives what posting its committed PIL decode's floats gives."""
    _, server = servers
    ref = np.load(PNG_DIR / "pil_decodes.npz")
    items = [base64.b64encode((PNG_DIR / f"{n}.png").read_bytes()).decode()
             for n in ref.files]
    b64 = _post(server.port, "/search/image", {"images_b64": items, "k": 5})
    floats = _post(server.port, "/search/image", {
        "images": np.stack([clip_preprocess(ref[n], 32) for n in ref.files]).tolist(),
        "k": 5})
    assert b64[0] == 200 and b64[1] == floats[1]


def _statuses(port):
    statuses = []
    for payload in ({}, {"images": [[0.0]], "images_b64": ["aaaa"]}, {"images_b64": ["!!!"]},
                    {"images_b64": [base64.b64encode(b"not an image").decode()]},
                    {"images_b64": "x"}, {"images_b64": ["aGk="] * 9},
                    {"images": [1.0, 2.0]}):
        statuses.append(_post(port, "/search/image", payload)[0])
    for payload in ({"queries": "not a list"}, {"queries": []}, {"queries": ["x"] * 9},
                    {"queries": ["x"], "k": 99}, {"queries": ["x"], "k": 0}):
        statuses.append(_post(port, "/search/text", payload)[0])
    statuses.append(_post(port, "/search/text", None, raw=b"{not json")[0])
    statuses.append(_post(port, "/nope", {})[0])
    return statuses


def test_every_refusal_matches_jax(servers):
    jserver, server = servers
    ours = _statuses(server.port)
    assert ours == [400] * 13 + [404]
    assert ours == _statuses(jserver.port)
    status, body = _post(server.port, "/search/image", {"images_b64": ["aGk="] * 9})
    assert "max_batch=8" in body["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{server.port}/nope", timeout=60)
    assert e.value.code == 404


def test_warmup_runs_each_text_bucket(servers):
    _, server = servers
    seen = []
    search = server.service.search_text

    def spy(tokens, k=10):
        seen.append(np.asarray(tokens).shape)
        return search(tokens, k)

    server.service.search_text = spy
    try:
        server.warmup(max_bucket=8)
    finally:
        del server.service.search_text
    assert seen == [(1, 77), (2, 77), (4, 77), (8, 77)]


class _FakeCall:
    """A C entry of the nvJPEG binding that returns ``rc``."""
    argtypes = ()

    def __init__(self, rc):
        self.rc = rc

    def __call__(self, *args):
        return self.rc


def _fail_to_load(stem):
    raise RuntimeError(f"nvcc failed to build {stem}")


# (what the binding does, the status, what the reply must say)
CARD_ROUTE_FAULTS = {
    "binding_fails_to_build": (_fail_to_load, 500, "internal error"),
    "bad_jpeg": (3, 400, "BAD_JPEG"),
    "incomplete_bitstream": (10, 400, "INCOMPLETE_BITSTREAM"),
    "execution_failed": (6, 500, "internal error"),
    "cuda_error": (1000 + 700, 500, "internal error"),
}


@pytest.mark.parametrize("case", sorted(CARD_ROUTE_FAULTS))
def test_card_route_decode_faults_are_the_servers(servers, monkeypatch, caplog, case):
    """On the card's route, bytes at fault get a 400 and the decoder's own
    faults (a binding that does not build, nvJPEG failing otherwise than on
    the bitstream, a CUDA error) a logged 500, never a client's 400. The
    route is taken on the CPU by naming the card to ``decode_rgb``, with
    the binding stubbed: every case fails before the card is touched."""
    from vtc_tpu_torch.data import image_io

    _, server = servers
    binding, status, said = CARD_ROUTE_FAULTS[case]
    monkeypatch.setattr(image_io, "resolve_device", lambda device: torch.device("cuda"))
    if callable(binding):
        monkeypatch.setattr(image_io._build, "load_library", binding)
    else:
        calls = {name: _FakeCall(0) for name in ("vtc_jpeg_decode", "vtc_ycc_to_rgb")}
        lib = type("Lib", (), dict(calls, vtc_jpeg_info=_FakeCall(binding)))()
        monkeypatch.setattr(image_io._build, "load_library", lambda stem: lib)
    jpeg = base64.b64encode((REPO / "tests/data/jpeg/rgb420_480x360.jpg").read_bytes())
    with caplog.at_level("ERROR", logger="vtc_tpu_torch.serving.server"):
        got = _post(server.port, "/search/image", {"images_b64": [jpeg.decode()]})
    assert got[0] == status and said in got[1]["error"], got
    assert ("request failed" in caplog.text) == (status == 500)
    # bytes at fault on the card's route: a PNG that is broken, a JPEG of a
    # sampling refused by name, bytes of neither format
    png = bytearray((PNG_DIR / "rgb.png").read_bytes())
    png[50] ^= 0xFF  # in the IDAT chunk: its CRC fails
    for raw, said in ((bytes(png), "bad CRC"), (b"neither", "not a JPEG")):
        got = _post(server.port, "/search/image",
                    {"images_b64": [base64.b64encode(raw).decode()]})
        assert got[0] == 400 and said in got[1]["error"], got


def test_bomb_sized_jpeg_is_a_400_before_the_binding(servers, monkeypatch):
    """A JPEG whose frame header claims 20000 x 20000 pixels gets a 400 on
    the card's route, refused from the header: the binding (stubbed to fail
    the request with a 500 if asked) is never built or called."""
    from vtc_tpu_torch.data import image_io

    _, server = servers
    monkeypatch.setattr(image_io, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(image_io._build, "load_library", _fail_to_load)
    data = bytearray((REPO / "tests/data/jpeg/rgb420_480x360.jpg").read_bytes())
    sof = data.index(b"\xff\xc0")
    data[sof + 5 : sof + 9] = (20000).to_bytes(2, "big") * 2
    got = _post(server.port, "/search/image",
                {"images_b64": [base64.b64encode(bytes(data)).decode()]})
    assert got[0] == 400 and "decompression bomb" in got[1]["error"], got


def test_server_on_the_card_route_needs_a_card(monkeypatch):
    """Without a card the service's default device raises; nothing falls
    back to the CPU or to PIL."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_server({"arch": {"type": "PretrainedCLIP", "args": {"model_type": TINY}}},
                           None, PNG_DIR / "none.npz", port=0)


# ---- scripts/serve.py -------------------------------------------------------------

def test_build_server_from_a_gallery_npz(tmp_path):
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(5, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    np.savez(tmp_path / "gallery.npz", embeddings=emb, reddit_ids=np.arange(5))
    config = {"arch": {"type": "PretrainedCLIP", "args": {"model_type": TINY}}}
    server = serve.build_server(config, None, tmp_path / "gallery.npz", port=0, device="cpu")
    try:
        server.start()
        status, out = _post(server.port, "/search/text", {"queries": ["hello"], "k": 2})
        assert status == 200 and len(out["ids"][0]) == 2
        assert _get(server.port, "/healthz")["gallery_size"] == 5
    finally:
        server.shutdown()


def test_build_server_takes_a_checkpoint_and_an_index_file(tmp_path, capsys):
    """A ``.pth`` of other weights is grafted (the CAM keys it lacks are
    reported), and a ``RetrievalIndex.save`` file serves as the gallery."""
    from vtc_tpu_torch.training.checkpoints import save_checkpoint

    plain = create_model("PretrainedCLIP", model_type=TINY, seed=4, device="cpu")
    ckpt = save_checkpoint(tmp_path, "model_best", arch="PretrainedCLIP", epoch=1,
                           state_dict=plain.state_dict())
    index = RetrievalIndex(DIM, device="cpu")
    index.add(np.random.default_rng(2).normal(size=(7, DIM)), np.arange(7) + 50)
    index.save(tmp_path / "index.npz")
    config = {"arch": {"type": "PretrainedCLIP_finaltf", "args": {"model_type": TINY}}}
    server = serve.build_server(config, ckpt, tmp_path / "index.npz", port=0, device="cpu")
    err = capsys.readouterr().err
    assert "warm-start:" in err and "/ 0 unexpected keys" in err
    assert "warm-start: 0 missing" not in err  # the plain model lacks the CAM
    model = server.service.model
    assert torch.equal(model.model.text_projection, plain.model.text_projection)
    assert len(server.service.index) == 7
    server._httpd.server_close()
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        serve.build_server(config, None, tmp_path / "index.npz", n_devices=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Orbax"):
        serve.build_server(config, tmp_path, tmp_path / "index.npz", device="cpu")


# ---- the embedding script -----------------------------------------------------------

@pytest.fixture(scope="module")
def thumbnails(tmp_path_factory):
    """``tests/test_feature_scripts.py``'s CSV: 10 rows, 40x50 JPEGs, and
    one seeded openai-layout CLIP file at test-tiny."""
    tmp_path = tmp_path_factory.mktemp("thumbs")
    rng = np.random.default_rng(0)
    root = tmp_path / "media"
    (root / "v").mkdir(parents=True)
    rows = []
    for i in range(10):
        rows.append({"reddit_id": 1000 + i, "video_path": f"results/v/x{i}.mp4"})
        Image.fromarray(rng.integers(0, 255, (40, 50, 3), dtype=np.uint8)).save(
            root / "v" / f"x{i}.jpg")
    csv = tmp_path / "posts.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    g = torch.Generator().manual_seed(3)
    names = {k[len("model."):]: v.shape for k, v in
             PretrainedCLIP(model_type=TINY).state_dict().items() if k.startswith("model.")}
    sd = {k: 0.05 * torch.randn(shape, generator=g) + (1.0 if ".ln_" in f".{k}" and
                                                      k.endswith("weight") else 0.0)
          for k, shape in names.items()}
    sd.update(input_resolution=torch.tensor(32), context_length=torch.tensor(77),
              vocab_size=torch.tensor(49408))
    torch.save(sd, tmp_path / "clip.pt")
    return tmp_path, csv, root, tmp_path / "clip.pt"


def _args(csv, root, out, weights, *extra):
    return ["--csv", str(csv), "--root", str(root), "--out", str(out), "--batch_size", "4",
            "--num_workers", "0", "--model_type", TINY, "--image_size", "32",
            "--clip_weights", str(weights), *extra]


def test_embedding_script_matches_jax(thumbnails, monkeypatch):
    tmp, csv, root, weights = thumbnails
    sys.path.insert(0, str(REPO / "scripts"))
    import importlib

    jax_script = importlib.import_module("get_clip_vit_embeddings")
    ref_out, out = tmp / "ref.npz", tmp / "ours.npz"
    monkeypatch.setattr(sys, "argv", ["get_clip_vit_embeddings.py",
                                      *_args(csv, root, ref_out, weights, "--fp32")])
    jax_script.main()
    get_clip_vit_embeddings.main(_args(csv, root, out, weights, "--fp32", "--device", "cpu"))
    with np.load(out) as z, np.load(ref_out) as r:
        assert list(z["reddit_ids"]) == list(r["reddit_ids"]) == [1000 + i for i in range(10)]
        assert z["embeddings"].shape == (10, DIM) and z["embeddings"].dtype == np.float32
        np.testing.assert_allclose(z["embeddings"], r["embeddings"], atol=FEAT_ATOL, rtol=0)
        emb = z["embeddings"]
    np.testing.assert_allclose(load_features(read_csv(csv), str(out)), emb)


def test_embedding_script_in_bf16_and_refusals(thumbnails):
    tmp, csv, root, weights = thumbnails
    out = tmp / "bf16.npz"
    emb = get_clip_vit_embeddings.main(_args(csv, root, out, weights, "--device", "cpu"))
    fp32 = get_clip_vit_embeddings.main(_args(csv, root, tmp / "fp32.npz", weights, "--fp32",
                                              "--device", "cpu"))
    assert emb.shape == (10, DIM) and np.isfinite(emb).all()
    cos = (emb * fp32).sum(-1) / np.linalg.norm(emb, axis=-1) / np.linalg.norm(fp32, axis=-1)
    assert cos.min() > 0.995  # tests/test_clip_parity.py::test_bf16_close_to_fp32
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        get_clip_vit_embeddings.main(_args(csv, root, out, weights, "--n_devices", "2",
                                           "--device", "cpu"))
