"""The port's serving (vtc_tpu_torch.serving) against the JAX package's
RetrievalIndex and ClipRetrievalService, on the CPU, with the same
``test-tiny`` PretrainedCLIP weights: top-k ids equal, scores within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtc_tpu.models import create_model as jax_create_model
from vtc_tpu.serving import ClipRetrievalService as JaxService
from vtc_tpu.serving import RetrievalIndex as JaxIndex
from vtc_tpu_torch.data import extract_patches, synthetic_tokens
from vtc_tpu_torch.models import state_dict_from_jax
from vtc_tpu_torch.models.retrieval import PretrainedCLIP
from vtc_tpu_torch.serving import ClipRetrievalService, RetrievalIndex

TINY = "test-tiny"
DIM = 32
SCORE_ATOL = 1e-5


@pytest.fixture(scope="module")
def services():
    """The JAX and the port's service over one gallery: 200 seeded rows plus
    the features of 8 images, ids 1000+."""
    module, variables = jax_create_model("PretrainedCLIP", model_type=TINY, seed=0)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    variables["params"])
    model = PretrainedCLIP(model_type=TINY)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()

    rng = np.random.default_rng(0)
    images = extract_patches(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8), 8)
    with torch.no_grad():
        feats = model.encode_image(torch.from_numpy(images)).numpy()
    gallery = np.concatenate([rng.normal(size=(200, DIM)).astype(np.float32), feats])
    ids = np.arange(1000, 1000 + len(gallery))

    jindex, index = JaxIndex(DIM), RetrievalIndex(DIM, device="cpu")
    jindex.add(gallery, ids)
    index.add(gallery, ids)
    return (JaxService(module, variables, jindex),
            ClipRetrievalService(model, index, device="cpu"), images, ids)


def _same(ours, ref):
    np.testing.assert_array_equal(ours[0], np.asarray(ref[0]))
    np.testing.assert_allclose(ours[1], np.asarray(ref[1]), atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("n", [3, 5])
def test_search_text_matches_jax(services, n):
    jsvc, svc, _, _ = services
    toks = synthetic_tokens((n,), 16, 9, np.random.default_rng(n))
    _same(svc.search_text(toks, k=7), jsvc.search_text(jnp.asarray(toks), k=7))


@pytest.mark.parametrize("n", [3, 5])
def test_search_image_matches_jax(services, n):
    jsvc, svc, images, ids = services
    ours = svc.search_image(images[:n], k=4)
    _same(ours, jsvc.search_image(jnp.asarray(images[:n]), k=4))
    # each image finds its own gallery row first
    np.testing.assert_array_equal(ours[0][:, 0], ids[200:200 + n])


def test_bucketing_gives_the_unbucketed_result(services):
    _, svc, images, _ = services
    with torch.no_grad():  # the 3 queries encoded unpadded, ranked directly
        feats = svc.model.encode_image(torch.from_numpy(images[:3]))
    unbucketed = svc.index.search(feats, k=5)
    for a, b in zip(svc.search_image(images[:3], k=5), unbucketed):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_index_matches_jax_and_reopens():
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(50, 16)).astype(np.float32)
    emb[7] = np.inf  # a non-finite row ranks last, as in JAX
    queries = rng.normal(size=(4, 16)).astype(np.float32)
    jindex, index = JaxIndex(16), RetrievalIndex(16, device="cpu")
    for ix in (jindex, index):
        ix.add(emb[:30], np.arange(30))
    _same(index.search(queries, k=5), jindex.search(queries, k=5))
    for ix in (jindex, index):  # add after a search re-opens the index
        ix.add(emb[30:], np.arange(30, 50))
    assert len(index) == 50
    _same(index.search(queries, k=50), jindex.search(queries, k=50))


def test_index_save_load_and_errors(tmp_path):
    emb = np.random.default_rng(2).normal(size=(10, 8)).astype(np.float32)
    index = RetrievalIndex(8, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        index.search(emb[:1])
    with pytest.raises(ValueError, match="embeddings must be"):
        index.add(emb[:, :4], np.arange(10))
    index.add(emb, np.arange(10))
    index.save(tmp_path / "idx.npz")
    loaded = RetrievalIndex.load(tmp_path / "idx.npz", device="cpu")
    # load normalizes the saved (normalized) rows again: within an fp32 ulp
    _same(loaded.search(emb[:3], k=3), index.search(emb[:3], k=3))
