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


@pytest.mark.parametrize("k", [1, 4, 6, 10, 32])
def test_ties_rank_as_lax_top_k(k):
    """A gallery of duplicated rows (8 seeded rows, each 4 times, ids 1000+):
    the ids and their order equal ``vtc_tpu``'s, whose ``lax.top_k`` puts
    ties lower gallery row first, at a k inside and at the edge of a tie
    group, and over the whole gallery."""
    base = np.random.default_rng(0).standard_normal((8, 512)).astype(np.float32)
    gallery = np.repeat(base, 4, axis=0)
    ids = np.arange(1000, 1032)
    jindex, index = JaxIndex(512), RetrievalIndex(512, device="cpu")
    jindex.add(gallery, ids)
    index.add(gallery, ids)
    queries = base[:2]
    _same(index.search(queries, k=k), jindex.search(queries, k=k))
    if k == 6:  # the case the tie order used to change (ROADMAP, Queue 3 item 4)
        np.testing.assert_array_equal(index.search(queries, k=6)[0],
                                      [[1000, 1001, 1002, 1003, 1016, 1017],
                                       [1004, 1005, 1006, 1007, 1020, 1021]])


@pytest.mark.parametrize("k", [6, 12, 30, 31, 32])
def test_sharded_gallery_ranks_as_one_shard_and_as_jax(k):
    """The duplicate-row gallery of ``test_ties_rank_as_lax_top_k`` cut to 30
    rows (not a multiple of the 4 shards: 2 rows of padding): the ids and
    scores of the one-shard index over its columns, and ``vtc_tpu``'s index
    sharded over a 4-device data axis over all of them, the pad rows as id
    -1 where ``k`` passes the 30 real rows."""
    from vtc_tpu.parallel.mesh import create_mesh

    base = np.random.default_rng(0).standard_normal((8, 512)).astype(np.float32)
    gallery = np.repeat(base, 4, axis=0)[:30]
    ids = np.arange(1000, 1030)
    one = RetrievalIndex(512, device="cpu")
    sharded = RetrievalIndex(512, devices=["cpu"] * 4)
    jindex = JaxIndex(512, mesh=create_mesh(4, 1, devices=jax.devices()[:4]))
    for index in (one, sharded, jindex):
        index.add(gallery, ids)
    queries = np.concatenate([base[:2], base[7:8]])
    got, want, ref = sharded.search(queries, k), one.search(queries, k), jindex.search(queries, k)
    assert got[0].shape == (3, min(k, 32))
    cols = min(k, 30)
    np.testing.assert_array_equal(got[0][:, :cols], want[0])
    np.testing.assert_allclose(got[1][:, :cols], want[1], atol=SCORE_ATOL, rtol=0)
    _same(got, ref)
    if k > 30:
        assert (got[0][:, 30:] == -1).all() and np.isneginf(got[1][:, 30:]).all()
    assert len(sharded) == 30 and [g.shape[0] for g in sharded._shards] == [8] * 4
    sharded.add(base[:1], [2000])  # re-open: the padding is not carried over
    assert len(sharded) == 31 and sharded.search(base[:1], 32)[0][0, 4] == 2000
