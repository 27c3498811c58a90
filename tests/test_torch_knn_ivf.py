"""The PyTorch port's KNN against euler_tpu/knn.py on the CPU: the IVF
index (k-means centroids, member tables, searches at every nprobe, the
padding of an under-filled result), the CLI for both indexes, and the
exact index's refusal of ``k`` past the corpus, also through ``/knn``.

Centroids must agree within 1e-5 (the two packages multiply in other
orders). Member tables and search ids must be equal except where a
point's two nearest centroids, or a query's k-th and (k+1)-th distances,
lie within ``MARGIN`` (some 10 ulps of these distances); the tests count
such points and expect none on the well-separated blobs they search.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from euler_tpu import knn as jax_knn
from euler_tpu import serving as jax_serving
from euler_tpu_torch import knn, serving

MARGIN = 1e-4


def blobs(n=1600, d=16, centers=8, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 4, (centers, d))
    pts = c[rng.integers(0, centers, n)] + rng.normal(0, 1, (n, d))
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    return blobs()


@pytest.fixture(scope="module")
def pair(corpus):
    ids = np.arange(len(corpus)) * 3 + 7
    kw = dict(n_clusters=12, nprobe=3, iters=10, seed=2)
    return (jax_knn.IvfKnnIndex(corpus, ids, **kw),
            knn.IvfKnnIndex(corpus, ids, device="cpu", **kw))


def near_ties(dist: np.ndarray, k: int) -> np.ndarray:
    """Rows whose k-th and (k+1)-th smallest of ``dist`` lie within
    MARGIN."""
    part = np.sort(dist, axis=1)
    return part[:, k] - part[:, k - 1] <= MARGIN


def test_centroids_and_member_tables_equal_the_reference(pair, corpus):
    ref, got = pair
    cent = got._cent.numpy()
    np.testing.assert_allclose(cent, np.asarray(ref._cent), atol=1e-5,
                               rtol=0)
    # points whose two nearest centroids lie within the margin
    d = ((corpus[:, None, :].astype(np.float64) - cent[None]) ** 2).sum(-1)
    assert near_ties(d, 1).sum() == 0
    np.testing.assert_array_equal(got._members.numpy(),
                                  np.asarray(ref._members))
    assert got.nprobe == ref.nprobe == 3


@pytest.mark.parametrize("nprobe", [1, 3, 12])
def test_search_ids_equal_the_reference(pair, corpus, nprobe):
    ref, got = pair
    q = blobs(64, seed=5)
    want_d, want_i = ref.search(q, k=10, nprobe=nprobe)
    d, i = got.search(q, k=10, nprobe=nprobe)
    exact = ((q[:, None, :].astype(np.float64)
              - corpus[None].astype(np.float64)) ** 2).sum(-1)
    assert near_ties(exact, 10).sum() == 0
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_allclose(d, want_d, rtol=1e-5, atol=1e-4)


def test_all_clusters_probed_is_the_exact_search(pair, corpus):
    _, got = pair
    q = blobs(32, seed=6)
    ids = got.ids
    d, i = got.search(q, k=10, nprobe=12)
    ed, ei = knn.KnnIndex(corpus, ids, device="cpu").search(q, k=10)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(d, ed, rtol=1e-5, atol=1e-3)


def test_underfilled_result_pads_like_the_reference():
    emb = blobs(40, d=4, centers=4, seed=1)
    kw = dict(n_clusters=20, nprobe=1, iters=3, seed=0)
    ref = jax_knn.IvfKnnIndex(emb, **kw)
    got = knn.IvfKnnIndex(emb, device="cpu", **kw)
    maxM = got._members.shape[1]
    assert maxM < 30
    want_d, want_i = ref.search(emb[:5], k=30)
    d, i = got.search(emb[:5], k=30)
    np.testing.assert_array_equal(i, want_i)
    assert (i[:, maxM:] == -1).all() and np.isinf(d[:, maxM:]).all()
    np.testing.assert_allclose(d[:, :maxM], want_d[:, :maxM], rtol=1e-5,
                               atol=1e-4)


def test_two_builds_give_one_index(corpus):
    a = knn.IvfKnnIndex(corpus, n_clusters=12, seed=4, device="cpu")
    b = knn.IvfKnnIndex(corpus, n_clusters=12, seed=4, device="cpu")
    assert np.array_equal(a._cent.numpy(), b._cent.numpy())
    assert np.array_equal(a._members.numpy(), b._members.numpy())


@pytest.mark.parametrize("index", ["flat", "ivfflat"])
def test_cli_matches_the_reference(tmp_path, corpus, index):
    np.save(tmp_path / "emb.npy", corpus)
    np.save(tmp_path / "ids.npy", np.arange(len(corpus)) + 100)
    np.savetxt(tmp_path / "q.csv", blobs(7, seed=9), delimiter=",")
    common = ["--embedding_file", str(tmp_path / "emb.npy"), "--id_file",
              str(tmp_path / "ids.npy"), "--k", "5", "--index", index,
              "--nlist", "12", "--nprobe", "4"]
    for extra in ([], ["--query_file", str(tmp_path / "q.csv")]):
        jax_knn.main(common + extra + ["--out", str(tmp_path / "r.npz")])
        knn.main(common + extra + ["--out", str(tmp_path / "t.npz"),
                                   "--device", "cpu"])
        want, got = np.load(tmp_path / "r.npz"), np.load(tmp_path / "t.npz")
        np.testing.assert_array_equal(got["idx"], want["idx"])
        np.testing.assert_allclose(got["distance"], want["distance"],
                                   rtol=1e-5, atol=1e-3)


# ------------------------------------------------- k past the corpus --

def test_k_past_the_corpus_raises_as_the_reference():
    emb = np.random.default_rng(0).random((5, 4)).astype(np.float32)
    q = emb[:2]
    with pytest.raises(ValueError) as want:
        jax_knn.KnnIndex(emb).search(q, k=8)
    for metric in ("l2", "ip", "cosine"):
        with pytest.raises(ValueError) as got:
            knn.KnnIndex(emb, metric=metric, device="cpu").search(q, k=8)
        assert str(got.value) == str(want.value)
    d, i = knn.KnnIndex(emb, device="cpu").search(q, k=5)
    assert d.shape == i.shape == (2, 5)


def _post(port, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/knn", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_knn_handler_answers_k_past_the_corpus_as_the_reference():
    emb = np.random.default_rng(1).random((5, 4)).astype(np.float32)
    ids = np.arange(5) + 10
    servers = [jax_serving.make_server(jax_serving.EmbeddingService(
                   emb, ids)),
               serving.make_server(serving.EmbeddingService(
                   emb, ids, device="cpu"))]
    try:
        for s in servers:
            threading.Thread(target=s.serve_forever, daemon=True).start()
        for req in ({"vector": emb[0].tolist(), "k": 8}, {"id": 11, "k": 6},
                    {"id": 12, "k": 3}):
            want, got = (_post(s.server_port, req) for s in servers)
            assert got[0] == want[0]
            if want[0] == 200:
                assert got[1]["ids"] == want[1]["ids"]
            else:
                assert got[1] == want[1]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def test_kmeans_steps_compose(corpus):
    emb = torch.from_numpy(corpus)
    cent0 = emb[:6].clone()
    cent = cent0
    for _ in range(3):
        cent, a = knn.lloyd_step(emb, cent)
    assert torch.equal(cent, knn.kmeans(emb, cent0, 3))
    assert a.shape == (len(corpus),) and int(a.max()) < 6
    # an empty cluster keeps its centroid
    far = torch.cat([cent0, torch.full((1, 16), 1e6)])
    new, a = knn.lloyd_step(emb, far)
    assert torch.equal(new[-1], far[-1]) and (a < 6).all()
