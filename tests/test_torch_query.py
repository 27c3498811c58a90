"""The PyTorch port's ``Query`` against euler_tpu's on the CPU: every
single-device case of tests/test_query.py (the toy graph's chains, the
conditional roots, edges by id, edge features, the layer draw, UDFs, the
utility ops), and chains on a random graph with the general packs and
with the fan pack only.

The reference's ``run(key)`` splits its key once per step and each
random verb splits its sub-key again; ``reference_uniforms`` rebuilds
that chain for the port's random steps (their structure read from a run
of the port's query with a generator) and the port's ``run(uniforms=)``
must then give ids, masks, weights, types and eids equal bit for bit,
and equal features. ``sampleLNB``'s Gumbel keys pass through ``log``,
which XLA and torch may round otherwise: its layer must equal the
reference's but where two of its best keys lie within 4 ulps. The
reference's quirks are pinned: ``order_by("id", desc=True)`` puts the
padded entries first (-INT32_MIN wraps), ``e()`` inverts ``adj_eid`` per
run without ``eid_slot``, repeated UDFs share one gather, trailing
predicates after ``v()`` filter.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.ops import util_ops as jax_util_ops
from euler_tpu.query import Query as JaxQuery
from euler_tpu.query import register_udf as jax_register_udf
from euler_tpu.query import udf as jax_udf
from euler_tpu.query import udf_max as jax_udf_max
from euler_tpu.query import udf_mean as jax_udf_mean
from euler_tpu_torch import Query, register_udf, udf, udf_max, udf_mean
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import GNNNet, ShallowEncoder
from euler_tpu_torch.ops import feature_ops, sampling, util_ops
from euler_tpu_torch.query import EdgeResult
from tests.fixtures import EDGES
from tests.test_torch_graph import native_off

#: every pack the reference's load_graph builds
ALL_PACKS = ("group", "adj", "sample", "fan", "ell")
GENERAL = ("group", "adj", "sample", "fan")


@pytest.fixture(scope="module")
def toy(toy_dir):
    return jax_load_graph(toy_dir), load_graph(toy_dir, packs=ALL_PACKS,
                                               device="cpu")


@pytest.fixture(scope="module", params=[GENERAL, ("fan",)],
                ids=["general", "fan"])
def rand(request):
    kw = dict(feat_dim=16, n_classes=4, num_edge_types=2, seed=3,
              packs=request.param)
    with native_off(("build_csr_native",)):
        return (jax_random_graph(2000, 8, **kw),
                random_graph(2000, 8, device="cpu", **kw))


def U(key, shape, **kw):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape, **kw)))


def neighbor_uniforms(key, shape):
    """sample_neighbor's ``kt, kd = split(key); k1, k2 = split(kd)``."""
    kt, kd = jax.random.split(key)
    k1, k2 = jax.random.split(kd)
    return U(kt, shape), U(k1, shape), U(k2, shape)


def reference_uniforms(q: Query, key, typed=()):
    """The uniforms the reference's ``run(key)`` draws for each random
    step of ``q`` (run once with a generator, so that its steps and the
    structure of each step's uniforms are known): the key split once per
    step, then each verb's own split. ``typed``: positions of random
    steps whose node or edge draw names a type (no type pick)."""
    subs, k = [], key
    for _ in q._steps:
        k, sub = jax.random.split(k)
        subs.append(sub)
    out, j = [], 0
    for (name, _, draw), sub in zip(q._steps, subs):
        if draw is None:
            continue
        like = q.last_uniforms[j]
        if name == "sampleLNB":
            (ut, _, _), gum = like
            k1, k2 = jax.random.split(sub)
            out.append((neighbor_uniforms(k1, tuple(ut.shape)),
                        U(k2, tuple(gum.shape), minval=1e-20, maxval=1.0)))
        elif isinstance(like, torch.Tensor):             # masked draw
            out.append(U(sub, tuple(like.shape)))
        elif len(like) == 2:                             # indexed draw
            kr, kd = jax.random.split(sub)
            out.append((U(kr, tuple(like[0].shape)),
                        U(kd, tuple(like[1].shape))))
        elif name == "sampleNB":
            out.append(neighbor_uniforms(sub, tuple(like[0].shape)))
        else:                                  # node or edge alias draw
            shape = tuple(like[0].shape)
            if j in typed:
                u_type, kd = torch.zeros(shape), sub
            else:
                kt, kd = jax.random.split(sub)
                u_type = U(kt, shape)
            k1, k2 = jax.random.split(kd)
            out.append((u_type, U(k1, shape), U(k2, shape)))
        j += 1
    return out


def run_both(build, gj, gt, key, typed=()):
    """(reference result, port result) of the query ``build(Query, g, udf
    helpers)`` on the two graphs, the port fed the reference's draws."""
    want = build(JaxQuery(gj), JAX).run(key)
    u = reference_uniforms(_probe(build, gt), key, typed)
    return want, build(Query(gt), TORCH).run(uniforms=u)


def _probe(build, gt):
    """The port's query, run once from a generator."""
    q = build(Query(gt), TORCH)
    q.run(generator=torch.Generator().manual_seed(0))
    return q


JAX = dict(mean=jax_udf_mean, max=jax_udf_max, udf=jax_udf)
TORCH = dict(mean=udf_mean, max=udf_max, udf=udf)


def assert_same(got, want, path="out"):
    """Results equal: ids, masks, types and eids bit for bit, floats
    equal (NaN where NaN)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k}]")
    elif isinstance(want, tuple):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    elif hasattr(want, "src") or hasattr(want, "ids"):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(got):
            assert_same(getattr(got, f.name), getattr(want, f.name),
                        f"{path}.{f.name}")
    else:
        b = np.asarray(want)
        a = got.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def lid(g, ext):
    return g.local_id(ext)


# ----------------------------------------------- tests/test_query.py cases --

def test_v_samplenb_values(toy):
    gj, gt = toy
    click = gt.meta.edge_type_id("click")
    ids = [lid(gt, 100), lid(gt, 102)]

    def build(q, u):
        return (q.v(ids).sampleNB((click,), 8).alias("nb")
                .values("dense2").alias("f"))
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(0))
    assert_same(got, want)
    assert got["nb"].ids.shape == (2, 8) and got["f"].shape == (16, 2)
    assert set(got["nb"].ids[1].tolist()) == {lid(gt, 101)}


def test_sampleN_conditional(toy):
    gj, gt = toy

    def build(q, u):
        return q.sampleN(-1, 64).ge("price", 10.0).alias("n")
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(1))
    assert_same(got, want)
    ids = got["n"].ids
    assert (ids >= 0).all()
    assert (gt.tensors.dense_nf["price"][ids.long(), 0] >= 10.0).all()


def test_hasLabel_filters_type(toy):
    gj, gt = toy

    def build(q, u):
        return q.sampleN(-1, 32).hasLabel("user")
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(2))
    assert_same(got, want)
    ut = gt.meta.node_type_id("user")
    assert (gt.tensors.node_type[got["_frontier"].ids.long()] == ut).all()


def test_sampleE_outV_inV(toy):
    gj, gt = toy
    buy = gt.meta.edge_type_id("buy")

    def build(q, u):
        return q.sampleE(buy, 32).alias("e").inV().alias("dst")
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(3), typed=(0,))
    assert_same(got, want)
    e = got["e"]
    assert isinstance(e, EdgeResult)
    buys = {(s, d) for s, d, t, w in EDGES if t == "buy"}
    ext = gt.ext_ids
    assert {(int(ext[s]), int(ext[d]))
            for s, d in zip(e.src.tolist(), e.dst.tolist())} <= buys
    assert torch.equal(got["dst"].ids, e.dst)


def test_order_by_limit(toy):
    gj, gt = toy
    click = gt.meta.edge_type_id("click")

    def build(q, u):
        return (q.v([lid(gt, 100)]).sampleNB((click,), 8)
                .order_by("weight", desc=True).limit(3))
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(4))
    assert_same(got, want)
    f = got["_frontier"]
    assert f.ids.shape == (1, 3) and (f.weights[0].diff() <= 0).all()


def test_values_udf_and_label(toy):
    gj, gt = toy
    ids = [lid(gt, 100), lid(gt, 101)]

    def build(q, u):
        return (q.v(ids).values(u["mean"]("dense2")).alias("m")
                .label().alias("t"))
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(5))
    assert_same(got, want)
    np.testing.assert_array_equal(
        got["t"].numpy(), gt.tensors.node_type[torch.tensor(ids)].numpy())


@pytest.mark.parametrize("eid_slot", [True, False], ids=["slot", "argsort"])
def test_e_lookup(toy, eid_slot):
    # without eid_slot, e() inverts adj_eid per run (query.py:164-170)
    gj, gt = toy
    tj, tt = gj.tensors, gt.tensors
    if not eid_slot:
        tj, tt = tj.replace(eid_slot=None), dataclasses.replace(
            tt, eid_slot=None)
    want = JaxQuery(tj).e(jnp.asarray([0, 3, -1], jnp.int32)).run(
        jax.random.PRNGKey(6))
    got = Query(tt).e([0, 3, -1]).run()
    assert_same(got, want)
    f = got["_frontier"]
    ext = gt.ext_ids
    for k, eid in enumerate([0, 3]):
        s, d, t, w = EDGES[eid]
        assert int(ext[int(f.src[k])]) == s and int(ext[int(f.dst[k])]) == d
    assert int(f.src[2]) == int(f.dst[2]) == int(f.types[2]) == -1


def test_e_values_edge_features(toy):
    gj, gt = toy
    eids = [1, 8, 10]
    want = JaxQuery(gj).e(jnp.asarray(eids, jnp.int32)).values(
        "edense", "esparse").run(jax.random.PRNGKey(6))
    got = Query(gt).e(eids).values("edense", "esparse").run()
    assert_same(got, want)
    np.testing.assert_allclose(got["_value"][0].numpy().ravel(),
                               [EDGES[e][3] * 10.0 for e in eids])


def ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


def assert_layer(got, want, gt, frontier, ets, count, m, u):
    """The layer equals the reference's but where two of its m + 1 best
    Gumbel keys lie within 4 ulps; there only two draws may swap."""
    keyed = sampling.layer_keys(gt.tensors, frontier, ets, count, u)[2]
    top = torch.sort(keyed[torch.isfinite(keyed)], descending=True)[0]
    top = top[:m + 1].numpy()
    near = (top[:-1] - top[1:] <= 4 * ulp(top[:-1])).any()
    ids, want_ids = got.ids.numpy(), np.asarray(want.ids)
    if near:
        assert len(set(ids) ^ set(want_ids)) <= 2
    else:
        assert_same(got, want)


def test_sampleLNB_layer(toy):
    gj, gt = toy
    click = gt.meta.edge_type_id("click")
    ids = [lid(gt, 100), lid(gt, 102)]

    def build(q, u):
        return q.v(ids).sampleLNB((click,), 4, 3)
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(7))
    layer = got["_frontier"].ids
    assert layer.shape == (3,)
    assert set(layer[layer >= 0].tolist()) <= {lid(gt, 101), lid(gt, 103)}
    u = reference_uniforms(_probe(build, gt), jax.random.PRNGKey(7))[0]
    assert_layer(got["_frontier"], want["_frontier"], gt,
                 torch.tensor(ids, dtype=torch.int32), (click,), 4, 3, u)


def test_sparse_get_adj(toy):
    _, gt = toy
    click = gt.meta.edge_type_id("click")
    nodes = torch.tensor([lid(gt, 100), lid(gt, 104)], dtype=torch.int32)
    nb = torch.tensor([lid(gt, 101), lid(gt, 103), lid(gt, 105)],
                      dtype=torch.int32)
    conn, w = sampling.sparse_get_adj(gt.tensors, nodes, nb, (click,))
    np.testing.assert_array_equal(conn.numpy(),
                                  [[1, 1, 0], [0, 0, 1]])
    np.testing.assert_allclose(w.numpy()[0, :2], [1.0, 3.0])


def test_inflate_idx():
    idx = [0, 1, 0, 2, 1, 0]
    want = np.asarray(jax_util_ops.inflate_idx(jnp.asarray(idx)))
    got = util_ops.inflate_idx(torch.tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == [0, 1, 2, 3, 4, 5]


def test_unique_gather_matches_direct():
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))

    def fetch(x):
        return torch.where((x >= 0)[:, None], tab[x.clamp_min(0).long()],
                           0.0)
    ids = np.where(rng.random(64) < 0.15, -1,
                   rng.integers(0, 16, 64)).astype(np.int32)
    for arr in (ids, [3] * 8, [-1] * 8, [7]):
        a = torch.tensor(np.asarray(arr, np.int32))
        assert torch.equal(util_ops.unique_gather(fetch, a), fetch(a))


def test_gnn_dedup_features_parity(toy):
    _, gt = toy
    g = gt.tensors
    roots = torch.tensor([0, 3, 5, -1], dtype=torch.int32)
    outs = []
    for dedup in (False, True):
        net = GNNNet("sage", SageDataFlow([3, 2], [(0, 1)] * 2), (8, 8),
                     ShallowEncoder(dense_names=("dense2",)), 2,
                     device="cpu", generator=torch.Generator().manual_seed(0),
                     dedup_features=dedup)
        outs.append(net(g, roots, generator=torch.Generator().manual_seed(1)))
    assert torch.equal(outs[0], outs[1])


def test_sparse_gather():
    ids = [[1, 2, -1], [3, -1, -1], [4, 5, 6]]
    want = jax_util_ops.sparse_gather(jnp.asarray([2, 0, -1]),
                                      jnp.asarray(ids),
                                      jnp.asarray(ids) >= 0)
    t = torch.tensor(ids, dtype=torch.int32)
    got = util_ops.sparse_gather(torch.tensor([2, 0, -1]), t, t >= 0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_registered_and_parameterized_udfs(toy):
    gj, gt = toy
    ids = [0, 3, 5]
    jax_register_udf("test_pnorm", lambda x, p: jnp.sum(
        jnp.abs(x) ** p, axis=-1, keepdims=True) ** (1.0 / p))
    register_udf("test_pnorm", lambda x, p: (x.abs() ** p).sum(
        -1, keepdim=True) ** (1.0 / p))

    def build(q, u):
        return (q.v(ids).values(u["udf"]("test_pnorm", "dense2", 2.0))
                .alias("norm2")
                .values(u["udf"](lambda x: x * 10.0, "dense2")).alias("x10"))
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(0))
    np.testing.assert_allclose(got["norm2"].numpy(),
                               np.asarray(want["norm2"]), rtol=1e-6)
    assert_same(got["x10"], want["x10"])
    base = feature_ops.get_dense_feature(gt.tensors, torch.tensor(ids),
                                         ["dense2"])[0]
    np.testing.assert_allclose(got["norm2"].numpy().ravel(),
                               base.norm(dim=-1).numpy(), rtol=1e-5)
    with pytest.raises(KeyError):
        udf("never_registered", "dense2")
    with pytest.raises(TypeError):
        register_udf("not_callable", 3)


# ------------------------------------------------- the reference's quirks --

def test_order_by_id_desc_puts_the_padding_first(toy):
    # -INT32_MIN wraps to INT32_MIN, so padded ids sort before the rest
    gj, gt = toy
    ids = [5, -1, 3, 7, -1]
    want = JaxQuery(gj).v(jnp.asarray(ids, jnp.int32)).order_by(
        "id", desc=True).run(jax.random.PRNGKey(0))
    got = Query(gt).v(ids).order_by("id", desc=True).run()
    assert_same(got, want)
    assert got["_frontier"].ids.tolist() == [-1, -1, 7, 5, 3]
    up = Query(gt).v(ids).order_by("id").run()["_frontier"]
    assert up.ids.tolist() == [3, 5, 7, -1, -1]


def test_repeated_udfs_share_one_gather(toy, monkeypatch):
    _, gt = toy
    calls = []
    real = feature_ops.get_dense_feature
    monkeypatch.setattr(feature_ops, "get_dense_feature",
                        lambda g, ids, names: calls.append(names) or
                        real(g, ids, names))
    out = Query(gt).v([0, 1, 2]).values(
        udf_mean("dense2"), udf_max("dense2"), "dense2").run()
    assert calls == [("dense2",), ("dense2",)]   # the UDFs' one, dense2's
    m, mx, x = out["_value"]
    assert torch.equal(m, x.mean(-1, keepdim=True))
    assert torch.equal(mx, x.amax(-1, keepdim=True))


@pytest.mark.parametrize("frontier", ["v", "e"])
def test_trailing_predicates_filter_the_frontier(toy, frontier):
    gj, gt = toy
    if frontier == "v":
        want = JaxQuery(gj).v(jnp.arange(8, dtype=jnp.int32)).gt(
            "price", 5.0).or_().has("tag", "n100").run(jax.random.PRNGKey(0))
        q = Query(gt).v(list(range(8))).gt("price", 5.0).or_().has(
            "tag", "n100")
    else:
        want = JaxQuery(gj).e(jnp.arange(len(EDGES), dtype=jnp.int32)).ge(
            "edense", 20.0).run(jax.random.PRNGKey(0))
        q = Query(gt).e(list(range(len(EDGES)))).ge("edense", 20.0)
    got = q.run()
    assert [s[0] for s in q._steps][-1] == "filter"
    assert_same(got, want)


def test_uniforms_replay_the_generator_run(toy):
    _, gt = toy
    click = gt.meta.edge_type_id("click")
    q = (Query(gt).v([0, 2]).sampleNB((click,), 6).alias("nb")
         .sampleN(-1, 20).gt("price", 5.0).alias("n")
         .sampleE(-1, 12).alias("e"))
    first = q.run(generator=torch.Generator().manual_seed(4))
    assert len(q.last_uniforms) == 3
    again = q.run(uniforms=q.last_uniforms)
    for k in ("nb", "n", "e"):
        for f in dataclasses.fields(first[k]):
            a, b = getattr(first[k], f.name), getattr(again[k], f.name)
            assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="uniforms"):
        q.run(uniforms=q.last_uniforms[:2])


def test_conditional_root_distribution_from_a_generator(toy):
    _, gt = toy
    ids = Query(gt).sampleN(-1, 40_000).gt("price", 5.0).run(
        generator=torch.Generator().manual_seed(0))["_frontier"].ids.numpy()
    assert set(ids.tolist()) <= {3, 4, 5, 6, 7}
    freq = np.bincount(ids, minlength=8)[3:] / len(ids)
    np.testing.assert_allclose(freq, np.arange(4, 9) / 30, atol=0.01)


# --------------------------------------------- chains on a random graph --

def test_random_graph_chains(rand):
    gj, gt = rand
    ids = np.concatenate([np.arange(0, 60, 3), [-1, 1999]]).astype(np.int32)

    def build(q, u):
        return (q.v(ids).sampleNB((0, 1), 7).alias("nb")
                .values("feature", u["mean"]("label")).alias("f")
                .order_by("weight", desc=True).limit(4).alias("top")
                .outE((1,), 12).alias("out").inV()
                .values(u["mean"]("feature"), u["max"]("feature")).alias("m")
                .label().alias("t"))
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(11))
    # a row's mean and max are reductions: XLA and torch may add a row's
    # 16 values in other orders
    for a, b in zip(got.pop("m"), want.pop("m")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert_same(got, want)
    assert got["nb"].ids.shape == (len(ids), 7)


@pytest.mark.parametrize("pred", [("gt", 0.5), ("le", -0.25)])
def test_random_graph_conditional_roots(rand, pred):
    gj, gt = rand
    op, t = pred

    def build(q, u):
        return getattr(q.sampleN(-1, 300), op)("feature", t).alias("n")
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(12))
    assert_same(got, want)


def test_random_graph_conditional_edges(rand):
    gj, gt = rand

    def build(q, u):
        return (q.sampleE(-1, 500).gt("weight", 0.9).alias("e")
                .outV().values("label").alias("l"))
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(13))
    assert_same(got, want)
    e = got["e"]
    assert (gt.tensors.adj_w[gt.tensors.eid_slot[e.eids.long()].long()]
            > 0.9).all()


def test_random_graph_layer(rand):
    gj, gt = rand
    ids = np.arange(40, dtype=np.int32)

    def build(q, u):
        return q.v(ids).sampleLNB((0, 1), 5, 60)
    want, got = run_both(build, gj, gt, jax.random.PRNGKey(14))
    u = reference_uniforms(_probe(build, gt), jax.random.PRNGKey(14))[0]
    assert_layer(got["_frontier"], want["_frontier"], gt,
                 torch.from_numpy(ids), (0, 1), 5, 60, u)
