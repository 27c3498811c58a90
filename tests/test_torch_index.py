"""ops/index.py of the PyTorch port against euler_tpu's on the CPU: every
single-device case of tests/test_index.py, and the store's query columns.

Masks of every op, the binary hash and the DNF are equal; the prebuilt
node and edge indexes are equal array for array; the indexed draw and the
masked draws are equal bit for bit on the reference's uniforms (its
``kr, kd = split(key)`` for the index, the key itself for the masked
draw); the running sum of the masked draw equals ``jnp.cumsum`` bit for
bit up to 5,000,000 weights; draws from a generator follow the
conditional distribution.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.graph.store import string_hash32 as jax_string_hash32
from euler_tpu.ops import index as jax_index
from euler_tpu_torch.graph import load_graph, store
from euler_tpu_torch.ops import index, sampling
from tests.fixtures import EDGES

OPS = [("gt", 5.0), ("ge", 10.0), ("lt", 7.5), ("le", 7.5), ("eq", 7.5),
       ("ne", 7.5), ("in", (2.5, 12.5)), ("not_in", (2.5, 12.5, 99.0))]


@pytest.fixture(scope="module")
def toy(toy_dir):
    return jax_load_graph(toy_dir), load_graph(
        toy_dir, packs=("group", "adj", "sample", "fan", "ell"),
        device="cpu")


@pytest.fixture(scope="module")
def indexed(toy):
    """Both toy graphs with node indexes over price, node_type, weight and
    tag, and edge indexes over edense, weight and edge_type."""
    gj, gt = toy
    nodes, edges = ["price", "node_type", "weight", "tag"], [
        "edense", "weight", "edge_type"]
    tj = jax_index.build_attr_index(gj.tensors, nodes)
    tj = jax_index.build_attr_index(tj, edges, target="edge")
    tt = index.build_attr_index(gt.tensors, nodes)
    tt = index.build_attr_index(tt, edges, target="edge")
    return tj, tt


def U(key, count):
    return torch.from_numpy(np.array(jax.random.uniform(key, (count,))))


def indexed_uniforms(key, count):
    kr, kd = jax.random.split(key)
    return U(kr, count), U(kd, count)


def jp(*a):
    return jax_index.Pred(*a)


def tp(*a):
    return index.Pred(*a)


def eq(a: torch.Tensor, b) -> None:
    b = np.asarray(b)
    assert a.numpy().dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.numpy(), b)


# ------------------------------------------------------------ the store --

def test_store_query_columns_equal_the_reference(toy):
    gj, gt = toy
    for f in ("node_w", "eid_slot"):
        eq(getattr(gt.tensors, f), getattr(gj.tensors, f))
    assert set(gt.tensors.binary_hash_nf) == set(gj.tensors.binary_hash_nf)
    for k, v in gj.tensors.binary_hash_nf.items():
        eq(gt.tensors.binary_hash_nf[k], v)
    assert gt.tensors.node_index == {} and gt.tensors.edge_index_ == {}
    for s in ("", "n103", "graph-7", "ünïcode", "x" * 300):
        assert store.string_hash32(s) == jax_string_hash32(s)


def test_attr_indexes_equal_the_reference_and_move(indexed):
    tj, tt = indexed
    for field in ("node_index", "edge_index_"):
        got, want = getattr(tt, field), getattr(tj, field)
        assert set(got) == set(want)
        for k in want:
            for f in ("order", "vals", "wcum"):
                eq(getattr(got[k], f), getattr(want[k], f))
    moved = tt.to("meta")
    assert moved.node_index["price:0"].wcum.device.type == "meta"
    assert moved.edge_index_["edense:0"].order.device.type == "meta"


# ---------------------------------------------------------------- masks --

@pytest.mark.parametrize("op,value", OPS, ids=[o for o, _ in OPS])
def test_masks_of_every_op(toy, op, value):
    gj, gt = toy
    eq(index.dnf_mask(gt.tensors, [[tp("price", op, value)]]),
       jax_index.dnf_mask(gj.tensors, [[jp("price", op, value)]]))
    ids = np.array([-1, 0, 3, 5, 7, 7], np.int32)
    eq(index.dnf_mask_at(gt.tensors, [[tp("price", op, value)]],
                         torch.from_numpy(ids)),
       jax_index.dnf_mask_at(gj.tensors, [[jp("price", op, value)]],
                             jnp.asarray(ids)))
    ev = value if isinstance(value, tuple) else value * 2
    eids = np.array([-1, 0, 1, 4, 10], np.int32)
    eq(index.edge_dnf_mask(gt.tensors, [[tp("edense", op, ev)]],
                           torch.from_numpy(eids)),
       jax_index.edge_dnf_mask(gj.tensors, [[jp("edense", op, ev)]],
                               jnp.asarray(eids)))


def test_range_predicates(toy):
    _, gt = toy
    m = index.dnf_mask(gt.tensors, [[tp("price", "gt", 10.0)]])
    assert torch.nonzero(m).ravel().tolist() == [5, 6, 7]
    m = index.dnf_mask(gt.tensors, [[tp("price", "ge", 10.0),
                                     tp("price", "lt", 16.0)]])
    assert torch.nonzero(m).ravel().tolist() == [4, 5, 6]


def test_hash_eq_on_binary(toy):
    gj, gt = toy
    for op, v in (("eq", "n103"), ("ne", "n103"), ("in", ("n101", "x")),
                  ("not_in", ("n101", "n102"))):
        got = index.dnf_mask(gt.tensors, [[tp("tag", op, v)]])
        eq(got, jax_index.dnf_mask(gj.tensors, [[jp("tag", op, v)]]))
    m = index.dnf_mask(gt.tensors, [[tp("tag", "eq", "n103")]])
    assert torch.nonzero(m).ravel().tolist() == [gt.local_id(103)]


def test_in_and_dnf_or(toy):
    gj, gt = toy
    dnf = [[("node_type", "eq", "item"), ("price", "lt", 5.0)],
           [("tag", "in", ("n105", "n107"))]]
    got = index.dnf_mask(gt.tensors, [[tp(*p) for p in c] for c in dnf])
    eq(got, jax_index.dnf_mask(gj.tensors, [[jp(*p) for p in c]
                                            for c in dnf]))
    assert set(torch.nonzero(got).ravel().tolist()) == {0, 5, 7}


def test_edge_type_and_weight_predicates(toy):
    gj, gt = toy
    eids = np.arange(-1, len(EDGES) + 1, dtype=np.int32)
    for p in (("edge_type", "eq", "buy"), ("edge_type", "in", (0, 1)),
              ("weight", "ge", 2.0), ("weight", "not_in", (1.0, 4.0))):
        eq(index.edge_pred_mask(gt.tensors, tp(*p), torch.from_numpy(eids)),
           jax_index.edge_pred_mask(gj.tensors, jp(*p), jnp.asarray(eids)))


# ----------------------------------------------------------- the draws --

@pytest.mark.parametrize("p", [("price", "gt", 5.0), ("price", "le", 10.0),
                               ("price", "eq", 7.5), ("price", "ne", 7.5),
                               ("price", "in", (2.5, 12.5)),
                               ("price", "not_in", (2.5, 12.5)),
                               ("price", "gt", 1e9), ("weight", "lt", 4.0),
                               ("node_type", "eq", "item"),
                               ("tag", "in", ("n100", "n106"))],
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_indexed_sample_bit_exact(indexed, p):
    tj, tt = indexed
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda g: jax_index.indexed_sample(g, key, 3000,
                                                      jp(*p)))(tj)
    got = index.select_indexed(tt, tp(*p), indexed_uniforms(key, 3000))
    eq(got, want)
    mask = index.dnf_mask(tt, [[tp(*p)]])
    assert set(got[got >= 0].tolist()) <= set(
        torch.nonzero(mask).ravel().tolist())


@pytest.mark.parametrize("p", [("edense", "ge", 20.0), ("weight", "lt", 2.0),
                               ("edge_type", "eq", "click")],
                         ids=["edense", "weight", "edge_type"])
def test_indexed_edge_sample_bit_exact(indexed, p):
    tj, tt = indexed
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda g: jax_index.sample_edge_with_condition(
        g, key, 2000, [[jp(*p)]]))(tj)
    got = index.select_edge_with_condition(tt, [[tp(*p)]], -1,
                                           indexed_uniforms(key, 2000))
    for a, b in zip(got, want):
        eq(a, b)


@pytest.mark.parametrize("node_type", [-1, "user"])
def test_masked_node_draw_bit_exact(toy, node_type):
    gj, gt = toy
    dnf = [[("price", "gt", 2.0)], [("tag", "eq", "n100")]]
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda g: jax_index.sample_node_with_condition(
        g, key, 3000, [[jp(*q) for q in c] for c in dnf], node_type))(
        gj.tensors)
    got = index.select_node_with_condition(
        gt.tensors, [[tp(*q) for q in c] for c in dnf], node_type,
        U(key, 3000))
    eq(got, want)


@pytest.mark.parametrize("edge_type", [-1, "buy"])
def test_masked_edge_draw_bit_exact(toy, edge_type):
    gj, gt = toy
    dnf = [[("edense", "ge", 15.0)], [("weight", "eq", 1.0)]]
    key = jax.random.PRNGKey(6)
    want = jax.jit(lambda g: jax_index.sample_edge_with_condition(
        g, key, 3000, [[jp(*q) for q in c] for c in dnf], edge_type))(
        gj.tensors)
    got = index.select_edge_with_condition(
        gt.tensors, [[tp(*q) for q in c] for c in dnf], edge_type,
        U(key, 3000))
    for a, b in zip(got, want):
        eq(a, b)


def test_masked_weighted_sample_on_long_weights():
    rng = np.random.default_rng(7)
    w = rng.random(200_000).astype(np.float32)
    w[rng.random(200_000) < 0.5] = 0
    key = jax.random.PRNGKey(8)
    want = jax.jit(lambda w: jax_index.masked_weighted_sample(
        key, w, 5000))(jnp.asarray(w))
    eq(index.select_masked(torch.from_numpy(w), U(key, 5000)), want)
    zero = torch.zeros(10)
    assert (index.masked_weighted_sample(zero, 7) == -1).all()


@pytest.mark.parametrize("n", [17, 200_000, 5_000_000])
def test_blocked_cdf_equals_jnp_cumsum(n):
    w = np.random.default_rng(n).random(n).astype(np.float32)
    want = np.asarray(jax.jit(jnp.cumsum)(jnp.asarray(w)))
    got = sampling.row_cdf(torch.from_numpy(w)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_conditional_sampling_distribution(toy):
    _, gt = toy
    # nodes with price > 5: idx 3..7, weights 4..8
    ids = index.sample_node_with_condition(
        gt.tensors, 40_000, [[tp("price", "gt", 5.0)]],
        generator=torch.Generator().manual_seed(0)).numpy()
    assert set(ids.tolist()) <= {3, 4, 5, 6, 7}
    freq = np.bincount(ids, minlength=8)[3:] / len(ids)
    np.testing.assert_allclose(freq, np.arange(4, 9) / 30, atol=0.01)


@pytest.mark.parametrize("via", ["mask", "index"])
def test_conditional_sampling_empty(toy, indexed, via):
    g = toy[1].tensors if via == "mask" else indexed[1]
    ids = index.sample_node_with_condition(
        g, 16, [[tp("price", "gt", 1e9)]],
        generator=torch.Generator().manual_seed(1))
    assert (ids == -1).all() and ids.dtype == torch.int32


def test_query_index_ids(toy):
    gj, gt = toy
    for dnf, cap in (([[("node_type", "eq", "user")]], 8),
                     ([[("price", "gt", 3.0)]], 3),
                     ([[("price", "gt", 3.0)]], 20)):
        got = index.query_index_ids(gt.tensors, [[tp(*p) for p in c]
                                                 for c in dnf], cap)
        want = jax_index.query_index_ids(gj.tensors, [[jp(*p) for p in c]
                                                      for c in dnf], cap)
        for a, b in zip(got, want):
            eq(a, b)
    ids, mask = index.query_index_ids(
        gt.tensors, [[tp("node_type", "eq", "user")]], cap=8)
    assert sorted(ids[mask].tolist()) == [1, 3, 5, 7]


def test_attr_index_sampling_matches_mask_path(indexed):
    _, tt = indexed
    gen = torch.Generator().manual_seed(3)
    for p in [tp("price", "gt", 5.0), tp("price", "le", 10.0),
              tp("price", "eq", 7.5), tp("price", "ne", 7.5),
              tp("price", "in", (2.5, 12.5)),
              tp("price", "not_in", (2.5, 12.5)),
              tp("node_type", "eq", "item")]:
        want_mask = index.dnf_mask(tt, [[p]]).numpy()
        ids = index.indexed_sample(tt, 30_000, p, generator=gen).numpy()
        assert set(ids[ids >= 0].tolist()) == set(np.nonzero(want_mask)[0])
        w = tt.node_w.numpy() * want_mask
        freq = np.bincount(ids[ids >= 0], minlength=8) / max(
            1, (ids >= 0).sum())
        np.testing.assert_allclose(freq, w / w.sum(), atol=0.015,
                                   err_msg=str(p))
    # a single predicate on an indexed attribute draws through the index
    u = index.draw_condition_uniforms(tt, 20_000, [[tp("price", "gt", 5.0)]])
    assert isinstance(u, tuple) and len(u) == 2
    ids = index.select_node_with_condition(
        tt, [[tp("price", "gt", 5.0)]], -1, u)
    assert set(ids.tolist()) == {3, 4, 5, 6, 7}


def test_edge_predicates_and_conditional_edge_sampling(toy, indexed):
    _, gt = toy
    dnf = [[tp("edense", "ge", 20.0)]]
    legal = {i for i, (s, d, t, w) in enumerate(EDGES) if w * 10 >= 20.0}
    w = np.asarray([EDGES[i][3] for i in sorted(legal)])
    for g in (gt.tensors, indexed[1]):
        *_, eid = index.sample_edge_with_condition(
            g, 20_000, dnf, generator=torch.Generator().manual_seed(0))
        eid = eid.numpy()
        assert set(eid.tolist()) == legal
        freq = np.bincount(eid, minlength=len(EDGES))[sorted(legal)] \
            / len(eid)
        np.testing.assert_allclose(freq, w / w.sum(), atol=0.01)


def test_unknown_attributes_and_ops_raise(toy):
    _, gt = toy
    with pytest.raises(ValueError, match="unknown op"):
        tp("price", "between", 1.0)
    with pytest.raises(KeyError, match="no indexable attribute"):
        index.dnf_mask(gt.tensors, [[tp("nope", "eq", 1.0)]])
    with pytest.raises(KeyError, match="no indexable edge attribute"):
        index.edge_dnf_mask(gt.tensors, [[tp("nope", "eq", 1.0)]],
                            torch.zeros(2, dtype=torch.int32))


def test_build_attr_index_sets_the_graph(toy_dir):
    g = load_graph(toy_dir, device="cpu")
    t = index.build_attr_index(g, [("price", 0)])
    assert g.tensors is t and "price:0" in t.node_index
    t2 = index.build_attr_index(t, ["weight"], target="edge")
    assert dataclasses.is_dataclass(t2) and "weight:0" in t2.edge_index_
    assert "price:0" in t2.node_index and g.tensors is t
