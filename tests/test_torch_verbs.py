"""The sampling verbs of the PyTorch port against euler_tpu on the CPU:
the ``group``, ``adj`` and ``sample`` packs, the in-CSR and the
graph-label table; ``sample_neighbor`` on both of its branches;
``sample_node_with_src``; top-k, in-neighbor, fanout and layer draws;
``sparse_get_adj``; the graph-label verbs; ``get_node_type``; the
utility ops; and ``GNNNet(dedup_features=True)``.

Ids, types, eids and weights must be equal bit for bit. The reference
derives its uniforms from its key inside each verb; the tests derive the
same numbers from the key (``kt, kd = split(key); k1, k2 = split(kd)``
for ``sample_neighbor``) and hand them to the port's deterministic
selects. The layer draw's Gumbel keys pass through ``log``, which XLA and
torch may round differently: its ids must be equal except where the
reference's keys of two candidates lie within 4 ulps. Draws from a
torch.Generator are tested by their distribution.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.ops import sampling as jax_sampling
from euler_tpu.ops import util_ops as jax_util_ops
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import GNNNet, ShallowEncoder
from euler_tpu_torch.ops import gather_rows as gr
from euler_tpu_torch.ops import sampling, util_ops
from tests.test_torch_graph import native_off

PACKS = ("group", "adj", "sample", "fan")
PACK_FIELDS = ("group_pack", "adj_pack", "sample_pack")
IN_FIELDS = ("in_group_ptr", "in_adj_src", "in_adj_w", "in_adj_eid",
             "in_group_w_sum", "in_adj_prob", "in_adj_alias")
N = 300


def graph_pair(n, avg_degree, num_edge_types, seed, packs=PACKS,
               in_edges=True):
    """(euler_tpu Graph, port Graph on the CPU) of one random graph with
    the numpy CSR sort on both sides (ROADMAP Queue C)."""
    kw = dict(num_edge_types=num_edge_types, seed=seed, packs=packs,
              build_in_edges=in_edges)
    with native_off(("build_csr_native",)):
        return (jax_random_graph(n, avg_degree, **kw),
                random_graph(n, avg_degree, device="cpu", **kw))


@pytest.fixture(scope="module")
def pair():
    return graph_pair(N, 12, 4, seed=1)


def bare(gj, gt):
    """Both graphs without the group, adj and sample packs."""
    none = {f: None for f in PACK_FIELDS}
    return gj.tensors.replace(**none), dataclasses.replace(gt.tensors, **none)


def uniforms(key, shape, typed=True):
    """The uniforms ``sample_neighbor`` draws from ``key``: (u_type, u1,
    u2); with ``typed=False`` the alias draw's (u1, u2)."""
    keys = []
    if typed:
        kt, key = jax.random.split(key)
        keys.append(kt)
    keys += list(jax.random.split(key))
    return tuple(torch.from_numpy(np.array(jax.random.uniform(k, shape)))
                 for k in keys)


def assert_equal(got, want, names=("nbr", "w", "type", "eid", "ok")):
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


NODES = np.concatenate([np.arange(-2, 40), [N - 1, N, N + 7]]).astype(
    np.int32)


# ------------------------------------------------------------- the store --

def test_packs_in_csr_and_node_types_equal_the_reference(pair):
    gj, gt = pair
    for name in PACK_FIELDS + IN_FIELDS + ("node_type",):
        np.testing.assert_array_equal(getattr(gt.tensors, name).numpy(),
                                      np.asarray(getattr(gj.tensors, name)),
                                      err_msg=name)
    moved = gt.tensors.to("meta")
    assert all(getattr(moved, n).device.type == "meta"
               for n in PACK_FIELDS + IN_FIELDS)


def test_packs_are_built_only_on_request():
    g = random_graph(50, 4, num_edge_types=2, device="cpu").tensors
    assert all(getattr(g, n) is None for n in PACK_FIELDS + IN_FIELDS)
    assert g.graph_members is None and g.fan_pack is not None
    g = random_graph(50, 4, packs=("adj",), device="cpu").tensors
    assert g.adj_pack is not None and g.sample_pack is None
    with pytest.raises(NotImplementedError, match="not ported"):
        random_graph(50, 4, packs=("fan", "bogus"), device="cpu")


def test_pack_reads_equal_the_plain_fields(pair):
    # _group_bounds reads group_pack and _fetch_slots adj_pack where the
    # graph has them: the same values as group_ptr and the slot columns
    _, gt = pair
    packed = dataclasses.replace(gt.tensors, sample_pack=None)
    plain = dataclasses.replace(packed, group_pack=None, adj_pack=None)
    nodes = torch.from_numpy(NODES[(NODES >= 0) & (NODES < N)])
    for ets in ((0,), (3, 1)):
        assert_equal(sampling.get_full_neighbor(packed, nodes, ets, 9),
                     sampling.get_full_neighbor(plain, nodes, ets, 9))
        u = uniforms(jax.random.PRNGKey(len(ets)), (len(nodes), 6))
        assert_equal(sampling.select_sampled_neighbors(packed, nodes, ets,
                                                       *u),
                     sampling.select_sampled_neighbors(plain, nodes, ets,
                                                       *u))
    et = torch.zeros_like(nodes)
    for a, b in zip(sampling._group_bounds(packed, nodes, et),
                    sampling._group_bounds(plain, nodes, et)):
        assert torch.equal(a, b)


# ------------------------------------------------------ sample_neighbor --

@pytest.mark.parametrize("branch", ["sample_pack", "alias"])
@pytest.mark.parametrize("ets", [(0,), (2, 1), (0, 1, 2, 3)])
def test_sample_neighbor_bit_exact(pair, branch, ets):
    gj, gt = pair
    tj, tt = (gj.tensors, gt.tensors) if branch == "sample_pack" else \
        bare(gj, gt)
    key = jax.random.PRNGKey(len(ets))
    want = jax.jit(lambda g, n: jax_sampling.sample_neighbor(
        g, key, n, ets, 7, -3))(tj, jnp.asarray(NODES))
    got = sampling.select_sampled_neighbors(
        tt, torch.from_numpy(NODES), ets,
        *uniforms(key, (len(NODES), 7)), default_id=-3)
    assert_equal(got, want)
    nbr, w, ty = (x.numpy() for x in got[:3])
    assert (nbr[:2] == -3).all() and (nbr[2:40] >= 0).mean() > 0.8
    drawn = nbr[:42] >= 0                      # the nodes in the graph
    assert set(np.unique(ty[:42][drawn])) == set(ets)
    assert (w[:42][drawn] > 0).all()


def test_sample_neighbor_distribution_on_the_toy_graph(toy_dir):
    # node 100: click 101 (w1), click 103 (w3), buy 105 (w2), both
    # branches from a torch.Generator
    g = load_graph(toy_dir, packs=("sample",), device="cpu")
    n100 = torch.tensor([g.local_id(100)], dtype=torch.int32)
    for t in (g.tensors, dataclasses.replace(g.tensors, sample_pack=None)):
        gen = torch.Generator().manual_seed(5)
        nbr, w, ty, _ = sampling.sample_neighbor(t, n100, (0, 1), 30_000,
                                                 generator=gen)
        ext = g.ext_ids[nbr[0].numpy()]
        np.testing.assert_allclose([(ext == e).mean() for e in
                                    (101, 103, 105)], [1 / 6, 3 / 6, 2 / 6],
                                   atol=0.015)
        names = [g.meta.edge_types[t] for t in ty[0].tolist()]
        assert set(zip(ext.tolist(), names, w[0].tolist())) == {
            (101, "click", 1.0), (103, "click", 3.0), (105, "buy", 2.0)}


def test_sample_node_with_src_bit_exact_and_by_type(toy_dir):
    gj = jax_load_graph(toy_dir)
    gt = load_graph(toy_dir, device="cpu")
    src = np.array([0, 1, -1, 5, 7, 2], np.int32)
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda g, s: jax_sampling.sample_node_with_src(
        g, key, s, 9))(gj.tensors, jnp.asarray(src))
    got = sampling.select_nodes_with_src(
        gt.tensors, torch.from_numpy(src),
        *uniforms(key, (len(src), 9), typed=False))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nt = gt.tensors.node_type.numpy()
    draws = sampling.sample_node_with_src(
        gt.tensors, torch.from_numpy(src), 2000,
        generator=torch.Generator().manual_seed(0)).numpy()
    assert (draws[2] == -1).all()
    for i in (0, 1, 3, 4, 5):
        assert (nt[draws[i]] == nt[src[i]]).all()


# ------------------------------------------- top-k and in-neighbor verbs --

@pytest.mark.parametrize("k,cap", [(3, None), (5, 8)])
def test_get_top_k_neighbor_bit_exact(pair, k, cap):
    gj, gt = pair
    want = jax.jit(lambda g, n: jax_sampling.get_top_k_neighbor(
        g, n, (0, 2), k, cap, -2))(gj.tensors, jnp.asarray(NODES))
    got = sampling.get_top_k_neighbor(gt.tensors, torch.from_numpy(NODES),
                                      (0, 2), k, cap, -2)
    assert_equal(got, want)
    w = got[1].numpy()
    assert (np.diff(w, axis=1) <= 0).all() and (w > 0).any()


@pytest.mark.parametrize("ets", [(1,), (3, 0, 2)])
def test_sample_in_neighbor_bit_exact(pair, ets):
    gj, gt = pair
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda g, n: jax_sampling.sample_in_neighbor(
        g, key, n, ets, 5, -4))(gj.tensors, jnp.asarray(NODES))
    got = sampling.select_in_neighbors(gt.tensors, torch.from_numpy(NODES),
                                       ets, *uniforms(key, (len(NODES), 5)),
                                       default_id=-4)
    assert_equal(got, want)
    assert (got[0].numpy()[2:40] >= 0).mean() > 0.8


@pytest.mark.parametrize("sorted_by_id", [False, True])
def test_full_and_top_k_in_neighbors_bit_exact(pair, sorted_by_id):
    gj, gt = pair
    nodes = jnp.asarray(NODES)
    want = jax.jit(lambda g, n: jax_sampling.get_full_in_neighbor(
        g, n, (2, 0), 10, -1, sorted_by_id))(gj.tensors, nodes)
    got = sampling.get_full_in_neighbor(gt.tensors, torch.from_numpy(NODES),
                                        (2, 0), 10, -1, sorted_by_id)
    assert_equal(got, want)
    want = jax.jit(lambda g, n: jax_sampling.get_top_k_in_neighbor(
        g, n, (2, 0), 4))(gj.tensors, nodes)
    got = sampling.get_top_k_in_neighbor(gt.tensors, torch.from_numpy(NODES),
                                         (2, 0), 4)
    assert_equal(got, want)


def test_in_neighbors_are_the_sources(pair):
    _, gt = pair
    t = gt.tensors
    nbr, _, ty, eid, ok = sampling.get_full_in_neighbor(
        t, torch.arange(N, dtype=torch.int32), (0, 1, 2, 3), 40)
    src, dst = t.adj_src.numpy(), t.adj_dst.numpy()
    slot_of = np.argsort(t.adj_eid.numpy())
    e, okn = eid.numpy(), ok.numpy()
    assert (src[slot_of[e[okn]]] == nbr.numpy()[okn]).all()
    assert (dst[slot_of[e[okn]]] == np.nonzero(okn)[0]).all()
    assert (t.adj_type.numpy()[slot_of[e[okn]]] == ty.numpy()[okn]).all()


def test_in_neighbor_distribution(toy_dir):
    # in-edges of 101: click from 100 (w1) and 102 (w2), buy from 104 (w4)
    # (the converter builds the in-CSR by default)
    g = load_graph(toy_dir, device="cpu")
    n101 = torch.tensor([g.local_id(101)], dtype=torch.int32)
    src, w, ty, _ = sampling.sample_in_neighbor(
        g.tensors, n101, ("click", "buy"), 28_000,
        generator=torch.Generator().manual_seed(2))
    ext = g.ext_ids[src[0].numpy()]
    np.testing.assert_allclose([(ext == e).mean() for e in (100, 102, 104)],
                               [1 / 7, 2 / 7, 4 / 7], atol=0.015)
    names = [g.meta.edge_types[t] for t in ty[0].tolist()]
    assert set(zip(ext.tolist(), names)) == {(100, "click"), (102, "click"),
                                             (104, "buy")}


@pytest.mark.parametrize("verb,args", [
    ("sample_in_neighbor", ((0,), 2)), ("get_full_in_neighbor", ((0,), 4)),
    ("get_top_k_in_neighbor", ((0,), 2))])
def test_in_verbs_raise_without_the_in_csr(pair, verb, args):
    g = dataclasses.replace(pair[1].tensors, in_group_ptr=None)
    with pytest.raises(ValueError, match="has_in_edges=True"):
        getattr(sampling, verb)(g, torch.zeros(3, dtype=torch.int32), *args)


# ---------------------------------------------------- fanouts and layers --

def fanout_uniforms(key, B, counts):
    """The per-hop uniforms ``sample_fanout`` draws from ``key``."""
    out, n = [], B
    for c in counts:
        key, sub = jax.random.split(key)
        out.append(uniforms(sub, (n, c)))
        n *= c
    return out


def test_sample_fanout_and_multi_hop_bit_exact(pair):
    gj, gt = pair
    counts, metapath = [3, 2], [(0, 1), (2,)]
    nodes = NODES[:20]
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda g, n: jax_sampling.sample_fanout(
        g, key, n, metapath, counts))(gj.tensors, jnp.asarray(nodes))
    u = fanout_uniforms(key, len(nodes), counts)
    got = sampling.select_fanout(gt.tensors, torch.from_numpy(nodes),
                                 metapath, counts, u)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    want = jax.jit(lambda g, n: jax_sampling.get_multi_hop_neighbor(
        g, key, n, metapath, counts))(gj.tensors, jnp.asarray(nodes))
    got = sampling.get_multi_hop_neighbor(
        gt.tensors, torch.from_numpy(nodes), metapath, counts, uniforms=u)
    for hop_t, hop_j in zip(got, want):
        for x, y in zip(hop_t, hop_j):
            y = np.asarray(y)
            assert x.numpy().dtype == y.dtype
            np.testing.assert_array_equal(x.numpy(), y)
    hops = sampling.sample_fanout(gt.tensors, torch.from_numpy(nodes),
                                  metapath, counts,
                                  generator=torch.Generator().manual_seed(1))
    assert [len(h) for h in hops[0]] == [20, 60, 120]


def ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("weight_func", ["sqrt", "id", "uniform"])
def test_sample_layer_matches_but_for_near_ties(pair, weight_func):
    gj, gt = pair
    frontier = NODES[2:42]
    key = jax.random.PRNGKey(13)
    want = jax.jit(lambda g, f: jax_sampling.sample_layer(
        g, key, f, (0, 3), 6, 50, weight_func))(gj.tensors,
                                                jnp.asarray(frontier))
    k1, k2 = jax.random.split(key)
    n = len(frontier) * 6
    u_key = jax.random.uniform(k2, (n,), minval=1e-20, maxval=1.0)
    u = (uniforms(k1, (len(frontier), 6)), torch.from_numpy(np.array(u_key)))
    ids, w = sampling.select_layer(gt.tensors, torch.from_numpy(frontier),
                                   (0, 3), 6, 50, u, weight_func)
    # the reference's keys, from the port's candidates (equal bit for bit)
    cand, cw, _, _ = sampling.select_sampled_neighbors(
        gt.tensors, torch.from_numpy(frontier), (0, 3), *u[0])
    wf = {"sqrt": jnp.sqrt, "id": lambda x: x,
          "uniform": jnp.ones_like}[weight_func]
    flat, fw = jnp.asarray(cand.numpy().reshape(-1)), jnp.asarray(
        cw.numpy().reshape(-1))
    score = jnp.where(flat >= 0, wf(jnp.maximum(fw, 0.0)), 0.0)
    keyed = np.asarray(jnp.where(score > 0, jnp.log(score) - jnp.log(
        -jnp.log(u_key)), -jnp.inf))
    top = np.sort(keyed[np.isfinite(keyed)])[::-1]
    want_ids, want_w = np.asarray(want[0]), np.asarray(want[1])
    assert len(top) > 50 and (ids.numpy() >= 0).all()
    pos = np.argsort(-keyed, kind="stable")[:50]
    gaps = top[:50] - top[1:51]
    near = gaps <= 4 * ulp(top[:50])
    # a near tie inside the layer may only swap two draws' places, one at
    # its edge which of the two is taken
    if near[49]:
        assert len(set(ids.numpy()) ^ set(want_ids)) <= 2
    else:
        np.testing.assert_array_equal(np.sort(ids.numpy()),
                                      np.sort(want_ids))
        np.testing.assert_array_equal(np.sort(w.numpy()), np.sort(want_w))
    same = ~(near | np.concatenate([[False], near[:-1]]))
    np.testing.assert_array_equal(ids.numpy()[same], want_ids[same])
    np.testing.assert_array_equal(flat[pos][same], want_ids[same])


def test_sample_layer_pads_where_few_candidates_score(pair):
    _, gt = pair
    frontier = torch.tensor([-1, -1, 0], dtype=torch.int32)
    ids, w = sampling.sample_layer(gt.tensors, frontier, (0,), 2, 5,
                                   generator=torch.Generator().manual_seed(3))
    assert (ids[2:] == -1).all() and (w[2:] == 0).all()
    assert (ids[:2] >= 0).all()
    u = sampling.draw_gumbel_uniforms(None, (100_000,), "cpu")
    assert float(u.min()) > 0 and bool(torch.isfinite(sampling.gumbel(u))
                                       .all())


# ------------------------------------------ adjacency, labels and types --

@pytest.mark.parametrize("packs", ["group", "plain"])
def test_sparse_get_adj_bit_exact(pair, packs):
    gj, gt = pair
    tj, tt = (gj.tensors, gt.tensors) if packs == "group" else bare(gj, gt)
    nodes = NODES[:30]
    nb = np.concatenate([np.arange(0, N, 3), [-1, N - 1]]).astype(np.int32)
    want = jax.jit(lambda g, a, b: jax_sampling.sparse_get_adj(
        g, a, b, (1, 0)))(tj, jnp.asarray(nodes), jnp.asarray(nb))
    got = sampling.sparse_get_adj(tt, torch.from_numpy(nodes),
                                  torch.from_numpy(nb), (1, 0))
    assert_equal(got, want, ("conn", "w"))
    assert got[0].any()


@pytest.fixture(scope="module")
def motif(tmp_path_factory):
    from euler_tpu.datasets.synthetic import MotifDataset
    ds = MotifDataset(str(tmp_path_factory.mktemp("motif_port")),
                      n_graphs=9, seed=2)
    return ds.load_graph(), load_graph(ds.data_dir, device="cpu")


def test_graph_label_verbs(motif):
    gj, gt = motif
    for name in ("graph_members", "graph_member_cnt"):
        np.testing.assert_array_equal(getattr(gt.tensors, name).numpy(),
                                      np.asarray(getattr(gj.tensors, name)))
    idx = np.array([0, 4, 8, -1, 30], np.int32)
    want = jax_sampling.get_graph_by_label(gj.tensors, jnp.asarray(idx))
    got = sampling.get_graph_by_label(gt.tensors, torch.from_numpy(idx))
    assert_equal(got, want, ("members", "mask", "graph_idx"))
    lab = sampling.sample_graph_label(
        gt.tensors, 9000, generator=torch.Generator().manual_seed(0))
    assert lab.dtype == torch.int32
    np.testing.assert_allclose(np.bincount(lab.numpy(), minlength=9) / 9000,
                               np.full(9, 1 / 9), atol=0.02)


@pytest.mark.parametrize("verb,args", [("sample_graph_label", (3,)),
                                       ("get_graph_by_label",
                                        (torch.zeros(2, dtype=torch.int32),))])
def test_graph_label_verbs_raise_without_labels(pair, verb, args):
    with pytest.raises(ValueError, match="graph_label"):
        getattr(sampling, verb)(pair[1].tensors, *args)


def test_get_node_type(toy_dir):
    gj = jax_load_graph(toy_dir)
    gt = load_graph(toy_dir, device="cpu")
    nodes = np.array([0, 3, -1, 7, 5, 12], np.int32)
    np.testing.assert_array_equal(
        sampling.get_node_type(gt.tensors, torch.from_numpy(nodes)).numpy(),
        np.asarray(jax_sampling.get_node_type(gj.tensors,
                                              jnp.asarray(nodes))))


# -------------------------------------------------------------- util_ops --

def test_inflate_idx_matches():
    rng = np.random.default_rng(0)
    for n, u in ((1, 1), (40, 7), (500, 500)):
        idx = rng.integers(0, u, n).astype(np.int32)
        got = util_ops.inflate_idx(torch.from_numpy(idx))
        want = jax_util_ops.inflate_idx(jnp.asarray(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert sorted(got.tolist()) == list(range(n))


def test_unique_gather_matches_and_fetches_each_id_once():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    ids = rng.integers(-1, 50, 400).astype(np.int32)
    seen = []

    def fetch(i):
        seen.append(i.clone())
        return gr.gather_rows(torch.from_numpy(table), i)
    got = util_ops.unique_gather(fetch, torch.from_numpy(ids))
    want = jax_util_ops.unique_gather(
        lambda i: jnp.where((i >= 0)[:, None], jnp.asarray(table)[
            jnp.maximum(i, 0)], 0.0), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), gr.gather_rows(
        torch.from_numpy(table), torch.from_numpy(ids)).numpy())
    fetched = seen[0].numpy()
    assert sorted(fetched[fetched >= 0]) == sorted(set(ids[ids >= 0]))


def test_sparse_gather_matches():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 99, (6, 4)).astype(np.int32)
    mask = rng.random((6, 4)) < 0.6
    gi = np.array([0, 5, -1, 2, 2, 6, 40], np.int32)   # -1 and past the end
    got = util_ops.sparse_gather(torch.from_numpy(gi), torch.from_numpy(ids),
                                 torch.from_numpy(mask))
    want = jax_util_ops.sparse_gather(jnp.asarray(gi), jnp.asarray(ids),
                                      jnp.asarray(mask))
    assert_equal(got, want, ("ids", "mask"))
    assert (got[0].numpy()[2] == -1).all() and not got[1][2].any()


# ------------------------------------------------- GNNNet(dedup_features) --

def test_dedup_features_equals_the_plain_fetch():
    g = random_graph(60, 6, feat_dim=8, n_classes=3, seed=4,
                     device="cpu").tensors
    nets = [GNNNet("sage", SageDataFlow([5, 4], [(0,), (0,)]), (8, 8),
                   ShallowEncoder(("feature",)), in_dim=8, device="cpu",
                   generator=torch.Generator().manual_seed(0),
                   dedup_features=d) for d in (False, True)]
    roots = torch.arange(-1, 30, dtype=torch.int32)
    u = [sampling.draw_neighbor_uniforms(g, (0,), torch.Generator()
                                         .manual_seed(1), n, c, "cpu")
         for n, c in ((31, 5), (31 * 6, 4))]
    before = gr.gather_rows.launches
    outs = [net(g, roots, uniforms=u) for net in nets]
    assert gr.gather_rows.launches == before     # plain on the CPU
    np.testing.assert_array_equal(outs[0].detach().numpy(),
                                  outs[1].detach().numpy())
    outs[1].sum().backward()
    assert all(p.grad is not None for p in nets[1].parameters())
