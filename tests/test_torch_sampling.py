"""Neighbor sampling and feature lookup of the PyTorch port against
euler_tpu.

The reference draws its uniforms from a jax PRNG key inside
``sample_neighbor_fast``; the test derives the same numbers from the same
key (``k1, k2 = split(key)``, ``uniform(k1|k2, (B, C))``) and hands them
to the port's deterministic select, which must return the same ids and
validity bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.ops import feature_ops as jax_feature_ops
from euler_tpu.ops import sampling as jax_sampling
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.ops import feature_ops, sampling
from tests.test_torch_graph import random_pair


def key_uniforms(key, B, C):
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.uniform(k1, (B, C))),
            np.array(jax.random.uniform(k2, (B, C))))


def assert_same_draws(gj, gt, nodes, et, C, seed, default_id=-1):
    key = jax.random.PRNGKey(seed)
    want_ids, want_valid = jax_sampling.sample_neighbor_fast(
        gj.tensors, key, jnp.asarray(nodes), (et,), C, default_id)
    u1, u2 = key_uniforms(key, len(nodes), C)
    ids, valid = sampling.select_fan_neighbors(
        gt.tensors, torch.from_numpy(nodes), et, torch.from_numpy(u1),
        torch.from_numpy(u2), default_id)
    assert ids.shape == valid.shape == (len(nodes), C)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    return ids.numpy(), valid.numpy()


def test_toy_graph_select_bit_exact(toy_dir, toy_graph):
    gt = load_graph(toy_dir, device="cpu")
    nodes = np.asarray([toy_graph.local_id(e) for e in range(100, 108)]
                       + [-1], np.int32)
    for et in range(len(toy_graph.meta.edge_types)):
        ids, valid = assert_same_draws(toy_graph, gt, nodes, et, 64,
                                       seed=11 + et, default_id=-3)
        assert not valid[-1].any() and (ids[-1] == -3).all()


@pytest.mark.parametrize("n_nodes,avg_degree,C", [(2000, 25, 3),
                                                  (300, 50, 10)])
def test_random_graph_select_bit_exact(n_nodes, avg_degree, C):
    gj, gt = random_pair(n_nodes, avg_degree, seed=0)
    rng = np.random.default_rng(C)
    nodes = rng.integers(0, n_nodes, 257).astype(np.int32)
    nodes[::9] = -1
    ids, valid = assert_same_draws(gj, gt, nodes, 0, C, seed=C)
    assert valid.sum() > 0


def test_distribution_click_100_to_103(toy_dir):
    # toy "click" edges of node 100: ->101 (w1), ->103 (w3)
    g = load_graph(toy_dir, device="cpu")
    et = g.meta.edge_types.index("click")
    gen = torch.Generator().manual_seed(4)
    nodes = torch.tensor([g.local_id(100)], dtype=torch.int32)
    u1, u2 = sampling.draw_fan_uniforms(gen, 1, 20_000, "cpu")
    nbr, valid = sampling.select_fan_neighbors(g.tensors, nodes, et, u1, u2)
    assert bool(valid.all())
    exts = g.ext_ids[nbr[0].numpy()]
    assert set(np.unique(exts)) == {101, 103}
    np.testing.assert_allclose((exts == 103).mean(), 0.75, atol=0.02)


def test_draw_fan_uniforms_shapes_and_range():
    gen = torch.Generator().manual_seed(0)
    u1, u2 = sampling.draw_fan_uniforms(gen, 5, 7, "cpu")
    assert u1.shape == u2.shape == (5, 7)
    assert u1.dtype == torch.float32
    assert float(u1.min()) >= 0.0 and float(u1.max()) < 1.0
    assert not torch.equal(u1, u2)


@pytest.mark.parametrize("typed", [False, True])
def test_multi_type_hop_matches_reference(toy_dir, toy_graph, typed):
    # the toy graph has no union rows, so the hop over (click, buy) takes
    # the per-type branch: (ut, u1, u2) from kt, kd = split(sub) and
    # k1, k2 = split(kd), where key, sub = split(key) in the flow
    g = load_graph(toy_dir, device="cpu")
    roots = np.asarray([g.local_id(e) for e in range(100, 108)] + [-1],
                       np.int32)
    key = jax.random.PRNGKey(21)
    want = jax_flows.SageDataFlow([6], [(0, 1)], typed=typed)(
        toy_graph.tensors, key, jnp.asarray(roots))[0]
    _, sub = jax.random.split(key)
    kt, kd = jax.random.split(sub)
    k1, k2 = jax.random.split(kd)
    uniforms = [tuple(torch.from_numpy(np.array(jax.random.uniform(
        k, (len(roots), 6)))) for k in (kt, k1, k2))]
    got = SageDataFlow([6], [(0, 1)], typed=typed)(
        g.tensors, torch.from_numpy(roots), uniforms=uniforms)[0]
    for name in ("n_id", "edge_index", "mask", "edge_weight", "e_id") + (
            ("e_type",) if typed else ()):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert (got.e_type is None) == (want.e_type is None) == (not typed)
    assert got.mask[:-6].sum() > 30            # 107 and -1 draw nothing


def test_typed_hop_without_its_pack_raises_naming_it(toy_dir):
    g = load_graph(toy_dir, packs=("fanu",), device="cpu")
    roots = torch.zeros(2, dtype=torch.int32)
    # the union rows serve a hop over every type, not one over "click"
    blk = SageDataFlow([3], [(0, 1)], typed=True)(g.tensors, roots)[0]
    assert blk.e_type.shape == (8,)
    # the hop over "click" lacks its 'fan' pack: it draws through
    # select_sampled_neighbors (the reference's sample_neighbor fallback)
    flow = SageDataFlow([3], [("click",)], typed=True)
    u = [flow.draw_hop(g.tensors, ("click",), None, 2, 3, "cpu")]
    blk = flow(g.tensors, roots, uniforms=u)[0]
    nbr, _, ty, _ = sampling.select_sampled_neighbors(g.tensors, roots,
                                                      ("click",), *u[0])
    assert len(u[0]) == 3 and torch.equal(blk.n_id[2:], nbr.reshape(-1))
    assert set(blk.e_type.numpy().tolist()) <= {-1, g.meta.edge_type_id(
        "click")}


def test_dense_feature_matches_reference_with_negative_ids(toy_dir,
                                                           toy_graph):
    gt = load_graph(toy_dir, device="cpu")
    nodes = np.asarray([[0, -1, 7], [3, 3, -1]], np.int32)
    names = ["dense2", "price"]
    want = jax_feature_ops.get_dense_feature(toy_graph.tensors,
                                             jnp.asarray(nodes), names)
    got = feature_ops.get_dense_feature(gt.tensors, torch.from_numpy(nodes),
                                        names)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][0, 1] == 0).all()
