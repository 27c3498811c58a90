"""Typed and multi-type neighbor sampling of the PyTorch port against
euler_tpu: the ``fanu`` pack (union fan rows), the union draw (the
``fan_draw`` kernel's union epilogue), the K=1 typed draw, the per-type
K>1 draw and the union reservoir redraw.

Packs, ids and types must be equal bit for bit. The reference derives
its uniforms from its key inside ``sample_neighbor_fast``: ``k1, k2 =
split(key)`` for one-type and union hops, ``kt, kd = split(key); k1, k2 =
split(kd)`` for per-type hops; the tests hand the same numbers to the
port's deterministic selects. Draws from a torch.Generator are tested by
their distribution.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_union_pack
from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.ops import pallas_fan
from euler_tpu.ops import sampling as jax_sampling
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.ops import fan_draw as fd
from euler_tpu_torch.ops import sampling
from euler_tpu_torch.ops.alias import (FAN_ALIAS_OFF, FAN_D, FAN_KEPT_OFF,
                                       FANU_MASK, FANU_SHIFT)
from tests.test_torch_graph import native_off

FANU_FIELDS = ("fanu_pack", "fanu_over_rows", "fanu_ptr", "fanu_dst",
               "fanu_prob", "fanu_alias")


def typed_pair(n_nodes, avg_degree, packs, num_edge_types=4, seed=0):
    """(euler_tpu Graph, port Graph on the CPU) of one multi-type random
    graph, with the numpy CSR sort on both sides (ROADMAP Queue C)."""
    with native_off(("build_csr_native",)):
        gj = jax_random_graph(n_nodes, avg_degree, seed=seed, packs=packs,
                              num_edge_types=num_edge_types)
        gt = random_graph(n_nodes, avg_degree, seed=seed, packs=packs,
                          num_edge_types=num_edge_types, device="cpu")
    return gj, gt


@pytest.fixture(scope="module")
def union_pair():
    # average degree 200 over 4 types: fan rows (about 50 edges each) and
    # union rows of degree > FAN_D, both reservoirs
    return typed_pair(300, 200, ("fan", "fanu"))


@pytest.fixture(scope="module")
def toy_union(toy_dir):
    with native_off():
        gj = jax_load_graph(toy_dir, packs=("fan", "fanu"))
        gt = load_graph(toy_dir, packs=("fan", "fanu"), device="cpu")
    return gj, gt


def assert_fanu_equal(gj, gt):
    for name in FANU_FIELDS:
        np.testing.assert_array_equal(getattr(gt.tensors, name).numpy(),
                                      np.asarray(getattr(gj.tensors, name)),
                                      err_msg=name)


def test_fanu_fields_match_on_the_toy_graph(toy_union):
    gj, gt = toy_union
    assert_fanu_equal(gj, gt)
    lanes = gt.tensors.fanu_pack.numpy()[gt.local_id(100)]
    assert lanes[0] == 3                    # click 101, click 103, buy 105


def test_fanu_fields_match_on_a_four_type_graph(union_pair):
    gj, gt = union_pair
    assert_fanu_equal(gj, gt)
    assert len(gt.tensors.fanu_over_rows) == 300
    assert len(gt.tensors.fan_over_rows) > 300
    dst = gt.tensors.fanu_dst.numpy()
    assert set(np.unique(dst >> FANU_SHIFT)) == {0, 1, 2, 3}
    assert (dst & FANU_MASK).max() < 300
    moved = gt.tensors.to("meta")
    assert all(getattr(moved, n).device.type == "meta" for n in FANU_FIELDS)


@pytest.mark.parametrize("num_edge_types", [1, 17])
def test_fanu_is_skipped_where_the_lanes_cannot_encode_it(num_edge_types):
    # the reference's gate: 2 <= ET <= 16 (and N < 2^27), else no pack
    g = random_graph(50, 3, num_edge_types=num_edge_types,
                     packs=("fan", "fanu"), device="cpu")
    assert all(getattr(g.tensors, n) is None for n in FANU_FIELDS)
    assert g.tensors.fan_pack is not None


def key_uniforms(key, B, C, typed=False):
    """The uniforms sample_neighbor_fast draws from ``key``."""
    out = []
    if typed:
        kt, key = jax.random.split(key)
        out.append(jax.random.uniform(kt, (B, C)))
    k1, k2 = jax.random.split(key)
    out += [jax.random.uniform(k1, (B, C)), jax.random.uniform(k2, (B, C))]
    return tuple(torch.from_numpy(np.array(u)) for u in out)


def assert_same_typed_draws(gj, gt, nodes, ets, C, seed, typed,
                            default_id=-1):
    key = jax.random.PRNGKey(seed)
    want = jax_sampling.sample_neighbor_fast(
        gj.tensors, key, jnp.asarray(nodes), ets, C, default_id,
        return_types=True)
    got = sampling.select_neighbors(
        gt.tensors, torch.from_numpy(nodes), ets,
        key_uniforms(key, len(nodes), C, typed), default_id,
        return_types=True)
    for name, w, t in zip(("ids", "valid", "types"), want, got):
        assert t.shape == (len(nodes), C)
        np.testing.assert_array_equal(t.numpy(), np.asarray(w),
                                      err_msg=name)
    # and without types: the same ids and validity
    ids, valid = sampling.select_neighbors(
        gt.tensors, torch.from_numpy(nodes), ets,
        key_uniforms(key, len(nodes), C, typed), default_id)
    assert torch.equal(ids, got[0]) and torch.equal(valid, got[1])
    return [t.numpy() for t in got]


@pytest.fixture(params=[False, True], ids=["jnp", "pallas"])
def pallas_mode(request):
    """Run the reference's union and K=1 draws through its jnp path and
    through the Pallas kernel (interpret mode on the CPU)."""
    pallas_fan.set_enabled(request.param)
    yield request.param
    pallas_fan.set_enabled(None)


def test_union_draw_bit_exact(union_pair, pallas_mode):
    gj, gt = union_pair
    rng = np.random.default_rng(3)
    nodes = rng.integers(0, 300, 97).astype(np.int32)
    nodes[::7] = -1
    assert sampling.uses_union(gt.tensors, (0, 1, 2, 3))
    ids, valid, ty = assert_same_typed_draws(gj, gt, nodes, (3, 1, 0, 2),
                                             25, seed=5, typed=False,
                                             default_id=-4)
    assert valid.mean() > 0.8 and (ids[~valid] == -4).all()
    assert set(np.unique(ty[valid])) == {0, 1, 2, 3}
    assert (ty[~valid] == -1).all()


def test_union_draw_on_the_toy_graph(toy_union, pallas_mode):
    gj, gt = toy_union
    nodes = np.asarray([gt.local_id(e) for e in range(100, 108)] + [-1],
                       np.int32)
    _, valid, _ = assert_same_typed_draws(gj, gt, nodes, ("click", "buy"),
                                          40, seed=2, typed=False)
    assert not valid[-1].any() and not valid[gt.local_id(107)].any()


def test_one_type_typed_draw_bit_exact(union_pair, pallas_mode):
    gj, gt = union_pair
    nodes = np.random.default_rng(4).integers(-1, 300, 64).astype(np.int32)
    for et in (0, 2):
        _, valid, ty = assert_same_typed_draws(gj, gt, nodes, (et,), 10,
                                               seed=et, typed=False)
        assert (ty[valid] == et).all() and (ty[~valid] == -1).all()


@pytest.mark.parametrize("ets", [(0, 2), (1, 2, 3), (0, 1, 2, 3)])
def test_per_type_draw_bit_exact(ets):
    # no fanu pack: every multi-type hop takes the per-type branch
    gj, gt = typed_pair(400, 60, ("fan",), seed=1)
    assert not sampling.uses_union(gt.tensors, ets)
    nodes = np.random.default_rng(5).integers(0, 400, 211).astype(np.int32)
    nodes[::11] = -1
    ids, valid, ty = assert_same_typed_draws(gj, gt, nodes, ets, 20,
                                             seed=len(ets), typed=True)
    assert set(np.unique(ty[valid])) == set(ets)


def test_per_type_cdf_adds_left_to_right():
    # torch.cumsum associates a 4-term running sum otherwise than XLA's
    # left-to-right cumsum; the type pick compares against the reference's
    # sums, so ties decide the same way
    gj, gt = typed_pair(3000, 8, ("fan",), seed=2)
    w = gt.tensors.group_w_sum.numpy()
    left = np.cumsum(w, axis=1, dtype=np.float32)
    for k in range(1, 4):
        left[:, k] = left[:, k - 1] + w[:, k]
    np.testing.assert_array_equal(left, np.asarray(jnp.cumsum(
        jnp.asarray(w), axis=1)))
    nodes = np.arange(3000, dtype=np.int32)
    assert_same_typed_draws(gj, gt, nodes, (0, 1, 2, 3), 16, seed=9,
                            typed=True)


def test_per_type_draw_clamps_rows_past_the_graph():
    # node ids >= N: XLA clamps the fan-row gather, the port too
    gj, gt = typed_pair(300, 20, ("fan",), seed=3)
    nodes = np.asarray([0, 299, 300, 5000, -1], np.int32)
    assert_same_typed_draws(gj, gt, nodes, (0, 3), 12, seed=1, typed=True)


def test_union_distribution_of_node_100(toy_union):
    # node 100's union row: click 101 (w1), click 103 (w3), buy 105 (w2)
    _, g = toy_union
    gen = torch.Generator().manual_seed(8)
    n = 30_000
    nodes = torch.tensor([g.local_id(100)], dtype=torch.int32)
    u1, u2 = sampling.draw_neighbor_uniforms(g.tensors, (0, 1), gen, 1, n,
                                             "cpu")
    ids, valid, ty = sampling.select_neighbors(g.tensors, nodes, (0, 1),
                                               (u1, u2), return_types=True)
    assert bool(valid.all())
    exts = g.ext_ids[ids[0].numpy()]
    names = [g.meta.edge_types[t] for t in ty[0].numpy()]
    assert set(zip(exts.tolist(), names)) == {(101, "click"), (103, "click"),
                                              (105, "buy")}
    freq = [(exts == e).mean() for e in (101, 103, 105)]
    np.testing.assert_allclose(freq, [1 / 6, 3 / 6, 2 / 6], atol=0.02)


def test_uniforms_of_each_hop_kind(union_pair, toy_dir):
    _, gt = union_pair
    gen = torch.Generator().manual_seed(0)
    for ets, n in (((1,), 2), ((0, 1, 2, 3), 2), ((0, 1), 3)):
        u = sampling.draw_neighbor_uniforms(gt.tensors, ets, gen, 5, 7,
                                            "cpu")
        assert len(u) == n and all(x.shape == (5, 7) for x in u)
        with pytest.raises(ValueError, match="uniform tensors"):
            sampling.select_neighbors(gt.tensors, torch.zeros(5, dtype=
                                                               torch.int32),
                                      ets, u[:1])
    ut, u1, u2 = sampling.draw_typed_uniforms(gen, 4, 3, "cpu")
    assert not torch.equal(ut, u1) and float(ut.max()) < 1.0


def test_hops_on_a_graph_without_their_pack_name_it():
    g = random_graph(60, 5, num_edge_types=4, packs=("fanu",),
                     device="cpu").tensors
    assert g.fan_pack is None and g.fanu_pack is not None
    nodes = torch.arange(4, dtype=torch.int32)
    u = sampling.draw_neighbor_uniforms(g, (0, 1, 2, 3), None, 4, 3, "cpu")
    assert sampling.select_neighbors(g, nodes, (0, 1, 2, 3), u)[0].shape \
        == (4, 3)
    # a hop that lacks its pack draws through select_sampled_neighbors,
    # as the reference's sample_neighbor_fast falls back to
    # sample_neighbor (tests/test_torch_fallback.py holds it bit exact)
    for ets in ((1,), (0, 2)):
        assert sampling.hop_kind(g, ets) == "sampled"
        uf = sampling.draw_neighbor_uniforms(g, ets, None, 4, 3, "cpu")
        assert len(uf) == 3
        ids, valid, ty = sampling.select_neighbors(g, nodes, ets, uf,
                                                   return_types=True)
        nbr, _, ty_s, _ = sampling.select_sampled_neighbors(g, nodes, ets,
                                                            *uf)
        assert torch.equal(ids, nbr) and torch.equal(ty, ty_s)
        assert torch.equal(valid, ty_s >= 0)
        with pytest.raises(ValueError, match="uniform tensors"):
            sampling.select_neighbors(g, nodes, ets, uf[1:])


# ------------------------------------------------------- union reservoir --

def test_fanu_refresh_bit_exact(union_pair):
    gj, gt = union_pair
    tj, tt = gj.tensors, gt.tensors
    K = int(tt.fanu_over_rows.shape[0])
    key = jax.random.PRNGKey(12)
    want = jax_sampling.refresh_fan_rows(
        tj.fanu_ptr, tj.fanu_dst, tj.fanu_prob, tj.fanu_alias, tj.fanu_pack,
        key, tj.fanu_over_rows)
    k1, k2 = jax.random.split(key)
    u1 = torch.from_numpy(np.array(jax.random.uniform(k1, (K, FAN_D))))
    u2 = torch.from_numpy(np.array(jax.random.uniform(k2, (K, FAN_D))))
    got = sampling.refresh_fan_rows(
        tt.fanu_ptr, tt.fanu_dst, tt.fanu_prob, tt.fanu_alias,
        tt.fanu_pack.clone(), tt.fanu_over_rows, u1, u2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_refresh_rewrites_only_reservoir_lanes_of_both_packs(union_pair):
    _, gt = union_pair
    g = dataclasses.replace(gt.tensors, fan_pack=gt.tensors.fan_pack.clone(),
                            fanu_pack=gt.tensors.fanu_pack.clone())
    before = {n: getattr(g, n).clone() for n in ("fan_pack", "fanu_pack")}
    sampling.refresh_fan_pack(g, torch.Generator().manual_seed(3))
    for pack, over, ptr, dst in (("fan_pack", g.fan_over_rows, g.group_ptr,
                                  g.adj_dst),
                                 ("fanu_pack", g.fanu_over_rows, g.fanu_ptr,
                                  g.fanu_dst)):
        after, old = getattr(g, pack), before[pack]
        over = over.long()
        keep = torch.ones(after.shape[0], dtype=torch.bool)
        keep[over] = False
        assert torch.equal(after[keep], old[keep]), pack
        assert torch.equal(after[over, :FAN_KEPT_OFF],
                           old[over, :FAN_KEPT_OFF]), pack
        kept = after[over, FAN_KEPT_OFF:FAN_KEPT_OFF + FAN_D]
        assert torch.equal(kept,
                           after[over, FAN_ALIAS_OFF:FAN_ALIAS_OFF + FAN_D])
        assert not torch.equal(kept, old[over, FAN_KEPT_OFF:
                                         FAN_KEPT_OFF + FAN_D]), pack
        gp, d = ptr.numpy(), dst.numpy()
        for i, r in enumerate(over.numpy()):
            assert set(kept[i].numpy()) <= set(d[gp[r]:gp[r + 1]]), pack


# ------------------------------------------ the kernel's plain epilogue --

@pytest.mark.parametrize("B,C", [(40, 25), (9, 600)])
def test_plain_union_epilogue_matches_pallas(B, C):
    # the union branch around the Pallas kernel (sampling.py:283-310) on a
    # synthetic union pack: types 0..15, ids up to FANU_MASK
    rng = np.random.default_rng(B)
    packs = synthetic_union_pack(rng, 64)
    nodes = rng.integers(0, 64, B).astype(np.int32)
    nodes[::4] = -1
    u1 = rng.random((B, C)).astype(np.float32)
    u2 = rng.random((B, C)).astype(np.float32)
    gathered = packs[np.maximum(nodes, 0)]
    draw = np.asarray(pallas_fan.fan_draw(jnp.asarray(gathered),
                                          jnp.asarray(u1), jnp.asarray(u2),
                                          interpret=True))
    valid = np.broadcast_to((nodes >= 0)[:, None] & (gathered[:, 0:1] > 0)
                            & (gathered[:, 1].view(np.float32) > 0)[:, None],
                            (B, C))
    ids, v, ty = fd.fan_draw(torch.from_numpy(packs), torch.from_numpy(nodes),
                             0, 1, torch.from_numpy(u1), torch.from_numpy(u2),
                             -2, union=True, return_types=True)
    np.testing.assert_array_equal(v.numpy(), valid)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.where(valid, draw & FANU_MASK, -2))
    np.testing.assert_array_equal(ty.numpy(),
                                  np.where(valid, draw >> FANU_SHIFT, -1))
    assert set(np.unique(ty.numpy()[valid])) <= set(range(16))
    assert ids.numpy()[valid].max() > FANU_MASK // 2


def test_union_draw_needs_one_row_per_node():
    packs = torch.zeros((4, 128), dtype=torch.int32)
    u = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="union rows"):
        fd.fan_draw(packs, torch.zeros(2, dtype=torch.int32), 0, 2, u, u,
                    union=True)


# ------------------------------------------ the row cdf past 16 columns --

@pytest.mark.parametrize("K", [8, 17, 18, 40, 300])
def test_row_cdf_matches_jnp_cumsum(K):
    # XLA's CPU cumsum adds left to right up to 16 columns and in blocks
    # of 16 past that; the type pick compares against its sums
    rng = np.random.default_rng(K)
    w = (rng.random((400, K)) * rng.choice([1e-3, 1.0, 7.0, 300.0],
                                           (400, 1))).astype(np.float32)
    w[::9, rng.integers(0, K)] = 0.0
    got = sampling.row_cdf(torch.from_numpy(w)).numpy()
    want = np.asarray(jnp.cumsum(jnp.asarray(w), axis=1))
    assert got.dtype == want.dtype and got.shape == (400, K)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def forty_types():
    # 40 edge types, about 7 edges of each a node, fan and sample packs
    # and the in-CSR
    with native_off(("build_csr_native",)):
        kw = dict(seed=5, num_edge_types=40, packs=("fan", "sample"),
                  build_in_edges=True)
        return (jax_random_graph(60, 300, **kw),
                random_graph(60, 300, device="cpu", **kw))


def boundary_uniforms(w: np.ndarray) -> np.ndarray:
    """Type-pick uniforms [B, 3K] that land each draw's ``u * total`` on
    or next to one of the reference's running sums of ``w`` [B, K], where
    a running sum added in another order sends a draw to another type."""
    cdf = np.asarray(jnp.cumsum(jnp.asarray(w), axis=1))
    u = (cdf / cdf[:, -1:]).astype(np.float32)
    u = np.concatenate([u, np.nextafter(u, np.float32(0)),
                        np.nextafter(u, np.float32(1))], axis=1)
    return np.minimum(u, np.nextafter(np.float32(1), np.float32(0)))


@pytest.mark.parametrize("verb", ["fan", "sample", "in"])
def test_typed_hop_over_forty_types_bit_exact(monkeypatch, forty_types,
                                              verb):
    gj, gt = forty_types
    ets = tuple(np.random.default_rng(1).permutation(40).tolist())
    nodes = np.arange(-1, 40, dtype=np.int32)
    t = gt.tensors
    w_all = (t.in_group_w_sum if verb == "in" else t.group_w_sum).numpy()
    ut = boundary_uniforms(w_all[np.maximum(nodes, 0)][:, list(ets)])
    B, C = ut.shape
    rng = np.random.default_rng(2)
    u1, u2 = (rng.random((B, C)).astype(np.float32) for _ in range(2))
    fed = [ut, u1, u2]
    # the reference's draws read these uniforms in order, for its key's
    real = jax.random.uniform
    monkeypatch.setattr(jax.random, "uniform",
                        lambda k, shape, *a, **kw: jnp.asarray(fed.pop(0)))
    key, n = jax.random.PRNGKey(0), jnp.asarray(nodes)
    if verb == "fan":
        want = jax_sampling.sample_neighbor_fast(gj.tensors, key, n, ets, C,
                                                 return_types=True)
        got = sampling.select_typed_neighbors(
            t, torch.from_numpy(nodes), ets, *map(torch.from_numpy,
                                                  (ut, u1, u2)),
            return_types=True)
        # ids, validity and types
        want = (want[0], want[1], want[2])
    else:
        fn = jax_sampling.sample_neighbor if verb == "sample" else \
            jax_sampling.sample_in_neighbor
        sel = sampling.select_sampled_neighbors if verb == "sample" else \
            sampling.select_in_neighbors
        want = fn(gj.tensors, key, n, ets, C)
        got = sel(t, torch.from_numpy(nodes), ets,
                  *map(torch.from_numpy, (ut, u1, u2)))
    monkeypatch.setattr(jax.random, "uniform", real)
    assert not fed
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ty = got[2].numpy()
    assert len(set(ty[ty >= 0].tolist())) == 40
