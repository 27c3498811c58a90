"""The port's sharded store against euler_tpu's, in one process.

``build_sharded`` of the port and of the reference, on the toy graph at
2 and 4 shards and on a random graph with 4 edge types (union rows) at 4
shards, must be equal field by field: every CSR array, the packs, the
alias tables, the in-CSR, ``eid_sorted``/``eid_slot``, the replicated
``shard_node_w``/``shard_edge_w`` and ``graph_members``. Both sides load
their graphs with the same packs (the reference's ALL_PACKS) and the
numpy CSR sort (ROADMAP traps). ``take_shard``, ``write_shards`` and
``load_shard``, and ``place_sharded_graph`` at a rank of the mesh, must
give one shard's view with those arrays.
"""
import dataclasses

import numpy as np
import pytest
import torch

from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.datasets.synthetic import MotifDataset as JaxMotifDataset
from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.parallel import sharded as jax_sharded
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.datasets.synthetic import MotifDataset
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.ops.dispatch import is_shard_view
from euler_tpu_torch.parallel import mesh as mesh_lib
from euler_tpu_torch.parallel import sharded, train
from tests.test_torch_graph import native_off

ALL_PACKS = ("group", "adj", "sample", "fan", "ell")
ALIAS_KEYS = ("ids", "type_ptr", "prob", "alias", "w_sum")


def toy_pair(toy_dir):
    with native_off(("build_csr_native",)):
        return (jax_load_graph(toy_dir),
                load_graph(toy_dir, packs=ALL_PACKS, device="cpu"))


def sharded_pair(gj, gt, S):
    with native_off(("build_csr_native",)):
        return jax_sharded.build_sharded(gj, S), sharded.build_sharded(gt, S)


def assert_store_equal(ref, got):
    assert got.num_shards == ref.num_shards
    for f in dataclasses.fields(got):
        name = f.name
        if name in ("meta", "num_shards"):
            continue
        a, b = getattr(ref, name), getattr(got, name)
        if name in ("node_alias", "edge_alias"):
            for k in ALIAS_KEYS:
                np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                              b[k], err_msg=f"{name}.{k}")
        elif isinstance(b, dict):
            assert set(a) == set(b), name
            for k in b:
                if isinstance(b[k], tuple):
                    for x, y in zip(a[k], b[k]):
                        np.testing.assert_array_equal(np.asarray(x), y,
                                                      err_msg=f"{name}:{k}")
                else:
                    np.testing.assert_array_equal(np.asarray(a[k]), b[k],
                                                  err_msg=f"{name}:{k}")
        elif b is None:
            assert a is None, name
        else:
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


@pytest.mark.parametrize("S", [2, 4])
def test_toy_store_equals_reference(toy_dir, S):
    gj, gt = toy_pair(toy_dir)
    ref, got = sharded_pair(gj, gt, S)
    assert got.in_group_ptr is not None and got.fanu_pack is not None
    assert_store_equal(ref, got)


def test_random_store_with_union_rows_equals_reference():
    kw = dict(num_edge_types=4, seed=3, build_in_edges=True)
    with native_off(("build_csr_native",)):
        gj = jax_random_graph(203, 9, packs=("fan",), **kw)
        gt = random_graph(203, 9, device="cpu", **kw)
    ref, got = sharded_pair(gj, gt, 4)
    assert got.fanu_pack.shape == (4, 51, 128)
    assert_store_equal(ref, got)


def test_graph_members_replicated(tmp_path_factory):
    dj = str(tmp_path_factory.mktemp("motif_j"))
    dt = str(tmp_path_factory.mktemp("motif_t"))
    gj = JaxMotifDataset(dj, n_graphs=12, seed=0).load_graph()
    gt = MotifDataset(dt, n_graphs=12, seed=0).load_graph(device="cpu")
    ref, got = sharded_pair(gj, gt, 4)
    assert got.graph_members is not None
    np.testing.assert_array_equal(np.asarray(ref.graph_members),
                                  got.graph_members)
    view = sharded.take_shard(got, 3, "cpu")
    np.testing.assert_array_equal(view.graph_members.numpy(),
                                  got.graph_members)


def test_take_shard_holds_one_shard(toy_dir, tmp_path):
    _, gt = toy_pair(toy_dir)
    sg = sharded.build_sharded(gt, 4)
    sharded.write_shards(sg, str(tmp_path))
    g = gt.tensors
    for s in range(4):
        rank = mesh_lib.Mesh(data=1, graph=4, rank=s, backend="gloo",
                             device=torch.device("cpu"), graph_group=None,
                             world_group=None)
        for view in (sharded.take_shard(sg, s, "cpu"),
                     sharded.load_shard(str(tmp_path), s, "cpu"),
                     train.place_sharded_graph(sg, rank)):
            assert is_shard_view(view) and view.my_shard == s
            assert view.num_shards == 4 and view.n_nodes == 2
            loc = view.local
            for name in ("node_type", "group_ptr", "adj_dst", "adj_eid",
                         "fan_pack", "sample_pack", "in_adj_src"):
                np.testing.assert_array_equal(
                    getattr(loc, name).numpy(), getattr(sg, name)[s],
                    err_msg=name)
            np.testing.assert_array_equal(view.dense_nf["dense2"].numpy(),
                                          sg.dense_nf["dense2"][s])
            np.testing.assert_array_equal(view.shard_node_w.numpy(),
                                          sg.shard_node_w)
            # each real slot's global source: its edge's source
            real = loc.adj_dst >= 0
            eid = loc.adj_eid[real].long()
            src_of_edge = torch.empty_like(g.adj_src)
            src_of_edge[g.adj_eid.long()] = g.adj_src
            np.testing.assert_array_equal(loc.adj_src[real].numpy(),
                                          src_of_edge[eid].numpy())
            assert (loc.adj_src[real] % 4 == s).all()


def test_view_without_mesh_names_it(toy_dir):
    _, gt = toy_pair(toy_dir)
    view = sharded.take_shard(sharded.build_sharded(gt, 2), 0, "cpu")
    with pytest.raises(ValueError, match="no mesh"):
        view.group


def test_refresh_fan_pack_sharded_redraws_reservoir_rows():
    """Each shard's reservoir rows (groups of degree > 42) are redrawn
    in place from its own neighbors; a data-axis replica of the shard
    (the same seed, the same graph index) draws the same rows."""
    from euler_tpu_torch.ops.alias import FAN_ALIAS_OFF, FAN_D, FAN_KEPT_OFF
    sg = sharded.build_sharded(random_graph(100, 50, seed=1, device="cpu"),
                               2)
    for s in range(2):
        a, b, c = (sharded.take_shard(sg, s, "cpu") for _ in range(3))
        before = a.fan_pack.clone()
        over = a.fan_over_rows.long()
        assert over.numel() > 0
        for view, seed in ((a, 7), (b, 7), (c, 8)):
            sharded.refresh_fan_pack_sharded(view, seed)
        assert torch.equal(a.fan_pack, b.fan_pack)
        assert not torch.equal(a.fan_pack[over], c.fan_pack[over])
        others = torch.ones(before.shape[0], dtype=torch.bool)
        others[over] = False
        assert torch.equal(a.fan_pack[others], before[others])
        lanes = torch.ones(before.shape[1], dtype=torch.bool)
        lanes[FAN_KEPT_OFF:FAN_KEPT_OFF + FAN_D] = False
        lanes[FAN_ALIAS_OFF:FAN_ALIAS_OFF + FAN_D] = False
        assert torch.equal(a.fan_pack[over][:, lanes],
                           before[over][:, lanes])
        gp = a.group_ptr.long()
        for row in over.tolist():
            nbrs = set(a.adj_dst[gp[row]:gp[row + 1]].tolist())
            drawn = a.fan_pack[row, FAN_KEPT_OFF:FAN_KEPT_OFF + FAN_D]
            assert set(drawn.tolist()) <= nbrs


def test_make_mesh_defaults_to_the_card():
    """Without ``device`` the mesh takes the card (and NCCL), and raises
    where there is none, before it joins any group."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would join NCCL")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_lib.make_mesh(1, 1, init_method="file:///nonexistent", rank=0)
    with pytest.raises(ValueError, match="NCCL"):
        mesh_lib.make_mesh(1, 1, backend="nccl", device="cpu",
                       init_method="file:///nonexistent", rank=0)
