"""The graph store's host lookups and load options of the PyTorch port
against euler_tpu on the CPU: ``local_ids``, the binary node and edge
features, ``max_id``, ``feature_dtype`` (a bf16 table bit-equal to the
reference's ``jnp.bfloat16`` one, compared as uint16), the
process-default graph, and a multi-partition load against a
single-partition one.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu_torch.datasets.synthetic import sbm_graph_json
from euler_tpu_torch.graph import convert, store
from euler_tpu_torch.graph.store import (AliasTables, default_graph,
                                         initialize_graph, load_graph)
from tests.fixtures import EXT_IDS
from tests.test_torch_graph import native_off


def test_host_lookups_equal_the_reference(toy_dir, toy_graph):
    gt = load_graph(toy_dir, device="cpu")
    ext = [107, 100, 103, 103]
    np.testing.assert_array_equal(gt.local_ids(ext), toy_graph.local_ids(ext))
    assert gt.local_ids(ext).dtype == np.int32
    assert gt.max_id == toy_graph.max_id == len(EXT_IDS) - 1
    nodes = gt.local_ids([100, 105, 102])
    for a, b in zip(gt.get_binary_feature(nodes, ["tag"]),
                    toy_graph.get_binary_feature(nodes, ["tag"])):
        np.testing.assert_array_equal(a, b)
    assert list(gt.get_binary_feature(nodes, ["tag"])[0]) == [
        "n100", "n105", "n102"]
    eids = np.arange(gt.meta.n_edges)[::-1]
    (got,), (want,) = (g.get_edge_binary_feature(eids, ["ebin"])
                       for g in (gt, toy_graph))
    np.testing.assert_array_equal(got, want)
    assert got[-1] == "e100-101"               # edge row 0 of the JSON


def tie_values():
    """f32 values whose low 16 bits sit at and around a bf16 rounding
    tie, with both parities of the kept half, signs, a denormal and
    infinities, then ordinary normals."""
    bits = np.asarray([0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001,
                       0xBF808000, 0xBF818000, 0x00008000, 0x00018000,
                       0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x477F8000],
                      np.uint32).view(np.float32)
    rng = np.random.default_rng(0)
    return np.concatenate([bits, rng.normal(0, 3, 52).astype(np.float32)])


def test_bf16_feature_table_is_bit_equal_to_the_reference(tmp_path):
    vals = tie_values().reshape(8, 8)
    nodes = [{"id": i, "type": "n", "weight": 1.0, "features": [
        {"name": "feature", "type": "dense", "value": vals[i].tolist()}]}
        for i in range(8)]
    edges = [{"src": i, "dst": (i + 1) % 8, "type": "e", "weight": 1.0,
              "features": [{"name": "ew", "type": "dense",
                            "value": vals[i, :3].tolist()}]}
             for i in range(8)]
    d = str(tmp_path / "g")
    convert.convert_json_graph({"nodes": nodes, "edges": edges}, d)
    gj = jax_load_graph(d, feature_dtype=jnp.bfloat16)
    gt = load_graph(d, device="cpu", feature_dtype=torch.bfloat16)
    for tj, tt in ((gj.tensors.dense_nf["feature"],
                    gt.tensors.dense_nf["feature"]),
                   (gj.tensors.dense_ef["ew"], gt.tensors.dense_ef["ew"])):
        assert tt.dtype == torch.bfloat16
        want = np.asarray(tj).view(np.uint16)
        np.testing.assert_array_equal(
            tt.view(torch.int16).numpy().view(np.uint16), want)
    # round to nearest even at the ties: 1.00390625 -> 1.0, 1.01171875 ->
    # 1.015625
    assert gt.tensors.dense_nf["feature"][0, :2].tolist() == [1.0, 1.015625]


def tensors_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        elif isinstance(x, AliasTables):
            tensors_equal(x, y)
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), f.name
            for k in x:
                xs, ys = (x[k], y[k]) if isinstance(x[k], tuple) else \
                    ((x[k],), (y[k],))
                assert all(torch.equal(p, q) for p, q in zip(xs, ys)), k
        else:
            assert x == y or f.name == "meta", f.name


def test_a_multi_partition_load_equals_a_single_partition_load(tmp_path):
    g_json, _, _ = sbm_graph_json(n_nodes=300, feat_dim=8, seed=4)
    for p in (1, 3):
        convert.convert_json_graph(g_json, str(tmp_path / f"p{p}"),
                                   n_partitions=p)
    assert len(list((tmp_path / "p3").glob("part_*.npz"))) == 3
    with native_off(("build_csr_native",)):
        one, three = (load_graph(str(tmp_path / f"p{p}"), device="cpu",
                                 packs=("fan", "group", "sample"))
                      for p in (1, 3))
    tensors_equal(one.tensors, three.tensors)
    np.testing.assert_array_equal(one.ext_ids, three.ext_ids)
    assert three.meta.n_partitions == 3 and one.meta.n_nodes == 300


def test_initialize_and_default_graph(toy_dir, monkeypatch):
    monkeypatch.setattr(store, "_default_graph", None)
    with pytest.raises(RuntimeError, match="initialize_graph"):
        default_graph()
    g = initialize_graph(toy_dir, device="cpu", packs=())
    assert default_graph() is g and g.tensors.fan_pack is None
    g2 = load_graph(toy_dir, device="cpu")
    assert initialize_graph(g2) is g2 and default_graph() is g2
