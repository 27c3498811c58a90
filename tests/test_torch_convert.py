"""The JSON converter of the PyTorch port against euler_tpu's: on graphs
the tests write themselves (dense, sparse and binary node and edge
features, int and str type names, 1 and 3 partitions, with and without
``hash_buckets``), the port writes ``meta.json`` byte for byte as the
reference does and every ``part_*.npz`` array equal in name, dtype and
value; the port's ``load_graph`` of its own output equals its load of
the reference's. The CLI runs.
"""
import json
import os

import numpy as np
import pytest

from euler_tpu.graph import convert as jax_convert
from euler_tpu_torch.graph import convert
from euler_tpu_torch.graph.store import load_graph
from tests.fixtures import toy_graph_json
from tests.test_torch_store_rest import tensors_equal


def assert_dirs_equal(got: str, want: str):
    """meta.json byte for byte, the same part files, each array equal in
    name, dtype and value."""
    with open(os.path.join(got, "meta.json"), "rb") as f, \
            open(os.path.join(want, "meta.json"), "rb") as g:
        assert f.read() == g.read()
    parts = sorted(p for p in os.listdir(want) if p.startswith("part_"))
    assert sorted(p for p in os.listdir(got) if p.startswith("part_")) \
        == parts and parts
    for p in parts:
        with np.load(os.path.join(got, p)) as a, \
                np.load(os.path.join(want, p)) as b:
            assert sorted(a.files) == sorted(b.files), p
            for k in b.files:
                assert a[k].dtype == b[k].dtype, (p, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{p} {k}")


def feature_graph(n=40, m=160, seed=0, big_ids=False):
    """A random graph with every feature kind on nodes and edges, int
    node types and str edge types, ragged dense and sparse values."""
    rng = np.random.default_rng(seed)
    scale = 2 ** 33 if big_ids else 1000
    ext = rng.choice(10 ** 6, n, replace=False) * 7 + 3
    nodes = [{"id": int(e), "type": int(rng.integers(0, 3)),
              "weight": float(rng.integers(1, 9)) / 4,
              "features": [
                  {"name": "f", "type": "dense",
                   "value": rng.normal(size=int(rng.integers(1, 4))).tolist()},
                  {"name": "sp", "type": "sparse",
                   "value": [int(x) for x in
                             rng.integers(0, scale, int(rng.integers(0, 4)))]},
                  {"name": "tag", "type": "binary", "value": f"t{e % 13}"}]}
             for e in ext]
    edges = [{"src": int(rng.choice(ext)), "dst": int(rng.choice(ext)),
              "type": ["buy", "click", "view"][int(rng.integers(0, 3))],
              "weight": float(rng.integers(1, 5)),
              "features": [
                  {"name": "ef", "type": "dense", "value": [float(k), 0.5]},
                  {"name": "esp", "type": "sparse",
                   "value": [int(rng.integers(0, scale))]},
                  {"name": "eb", "type": "binary", "value": f"e{k}"}]}
             for k in range(m)]
    return {"nodes": nodes, "edges": edges}


CASES = [
    ("toy", dict(n_partitions=1)),
    ("toy", dict(n_partitions=3, directed=False)),
    ("features", dict(n_partitions=1)),
    ("features", dict(n_partitions=3, build_in_edges=False)),
    ("features", dict(n_partitions=3, hash_buckets=7)),
    ("big_ids", dict(n_partitions=2, hash_buckets=1009)),
]


@pytest.mark.parametrize("graph,kw", CASES,
                         ids=[f"{g}-{i}" for i, (g, _) in enumerate(CASES)])
def test_json_converter_writes_the_reference_output(tmp_path, graph, kw):
    g = toy_graph_json() if graph == "toy" else feature_graph(
        big_ids=graph == "big_ids")
    got, want = str(tmp_path / "port"), str(tmp_path / "ref")
    meta = convert.convert_json_graph(g, got, **kw)
    jax_convert.convert_json_graph(g, want, **kw)
    assert_dirs_equal(got, want)
    assert meta.n_partitions == kw["n_partitions"]
    assert sum(meta.part_edge_counts) == len(g["edges"])
    tensors_equal(load_graph(got, device="cpu", packs=("fan", "sample")
                             ).tensors,
                  load_graph(want, device="cpu", packs=("fan", "sample")
                             ).tensors)


def test_sparse_ids_past_int32_need_hash_buckets(tmp_path):
    g = feature_graph(big_ids=True)
    for fn in (convert.convert_json_graph, jax_convert.convert_json_graph):
        with pytest.raises(ValueError, match="hash_buckets"):
            fn(g, str(tmp_path / fn.__module__))


def test_mixed_feature_kinds_raise():
    items = [{"features": [{"name": "x", "type": "dense", "value": [1.0]}]},
             {"features": [{"name": "x", "type": "sparse", "value": [1]}]}]
    with pytest.raises(ValueError, match="mixed kinds"):
        convert._collect_feature_specs(items)


def test_convert_file_and_cli(tmp_path, capsys):
    src = tmp_path / "g.json"
    src.write_text(json.dumps(feature_graph(seed=3)))
    got, want = str(tmp_path / "port"), str(tmp_path / "ref")
    meta = convert.main([str(src), got, "2", "--hash-buckets", "11",
                         "--no-in-edges"])
    jax_convert.main([str(src), want, "2", "--hash-buckets", "11",
                      "--no-in-edges"])
    assert_dirs_equal(got, want)
    assert meta.n_partitions == 2 and not meta.has_in_edges
    assert "[euler_tpu_torch] converted" in capsys.readouterr().out
    again = str(tmp_path / "file")
    convert.convert_json_file(str(src), again, n_partitions=2,
                              hash_buckets=11, build_in_edges=False)
    assert_dirs_equal(again, want)
