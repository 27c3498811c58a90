"""The streaming converter of the PyTorch port against euler_tpu's: the
NDJSON and edge-list front ends and ``StreamWriter`` itself write
``meta.json`` byte for byte as the reference does and every
``part_*.npz`` array equal in name, dtype and value (1 and 3
partitions, dense and sparse features); the edge-list parse gives the
same output on its native and its Python path; a streamed graph loads as
the bulk converter's does; peak host memory stays bounded; the CLI runs.
"""
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

from euler_tpu.graph import stream_convert as jax_stream
from euler_tpu_torch.graph import convert, stream_convert
from euler_tpu_torch.graph.store import load_graph
from euler_tpu_torch.native import loader as native
from tests.test_torch_convert import assert_dirs_equal


def random_json_graph(n=60, m=400, seed=0):
    """tests/test_stream_convert.py's graph: dense ids, two node types,
    two edge types, dense and sparse node features, a dense edge
    feature."""
    rng = np.random.default_rng(seed)
    nodes = [{"id": i, "type": "a" if i % 3 else "b",
              "weight": float(rng.integers(1, 5)),
              "features": [
                  {"name": "f", "type": "dense",
                   "value": [float(i), float(i) * 0.5]},
                  {"name": "sp", "type": "sparse",
                   "value": [int(x) for x in rng.integers(0, 50, 3)]}]}
             for i in range(n)]
    edges = [{"src": int(rng.integers(0, n)), "dst": int(rng.integers(0, n)),
              "type": "e" + str(int(rng.integers(0, 2))),
              "weight": float(rng.integers(1, 4)),
              "features": [{"name": "ef", "type": "dense",
                            "value": [float(k)]}]}
             for k in range(m)]
    return {"nodes": nodes, "edges": edges}


def write_ndjson(path, g, edges_first=False):
    recs = g["edges"] + g["nodes"] if edges_first else g["nodes"] + g["edges"]
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n\n")        # blank lines are skipped


@pytest.mark.parametrize("parts,chunk,edges_first",
                         [(1, 100_000, False), (3, 37, False), (2, 50, True)])
def test_ndjson_writes_the_reference_output(tmp_path, parts, chunk,
                                            edges_first):
    src = tmp_path / "g.ndjson"
    write_ndjson(src, random_json_graph(seed=parts), edges_first)
    got, want = tmp_path / "port", tmp_path / "ref"
    for d in (got, want):
        os.makedirs(d)
    meta = stream_convert.convert_ndjson(str(src), str(got), parts,
                                         chunk_size=chunk)
    jax_stream.convert_ndjson(str(src), str(want), parts, chunk_size=chunk)
    assert_dirs_equal(str(got), str(want))
    assert meta.n_nodes == 60 and meta.n_edges == 400
    assert not os.path.exists(got / "_stream_tmp")


def test_ndjson_stream_matches_bulk_converter(tmp_path):
    g = random_json_graph()
    bulk = tmp_path / "bulk"
    convert.convert_json_graph(g, str(bulk), n_partitions=2)
    nd = tmp_path / "g.ndjson"
    write_ndjson(nd, g)
    streamed = tmp_path / "streamed"
    os.makedirs(streamed)
    stream_convert.convert_ndjson(str(nd), str(streamed), n_partitions=2,
                                  chunk_size=37)
    gb = load_graph(str(bulk), device="cpu").tensors
    gs = load_graph(str(streamed), device="cpu").tensors
    assert (gb.meta.n_nodes, gb.meta.n_edges, gb.meta.node_types) == \
        (gs.meta.n_nodes, gs.meta.n_edges, gs.meta.node_types)
    for name in ("node_type", "group_ptr", "group_w_sum"):
        assert torch.equal(getattr(gb, name), getattr(gs, name)), name
    # the same multiset of neighbors; the CSR tie order among duplicate
    # (src, etype, dst) edges may differ between converters
    assert torch.equal(gb.adj_dst.sort().values, gs.adj_dst.sort().values)
    assert torch.equal(gb.dense_nf["f"], gs.dense_nf["f"])
    assert torch.equal(gb.sparse_nf["sp"][0], gs.sparse_nf["sp"][0])
    assert torch.equal(gb.dense_ef["ef"], gs.dense_ef["ef"])


EDGE_LINES = ("# a comment\n"
              "0\t1\t2.0\n1 2\n  # indented comment\n2\t3\t0.5\n"
              "3\t0\n\nnot an edge\n7\tx\t1\n0\t2\t4.25\n"
              "5 9 1.5\n9\t5\n4\t4\t3")             # no newline at the end


@pytest.fixture
def edge_list(tmp_path):
    p = tmp_path / "el.txt"
    p.write_text(EDGE_LINES)
    return p


def no_native(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)


@pytest.mark.parametrize("parts", [1, 3])
def test_edge_list_native_and_python_paths_agree(tmp_path, edge_list,
                                                 monkeypatch, parts):
    assert native.get_lib() is not None          # the native parse runs
    outs = {}
    for path in ("native", "python", "ref"):
        out = tmp_path / path
        os.makedirs(out)
        if path == "ref":
            jax_stream.convert_edge_list(str(edge_list), str(out), parts)
        else:
            if path == "python":
                no_native(monkeypatch)
            meta = stream_convert.convert_edge_list(str(edge_list), str(out),
                                                    parts, chunk_size=3)
            assert meta.n_nodes == 10 and meta.n_edges == 8
        outs[path] = str(out)
    assert_dirs_equal(outs["native"], outs["python"])
    assert_dirs_equal(outs["native"], outs["ref"])
    g = load_graph(outs["native"], device="cpu")
    w = g.tensors.adj_w[g.tensors.adj_src == 0]
    assert sorted(w.tolist()) == [2.0, 4.25]


def test_native_parse_skips_as_the_python_loop(edge_list):
    s, d, w = native.parse_edge_list_native(edge_list.read_bytes() + b"\n")
    assert s.tolist() == [0, 1, 2, 3, 0, 5, 9, 4]
    assert d.tolist() == [1, 2, 3, 0, 2, 9, 5, 4]
    assert w.tolist() == [2.0, 1.0, 0.5, 1.0, 4.25, 1.5, 1.0, 3.0]


def test_stream_writer_writes_the_reference_output(tmp_path):
    outs = []
    for mod in (stream_convert, jax_stream):
        out = tmp_path / mod.__name__
        os.makedirs(out)
        r = np.random.default_rng(5)
        w = mod.StreamWriter(str(out), n_partitions=3, directed=False)
        for lo in (0, 25):
            ids = np.arange(lo, lo + 25)
            w.add_nodes(ids, ["u", "i"] * 12 + ["u"],
                        r.random(25).astype(np.float32),
                        dense={"x": r.normal(size=(25, 4))},
                        sparse={"s": (r.integers(-1, 9, (25, 2)),
                                      r.integers(0, 3, 25))})
        for _ in range(3):
            w.add_edges(r.integers(0, 50, 40), r.integers(0, 50, 40),
                        "rate" if _ else "buy", r.random(40),
                        dense={"ew": r.normal(size=(40, 2))})
        with pytest.raises(ValueError, match="specs changed"):
            w.add_edges([0], [1], "rate", dense={"ew": np.zeros((1, 3))})
        meta = w.finalize()
        with pytest.raises(RuntimeError, match="twice"):
            w.finalize()
        outs.append(str(out))
        assert meta.node_types == ("i", "u") and meta.edge_types == (
            "buy", "rate")
    assert_dirs_equal(*outs)


def test_stream_writer_bounded_memory(tmp_path):
    """Peak host memory stays O(chunk + largest partition), far below the
    whole graph (tests/test_stream_convert.py's case)."""
    out = tmp_path / "big"
    os.makedirs(out)
    n, m, chunk, P = 400_000, 2_000_000, 100_000, 8
    rng = np.random.default_rng(0)
    tracemalloc.start()
    w = stream_convert.StreamWriter(str(out), n_partitions=P,
                                    build_in_edges=False)
    for lo in range(0, m, chunk):
        c = min(chunk, m - lo)
        w.add_edges(rng.integers(0, n, c), rng.integers(0, n, c),
                    weights=np.ones(c, np.float32))
    w.finalize()
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    # the whole graph is about 2M * 5 columns * 4 B = 40 MB
    assert peak < 20 * 2 ** 20, f"peak {peak / 2 ** 20:.1f} MiB"
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.loads(f.read())
    assert meta["n_edges"] == m and meta["n_nodes"] == n


def test_stream_cli(tmp_path, edge_list, capsys):
    nd = tmp_path / "g.ndjson"
    write_ndjson(nd, random_json_graph(seed=4))
    for src, fmt in ((nd, []), (edge_list, ["--format", "edgelist"])):
        got, want = tmp_path / f"p{src.name}", tmp_path / f"r{src.name}"
        for d in (got, want):
            os.makedirs(d)
        argv = ["--partitions", "2", "--chunk-size", "5", "--no-in-edges"]
        meta = stream_convert.main([str(src), str(got)] + argv + fmt)
        jax_stream.main([str(src), str(want)] + argv + fmt)
        assert_dirs_equal(str(got), str(want))
        assert not meta.has_in_edges
    assert "[euler_tpu_torch] stream-converted" in capsys.readouterr().out
