"""The dataset registry and the synthetic stand-ins of the PyTorch port
against euler_tpu's: each of the ten named datasets' parsers, on raw
files written as tests/test_datasets_raw.py writes them, converts to the
reference's output (``meta.json`` byte for byte, every ``part_*.npz``
array equal) and sets the same contract attributes (``feature_dim``,
``label_dim``, ``total_size``, ``test_ids``, ``test_triples``, ...); the
stand-ins, generated where no raw files are present, equal the
reference's within one process (they are seeded with
``abs(hash(name))``, which Python salts per process).
"""
import json

import numpy as np
import pytest

from euler_tpu.datasets import registry as jax_registry
from euler_tpu.datasets import synthetic as jax_synthetic
from euler_tpu_torch.datasets import (MotifDataset, SBMDataset, get_dataset,
                                      motif_graph, registry, synthetic)
from tests.test_torch_convert import assert_dirs_equal
from tests.test_torch_store_rest import tensors_equal


def write_cora_like(raw, name, n=30, n_feat=8):
    rng = np.random.default_rng(0)
    lines = ["\t".join([f"p{i}"] + [str(v) for v in rng.integers(0, 2,
                                                                 n_feat)]
                       + [f"class{i % 3}"]) for i in range(n)]
    (raw / f"{name}.content").write_text("\n".join(lines) + "\n")
    cites = [f"p{rng.integers(0, n)}\tp{rng.integers(0, n)}"
             for _ in range(80)] + ["p1\tunknown", "bad line here"]
    (raw / f"{name}.cites").write_text("\n".join(cites) + "\n")


def write_pubmed(raw):
    d = raw / "data"
    d.mkdir()
    (d / "Pubmed-Diabetes.DIRECTED.cites.tab").write_text(
        "DIRECTED\nNO_FEATURES\n"
        "0\tpaper:p1\t|\tpaper:p2\n"
        "1\tpaper:p2\t|\tpaper:p3\n"
        "2\tpaper:p4\t|\tpaper:p1\n")
    (d / "Pubmed-Diabetes.NODE.paper.tab").write_text(
        "HEADER\ncat=1,2,3\tnumeric:w-a:0.0\tnumeric:w-b:0.0\t"
        "numeric:w-c:0.0\tstring:summary:\n"
        "p1\tlabel=1\tw-a=0.5\tw-b=0.5\tsummary=x\n"
        "p2\tlabel=2\tw-b=1.0\tsummary=x\n"
        "p3\tlabel=3\tw-c=2.0\tsummary=x\n"
        "p4\tlabel=1\tw-a=1.0\tw-c=1.0\tsummary=x\n"
        "p5\tlabel=2\tw-a=3.0\tsummary=x\n")


def write_node_link(raw, prefix, class_map, ids):
    G = {"nodes": [{"id": ids[0], "test": False, "val": False},
                   {"id": ids[1]},
                   {"id": ids[2], "test": True, "val": False},
                   {"id": ids[3], "test": False, "val": True},
                   {"id": ids[4]}],
         "links": [{"source": 0, "target": 1}, {"source": 1, "target": 2},
                   {"source": 0, "target": 3}, {"source": 4, "target": 1}]}
    (raw / f"{prefix}-G.json").write_text(json.dumps(G))
    np.save(raw / f"{prefix}-feats.npy",
            np.arange(15, dtype=np.float32).reshape(5, 3) ** 1.5)
    (raw / f"{prefix}-id_map.json").write_text(
        json.dumps({str(k): i for i, k in enumerate(ids)}))
    (raw / f"{prefix}-class_map.json").write_text(
        json.dumps({str(k): class_map(i) for i, k in enumerate(ids)}))


def write_mutag(raw):
    (raw / "MUTAG_A.txt").write_text("1, 2\n2, 3\n3, 1\n4, 5\n5, 6\n6, 4\n"
                                     "7, 8\n")
    (raw / "MUTAG_graph_indicator.txt").write_text(
        "1\n1\n1\n2\n2\n2\n3\n3\n")
    (raw / "MUTAG_graph_labels.txt").write_text("1\n-1\n1\n")
    (raw / "MUTAG_node_labels.txt").write_text("0\n1\n2\n0\n1\n6\n3\n3\n")


def write_triples(raw):
    rng = np.random.default_rng(1)
    for split, m in (("train", 60), ("valid", 10), ("test", 12)):
        rows = [f"e{rng.integers(0, 20)}\tr{rng.integers(0, 4)}\t"
                f"e{rng.integers(0, 20)}" for _ in range(m)]
        (raw / f"{split}.txt").write_text("\n".join(rows + ["x\ty"]) + "\n")


def write_ml1m(raw):
    rng = np.random.default_rng(2)
    rows = [f"{rng.integers(1, 9)}::{rng.integers(1, 13)}::"
            f"{rng.integers(1, 6)}::97830{i}" for i in range(50)]
    (raw / "ratings.dat").write_text("\n".join(rows + ["junk"]) + "\n",
                                     encoding="latin-1")


RAW = {
    "cora": lambda r: write_cora_like(r, "cora"),
    "citeseer": lambda r: write_cora_like(r, "citeseer", n=25, n_feat=5),
    "pubmed": write_pubmed,
    "ppi": lambda r: write_node_link(r, "ppi",
                                     lambda i: [i % 2, 1 - i % 2, 1],
                                     [0, 1, 2, 3, 4]),
    "reddit": lambda r: write_node_link(r, "reddit", lambda i: i % 4,
                                        ["n0", "n1", "n2", "n3", "n4"]),
    "mutag": write_mutag,
    "fb15k": write_triples,
    "fb15k237": write_triples,
    "wn18": write_triples,
    "ml_1m": write_ml1m,
}

CONTRACT = ("feature_dim", "label_dim", "total_size", "max_node_id",
            "num_classes", "train_node_type", "all_node_type",
            "train_edge_type", "all_edge_type", "feature_idx", "label_idx",
            "n_relations")


def dataset_pair(tmp_path, name, raw=True, **tweak):
    """(port dataset, reference dataset) of ``name`` over separate roots,
    each converted and loaded (the port's on the CPU)."""
    out = []
    for side, reg in (("port", registry), ("ref", jax_registry)):
        root = tmp_path / side
        if raw:
            (root / name).mkdir(parents=True)
            RAW[name](root / name)
        ds = reg.get_dataset(name, str(root))
        for k, v in tweak.items():
            setattr(ds, k, v)
        assert ds.has_raw() == raw
        g = ds.load_graph(device="cpu") if side == "port" else ds.load_graph()
        out.append((ds, g))
    return out


def assert_contract_equal(dt, dj):
    for attr in CONTRACT:
        assert getattr(dt, attr, None) == getattr(dj, attr, None), attr
    np.testing.assert_array_equal(dt.test_ids, dj.test_ids)
    if hasattr(dj, "test_triples"):
        np.testing.assert_array_equal(dt.test_triples, dj.test_triples)


@pytest.mark.parametrize("name", sorted(RAW))
def test_raw_parser_matches_the_reference(tmp_path, name):
    tweak = {"test_start_num": 2} if name == "pubmed" else \
        {"label_dim": 4} if name == "reddit" else {}
    (dt, gt), (dj, gj) = dataset_pair(tmp_path, name, **tweak)
    assert_dirs_equal(dt.data_dir, dj.data_dir)
    assert_contract_equal(dt, dj)
    assert gt.meta.n_nodes == gj.meta.n_nodes > 0
    if name == "mutag":
        assert dt.total_size == 3 and dt.test_ids.tolist() == [2]


@pytest.mark.parametrize("name", sorted(RAW))
def test_stand_in_matches_the_reference_in_one_process(tmp_path, name):
    (dt, gt), (dj, gj) = dataset_pair(tmp_path, name, raw=False)
    assert_dirs_equal(dt.data_dir, dj.data_dir)
    assert_contract_equal(dt, dj)
    assert gt.meta.n_edges == gj.meta.n_edges > 0


def test_sbm_and_motif_datasets_match_the_reference(tmp_path):
    for cls, jcls, kw in ((SBMDataset, jax_synthetic.SBMDataset,
                           dict(n_nodes=300, n_classes=3, feat_dim=8,
                                seed=5, p_in=0.1)),
                          (MotifDataset, jax_synthetic.MotifDataset,
                           dict(n_graphs=12, seed=2))):
        dt = cls(str(tmp_path / "port"), **kw)
        dj = jcls(str(tmp_path / "ref"), **kw)
        gt, gj = dt.load_graph(device="cpu"), dj.load_graph()
        assert_dirs_equal(dt.data_dir, dj.data_dir)
        if cls is SBMDataset:
            np.testing.assert_array_equal(dt.test_ids, dj.test_ids)
            assert (dt.label_dim, dt.feature_dim) == (3, 8)
            sbm_ids = dj.test_ids
        assert gt.meta.n_nodes == gj.meta.n_nodes
    # a fresh object over the converted directory reads the same ids
    np.testing.assert_array_equal(
        SBMDataset(str(tmp_path / "port"), n_nodes=300, n_classes=3,
                   feat_dim=8, seed=5).test_ids, sbm_ids)


def test_motif_graph_in_memory_equals_the_motif_dataset(tmp_path):
    ds = MotifDataset(str(tmp_path), n_graphs=14, seed=4)
    tensors_equal(ds.load_graph(device="cpu", packs=("fan",)).tensors,
                  motif_graph(14, seed=4, device="cpu").tensors)
    assert synthetic.motif_graphs_json(3, seed=0) == \
        jax_synthetic.motif_graphs_json(3, seed=0)


def test_get_dataset_names(tmp_path):
    assert isinstance(get_dataset("sbm", str(tmp_path)), SBMDataset)
    assert type(get_dataset("wn18", str(tmp_path))).__name__ == "WN18"
    with pytest.raises(KeyError, match="unknown dataset"):
        get_dataset("imagenet", str(tmp_path))
