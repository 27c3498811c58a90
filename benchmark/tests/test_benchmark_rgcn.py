"""The ``rgcn`` configuration on the CPU: ``harness.rgcn_arith``'s counts
against counts by hand, the seeded graph's counts, and ``configs/rgcn.py``'s
check at a size the CPU holds with the cell's own limits: a sound run is
correct; the control (float8 activations) and each planted fault of
``readings_rgcn`` fail a limit; the relation metrics' readers read
nothing where no kernel ran."""
import io
import json
import math

import numpy as np
import pytest

from benchmark import readings_rgcn
from benchmark.harness import drive as drive_lib
from benchmark.harness import rgcn_arith, runner
from benchmark.tests.conftest import SMALL, write_spec

#: the CPU size: ogbn-mag's 4 node types and 4 published edge types (7
#: relations) and its Zipf ends, at about 1/200 of its nodes and 1/300 of
#: its edges; the cell's widths cut to 16 (in this test only), 2 steps a
#: loop
EDGE_TYPES = [
    {"name": "affiliated_with", "source": "author", "target": "institution",
     "edges": 4000, "zipf": [0.2, 0.6]},
    {"name": "writes", "source": "author", "target": "paper", "edges": 25000,
     "zipf": [0.4, 0.3]},
    {"name": "cites", "source": "paper", "target": "paper", "edges": 20000,
     "zipf": [0.5, 0.5], "symmetric": True},
    {"name": "has_topic", "source": "paper", "target": "field_of_study",
     "edges": 30000, "zipf": [0.2, 0.6]}]
RGCN_SMALL = {"graph.node_types": [["paper", 3000], ["author", 4000],
                                   ["institution", 60],
                                   ["field_of_study", 200]],
              "graph.edge_types": EDGE_TYPES, "train.batch": 2500,
              "train.steps_per_loop": 2, "model.dims": [16, 16]}
REL_METRICS = ("relation_ms.train", "relation_bwd_ms.train",
               "rel_agg_roofline", "rel_agg_grad_roofline")


@pytest.fixture(scope="module")
def rgcn_spec(tmp_path_factory):
    return write_spec(str(tmp_path_factory.mktemp("rgcn")),
                      dict(SMALL, rgcn=RGCN_SMALL))


def tiny_cfg():
    return {"graph": {"node_types": [["p", 2], ["a", 3]],
                      "edge_types": [{"name": "w", "source": "a",
                                      "target": "p", "edges": 4,
                                      "zipf": [0, 0]},
                                     {"name": "c", "source": "p",
                                      "target": "p", "edges": 1,
                                      "zipf": [0, 0], "symmetric": True}]},
            "model": {"dims": [4]}, "data": {"feature_dim": 2,
                                             "feature_type": "p",
                                             "classes": 1},
            "train": {"batch": 1}}


def test_rgcn_step_flops_by_hand():
    # 2 papers, 3 authors; relations w (into p from a), w's reverse (into a
    # from p), c (p from p); 2 * (4 + 4 + 1) = 10 stored edges... edges
    # count both directions: 2 * (4 + 1) = 10; one layer 2 -> 4:
    # rows: p roots 2 + w's reverse reads p 2 + c reads p 2 = 6 p rows,
    # a roots 3 + w reads a 3 = 6 a rows; forward 2 * 12 * 2 * 4 = 192,
    # sums 2 * 10 * 4 = 80; weight gradients 192; input gradients the
    # tables' type only (a): 2 * 6 * 2 * 4 = 96; transposed sums 80; the
    # head over 1 root: 3 * (2*1*4*4 + 2*1*4*1) + 2*1*4
    head = 3 * (32 + 8) + 8
    assert rgcn_arith.rgcn_step_flops(tiny_cfg()) == \
        192 + 80 + 192 + 96 + 80 + head


def test_rgcn_call_bytes_by_hand():
    # messages 12 rows of 4 (6 p rows less the 2 roots: 4 p, 3 a... the
    # message rows are one a relation and neighbour: w reads 3 a, w's
    # reverse 2 p, c 2 p: 7 rows), f32 roots and output [5, 4], 10 ids,
    # pointers 4 * (5 * 3 + 1)
    ptrs = 4 * 16
    assert rgcn_arith.call_bytes(tiny_cfg(), False, 2) == \
        7 * 4 * 2 + 5 * 4 * 4 + 40 + ptrs + 5 * 4 * 4
    assert rgcn_arith.call_bytes(tiny_cfg(), True, 2) == \
        5 * 4 * 2 + 40 + ptrs + 7 * 4 * 4


def test_the_cell_counts():
    import os
    from benchmark.tests.conftest import REPO
    with open(os.path.join(REPO, "benchmark", "configs", "rgcn.json")) as f:
        cfg = json.load(f)
    assert sum(c for _, c in cfg["graph"]["node_types"]) == 1_939_743
    assert 2 * sum(e["edges"] for e in cfg["graph"]["edge_types"]) == \
        42_222_014
    assert rgcn_arith.rgcn_step_flops(cfg) == 551_550_312_448


def test_the_seeded_graph_is_distinct_and_typed(rgcn_spec):
    cfg = rgcn_spec.config("rgcn")
    mod = rgcn_spec.config_module("rgcn")
    arrays = mod.graph_arrays(cfg["graph"])
    lo = mod.type_lo(cfg["graph"])
    assert len(arrays["src"]) == 2 * sum(e["edges"] for e in EDGE_TYPES)
    keys = (arrays["etype"].astype(np.int64) * lo[-1] + arrays["src"]) \
        * lo[-1] + arrays["dst"]
    assert len(np.unique(keys)) == len(keys)
    assert not ((arrays["src"] == arrays["dst"])
                & (arrays["etype"] == 4)).any()
    for r, (name, k, rev) in enumerate(mod.relations(cfg["graph"])):
        et = cfg["graph"]["edge_types"][k]
        names = [t for t, _ in cfg["graph"]["node_types"]]
        t_type = names.index(et["source"] if rev else et["target"])
        sel = arrays["etype"] == r
        assert (arrays["src"][sel] >= lo[t_type]).all()
        assert (arrays["src"][sel] < lo[t_type + 1]).all()
    again = mod.graph_arrays(cfg["graph"])
    assert np.array_equal(again["dst"], arrays["dst"])


def run(spec, seed=7, seconds=0.3):
    out, err = io.StringIO(), io.StringIO()
    res = runner.run("rgcn-train", seed, seconds, False, 0.0, device="cpu",
                     spec=spec, look_for_chip=False, out=out, err=err)
    return res, out.getvalue(), err.getvalue()


def test_sound_run_is_correct(rgcn_spec, capsys):
    res, out, err = run(rgcn_spec, seed=2 ** 31 + 17)
    assert res["correct"] is True, err
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line["metrics"]) == {"setup_s", "train_step_ms",
                                    "peak_mem_gb"}
    assert set(line["checks"]) == set(rgcn_spec.limits("rgcn-train")) | {
        "failed"}
    assert "degrees: affiliated_with (4000 edges)" in capsys.readouterr().err


def test_control_and_every_fault_fail_a_limit(rgcn_spec):
    row, = readings_rgcn.read(rgcn_spec, "rgcn-train", [11], {11}, "cpu",
                              log=lambda line: None)
    limits = rgcn_spec.limits("rgcn-train")
    assert all(row["program"][k] <= v for k, v in limits.items())
    for name in ["control", "fault_state_unchanged"] + list(
            readings_rgcn.FAULTS):
        assert any(row[name][k] > v for k, v in limits.items()
                   if k in row[name]), name


def test_relation_readers_at_a_cpu_size(rgcn_spec):
    """On the CPU no kernel runs: the kernel metrics read None, the span
    metrics a time; the step's mfu reads a number from the window's step
    time."""
    w = rgcn_spec.workload("rgcn-train")
    cfg, mix = rgcn_spec.config("rgcn"), rgcn_spec.traffic("train")
    system = rgcn_spec.config_module("rgcn").build(cfg, 3, "cpu")
    drv = drive_lib.make(rgcn_spec, mix, system, 3)
    drv.setup()
    ctx = runner.Context(spec=rgcn_spec, workload=w, cfg=cfg, mix=mix,
                         system=system, drive=drv,
                         window={"metrics": {"train_step_ms": 50.0}},
                         trace=None, device="cpu")
    names = [m["name"] for m in rgcn_spec.per_layer("rgcn-train")]
    assert set(REL_METRICS) | {"rgcn_step_mfu.train"} <= set(names)
    for name in ("rel_agg_roofline", "rel_agg_grad_roofline"):
        assert rgcn_spec.metric_reader(name).read(ctx) is None, name
    got = ctx.__dict__["_rel_trace"]
    assert set(got["spans"]) == {"relation", "relation.backward"}
    mfu = rgcn_spec.metric_reader("rgcn_step_mfu.train").read(ctx)
    assert mfu > 0 and math.isfinite(mfu)


def test_the_check_compares_every_relation_root_and_table(rgcn_spec):
    mod = rgcn_spec.config_module("rgcn")
    cfg = rgcn_spec.config("rgcn")
    import torch
    shapes = mod.weight_shapes(cfg)
    leaves = mod.per_leaf({k: torch.zeros(s) for k, s in shapes.items()},
                          cfg)
    rels = [name for name, _, _ in mod.relations(cfg["graph"])]
    assert len(rels) == 7 and rels[1] == "institution_to_author"
    for i in range(2):
        assert {f"l{i}.rel.{r}" for r in rels} | {
            f"l{i}.root.paper", f"l{i}.root_b.field_of_study"} <= set(leaves)
    assert {"emb.author", "emb.institution", "emb.field_of_study"} <= set(
        leaves)
    assert set(mod.program_names(cfg).values()) >= {
        "embedder.feature.emb.author", "embedder.convs.1.root_bias"}
