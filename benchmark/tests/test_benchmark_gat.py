"""The ``gat`` configuration on the CPU: ``harness.gat_arith``'s counts
against counts by hand, and ``configs/gat.py``'s check at a size the CPU
holds with the cell's own limits: a sound run is correct; the control
(float8 activations) and each planted fault of ``readings_gat`` fail a
limit; the attention metrics' readers read nothing where no kernel ran."""
import io
import json
import math

import pytest
import torch

from benchmark import readings_gat
from benchmark.harness import drive as drive_lib
from benchmark.harness import gat_arith, runner
from benchmark.tests.conftest import SMALL, write_spec

#: the CPU size: gcn's (30,000 nodes, 2 x 207,000 edges, 16,000 roots, 2
#: steps a loop), 3 layers of 3 heads of 16 (the cell's depth and heads;
#: widths cut for the CPU's memory and time, in this test only). At fewer
#: nodes the sound program's bf16 gaps read past the cell's limits (3,000
#: nodes: first_loss_gap and grad_dir_gap), as fewer nodes average less
GAT_SMALL = {"graph.nodes": 30000, "graph.edges": 207000,
             "train.batch": 16000, "train.steps_per_loop": 2,
             "model.dims": [48, 48, 48]}
#: gat_step_flops of the cell: ogbn-arxiv's N and E, 128 -> 750 x 3, 40
#: classes, the loss over 90,941 roots
FLOPS_AT_THE_CELL = 1_569_871_581_000
ATTN_METRICS = ("attention_ms.train", "attention_bwd_ms.train",
                "ell_attn_roofline", "ell_attn_grad_roofline")


@pytest.fixture(scope="module")
def gat_spec(tmp_path_factory):
    return write_spec(str(tmp_path_factory.mktemp("gat")),
                      dict(SMALL, gat=GAT_SMALL))


def test_gat_step_flops_by_hand():
    # 2 nodes, 3 edges, one layer 1 -> 3 (3 heads of 1), 1 class, 1 root:
    # forward z 2*2*1*3 = 12, el and er 4*2*3 = 24, the sum 2*(3+2)*3 =
    # 30; backward W 12, the transpose and the dot products 60, el's and
    # er's gradients 48; no input gradient (the first layer); the head
    # over 1 root: 3 * (2*1*3*3 + 2*1*3*1) + 2*1*3
    head = 3 * (18 + 6) + 6
    assert gat_arith.gat_step_flops(2, 3, 1, 1, [3], 1, 1) == \
        (12 + 24 + 30) + (12 + 60 + 48) + head
    # a second layer adds its input gradient, 2*2*3*3
    two = gat_arith.gat_step_flops(2, 3, 2, 1, [3, 3], 1, 1)
    one_more = (36 + 24 + 30) + (36 + 60 + 48) + 36
    assert two == (12 + 24 + 30) + (12 + 60 + 48) + one_more + head


def test_gat_counts_at_the_cells_shapes():
    assert gat_arith.gat_step_flops(169_343, 2_332_486, 3, 128, [750] * 3,
                                    40, 90_941) == FLOPS_AT_THE_CELL
    # one call: two [N, 750] bf16 tables, an id an edge, a weight an edge
    # and self loop a head
    assert gat_arith.call_bytes(169_343, 2_332_486, 750, 3, 2) == \
        2 * 169_343 * 750 * 2 + 4 * 2_332_486 + 4 * 3 * (2_332_486 + 169_343)
    assert gat_arith.call_bytes(2, 3, 4, 2, 4) == 2 * 2 * 4 * 4 + 12 + 40


def run(spec, seed=7, seconds=0.3):
    out, err = io.StringIO(), io.StringIO()
    res = runner.run("gat-train", seed, seconds, False, 0.0, device="cpu",
                     spec=spec, look_for_chip=False, out=out, err=err)
    return res, out.getvalue(), err.getvalue()


def test_sound_run_is_correct(gat_spec):
    res, out, err = run(gat_spec)
    assert res["correct"] is True, err
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line["metrics"]) == {"setup_s", "train_step_ms",
                                    "peak_mem_gb"}
    assert set(line["checks"]) == set(gat_spec.limits("gat-train")) | {
        "failed"}
    assert line["attempted"] > 0 and line["failed"] == 0


def test_control_and_every_fault_fail_a_limit(gat_spec):
    row, = readings_gat.read(gat_spec, "gat-train", [11], {11}, "cpu",
                             log=lambda line: None)
    limits = gat_spec.limits("gat-train")
    assert all(row["program"][k] <= v for k, v in limits.items())
    for name in ["control", "fault_state_unchanged"] + list(
            readings_gat.FAULTS):
        assert any(row[name][k] > v for k, v in limits.items()
                   if k in row[name]), name


def test_attention_readers_at_a_cpu_size(gat_spec):
    """On the CPU no kernel runs: the device metrics read None; the step's
    mfu reads a number from the window's step time."""
    w = gat_spec.workload("gat-train")
    cfg, mix = gat_spec.config("gat"), gat_spec.traffic("train")
    system = gat_spec.config_module("gat").build(cfg, 3, "cpu")
    drv = drive_lib.make(gat_spec, mix, system, 3)
    drv.setup()
    ctx = runner.Context(spec=gat_spec, workload=w, cfg=cfg, mix=mix,
                         system=system, drive=drv,
                         window={"metrics": {"train_step_ms": 50.0}},
                         trace=None, device="cpu")
    names = [m["name"] for m in gat_spec.per_layer("gat-train")]
    assert set(ATTN_METRICS) | {"gat_step_mfu.train"} <= set(names)
    for name in ATTN_METRICS:
        assert gat_spec.metric_reader(name).read(ctx) is None, name
    got = ctx.__dict__["_attn_trace"]
    assert set(got["spans"]) == {"attention", "attention.backward"}
    mfu = gat_spec.metric_reader("gat_step_mfu.train").read(ctx)
    assert mfu > 0 and math.isfinite(mfu)


def test_the_check_compares_every_head_and_attention_vector(gat_spec):
    gat = gat_spec.config_module("gat")
    cfg = gat_spec.config("gat")
    shapes = gat.weight_shapes(cfg)
    leaves = gat.per_head({k: torch.zeros(s) for k, s in shapes.items()}, 3)
    for i in range(3):
        assert {f"l{i}.fc.h{k}" for k in range(3)} | {
            f"l{i}.attn_l", f"l{i}.attn_r"} <= set(leaves)
        assert tuple(leaves[f"l{i}.fc.h0"].shape) == (16, 128 if i == 0
                                                       else 48)
    assert set(gat.program_names(cfg).values()) >= {
        "embedder.convs.2.attn_l", "embedder.convs.0.fc.weight"}
