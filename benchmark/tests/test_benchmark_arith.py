"""The yardstick's counts against counts by hand at small shapes, and the
trace reduction on intervals laid out by hand."""
import torch

from benchmark.harness import arith, trace
from benchmark.harness.drive import percentile


def test_sage_step_flops_by_hand():
    # batch 1, fanouts [1, 1], widths 1: sizes 1, 2, 4.
    # layer 0 (2 targets, f 1): mean 2*2*1 adds + 2 divides = 6, two
    #   linears 2 * (2*2*1*1) = 8; weight gradients 8
    # layer 1 (1 target, f 1): mean 3, linears 4; weight gradients 4,
    #   input gradients 4 + 3
    # head: out_fc 2 + label 2 = 4, times 3, + bias 1 forward, 1 backward
    assert arith.sage_step_flops(1, [1, 1], 1, [1, 1], 1) == \
        (6 + 8 + 3 + 4) + (8 + 4) + (4 + 3) + (3 * 4 + 2)


def test_gcn_step_flops_by_hand():
    # 2 nodes, 3 edges, one layer of width 1: the sum 2*(3+2)*1 = 10, the
    # linear 2*2*1*1 = 4 and its weight gradient 4; the head 3*(4+4) + 4
    assert arith.gcn_step_flops(2, 3, 1, 1, [1], 1) == 10 + 4 + 4 + 28


def test_gcn_head_runs_over_the_roots_by_hand():
    # as above with 1 root: the head 3*(2+2) + 2
    assert arith.gcn_step_flops(2, 3, 1, 1, [1], 1, roots=1) == \
        10 + 4 + 4 + 14


def test_step_flops_at_the_cells_shapes():
    assert arith.sage_step_flops(1024, [25, 10], 128, [128, 128], 16) \
        == 3_852_468_224
    assert arith.gcn_step_flops(169_343, 2_332_486, 3, 128, [256] * 3, 40,
                                roots=90_941) == 202_530_526_976


def test_draw_bytes_by_hand():
    nodes = torch.tensor([0, -1])
    u1 = torch.tensor([[0.1, 0.9], [0.5, 0.5]])
    out_deg = torch.tensor([4, 7])
    # 2x2 draws of 13 B, 2 nodes of 4 B, one live row of 8 B, cells
    # (0, 0) and (0, 3) of 8 B each
    assert arith.draw_bytes(nodes, u1, out_deg) == 52 + 8 + 8 + 16


def test_gather_bytes_by_hand():
    ids = torch.tensor([1, 1, 2, -1, 12])
    # rows 1 and 2 read, 5 rows written, 5 ids read
    assert arith.gather_bytes(10, 8, ids) == 2 * 8 + 5 * 8 + 5 * 4


def test_aggregate_bytes_by_hand():
    # table and output 3x2 of 2 B, 5 ids, 5 + 3 weights
    assert arith.aggregate_bytes(3, 5, 2, 2) == 12 + 12 + 20 + 32


def test_reduce_events_union_and_gaps():
    dev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a")]
    cpu = [(0, 50, "loop"), (19, 28, "sync")]
    out = trace.reduce_events(dev, cpu, 0, 50)
    assert out["busy_s"] == 30e-6 and out["window_s"] == 50e-6
    assert out["device_ops"] == [["a", 20e-6], ["b", 15e-6]]
    # the gap at 20 falls inside "sync" (the innermost open op), the gap
    # at 40 inside "loop" only
    assert out["idle_gaps"] == [["sync", 10e-6], ["loop", 10e-6]]
    assert out["kernels"] == 3


def test_reduce_events_clips_to_the_window_and_counts_copies_apart():
    dev = [(-5, 5, "Memcpy HtoD"), (8, 12, "k")]
    out = trace.reduce_events(dev, [], 0, 10)
    assert out["busy_s"] == 7e-6
    assert out["kernels"] == 1
    assert out["idle_gaps"] == [["host idle", 3e-6]]


def test_percentile_nearest_rank():
    values = list(range(1, 101))
    assert percentile(values, 95) == 95
    assert percentile(values, 50) == 50
    assert percentile([3.0], 95) == 3.0
