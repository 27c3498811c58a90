"""The pure helpers of chip_smoke.py, on the CPU: the ids it feeds the
gather, the order in which it times kernels in turns, and how it reads
``nvcc -Xptxas -v``. The phases that need the card run only there."""
import subprocess
import types

import numpy as np
import pytest
import torch

import chip_smoke

# kernel names as nvcc -Xptxas -v prints them for sm_90a
GATHER = ("_ZN47_GLOBAL__N__76f967d3_14_gather_rows_cu_d2b236df18gather_rows_"
          "kernelI5uint4EEvPKT_liPKilPS2_lS2_S2_i")
ROW = ("_ZN44_GLOBAL__N__ea46600b_11_fan_draw_cu_9a03bd8219fan_draw_row_"
       "kernelEPK4int4lPKiliiiPKfS6_iPiPb")


def test_ptxas_report_reads_registers_shared_memory_and_spills(monkeypatch):
    err = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{GATHER}' for 'sm_90a'",
        f"ptxas info    : Function properties for {GATHER}",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 52 registers, used 0 barriers",
        f"ptxas info    : Compiling entry function '{ROW}' for 'sm_90a'",
        f"ptxas info    : Function properties for {ROW}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers, 2048 bytes "
        "smem, 400 bytes cmem[0]",
    ])
    monkeypatch.setattr(subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stderr=err))
    assert chip_smoke.ptxas_report("fan_draw") == {
        GATHER: dict(spill_bytes=12, registers=52, static_smem_bytes=0),
        ROW: dict(spill_bytes=0, registers=32, static_smem_bytes=2048)}


@pytest.mark.parametrize("kind,M", [("mixed", 1), ("mixed", 500),
                                    ("minus1", 40), ("beyond", 40),
                                    ("repeat", 300)])
def test_gather_ids(kind, M):
    N = 100
    ids = chip_smoke.gather_ids(np.random.default_rng(0), M, N,
                                torch.device("cpu"), kind).numpy()
    assert ids.shape == (M,) and ids.dtype == np.int32
    if kind == "mixed":
        assert list(ids[:3]) == [-1, N, N - 1][:M]
        assert ((ids >= -1) & (ids < N + 7)).all()
    elif kind == "minus1":
        assert (ids == -1).all()
    elif kind == "beyond":
        assert ((ids >= N) & (ids < N + 7)).all()
    else:
        assert set(ids) <= set(range(8))


def test_time_in_turns_runs_each_twice_in_mirrored_order(monkeypatch):
    order = []
    monkeypatch.setattr(chip_smoke, "time_launches",
                        lambda fn, iters, flush: fn() or len(order))
    fns = {name: (lambda name=name: order.append(name))
           for name in ("parent", "row", "draw")}
    got = chip_smoke.time_in_turns(fns, 10, None)
    assert order == ["parent", "row", "draw", "draw", "row", "parent"]
    assert got == {"parent": [1, 6], "row": [2, 5], "draw": [3, 4]}


def test_checked_raises_on_a_cuda_error():
    chip_smoke.checked(lambda: 0)()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        chip_smoke.checked(lambda: 1)()


def test_synthetic_union_pack_covers_every_type_and_the_largest_id():
    from euler_tpu_torch.ops.alias import (FAN_ALIAS_OFF, FAN_D,
                                           FAN_KEPT_OFF, FANU_MASK,
                                           FANU_SHIFT)
    packs = chip_smoke.synthetic_union_pack(np.random.default_rng(0), 500)
    lanes = packs[:, FAN_KEPT_OFF:FAN_ALIAS_OFF + FAN_D]
    assert set(np.unique(lanes >> FANU_SHIFT)) == set(range(16))
    assert (lanes & FANU_MASK).max() == FANU_MASK and lanes.min() >= 0
    assert (packs[:, 0] == 0).any() and (packs[:, 0] == FAN_D).any()


@pytest.mark.parametrize("typed", [False, True])
def test_hop_uniforms_and_the_redraw_check_on_each_pack(typed):
    # one uniforms tuple per hop of the flow, (ut, u1, u2) only for a
    # per-type hop; the train phase's redraw check on the pack it redraws
    from euler_tpu_torch import bench
    from euler_tpu_torch.datasets import random_graph
    from euler_tpu_torch.ops import sampling
    g = random_graph(300, 60, num_edge_types=4 if typed else 1,
                     packs=("fanu",) if typed else ("fan",),
                     device="cpu").tensors
    flow = bench.make_model("rgcn" if typed else "sage", "cpu").embedder.flow
    roots = torch.arange(7, dtype=torch.int32)
    u = chip_smoke.hop_uniforms(flow, g, roots, torch.Generator())
    assert [tuple(x.shape) for hop in u for x in hop] == [(7, 25)] * 2 + [
        (7 * 26, 10)] * 2
    pack = chip_smoke.redrawn_pack(g)
    assert pack == ("fanu" if typed else "fan")
    before = getattr(g, f"{pack}_pack").clone()
    sampling.refresh_fan_pack(g, torch.Generator().manual_seed(1))
    got = chip_smoke.check_redraw(before, g, np.random.default_rng(0), pack)
    assert got["reservoir_rows"] > 0 and got["lanes_changed"] > 0.5
    # a lane that no neighbor holds fails the check
    getattr(g, f"{pack}_pack")[getattr(g, f"{pack}_over_rows")[0],
                               chip_smoke.FAN_KEPT_OFF] = -5
    getattr(g, f"{pack}_pack")[getattr(g, f"{pack}_over_rows")[0],
                               chip_smoke.FAN_ALIAS_OFF] = -5
    with pytest.raises(RuntimeError, match="non-neighbor"):
        chip_smoke.check_redraw(before, g, np.random.default_rng(0), pack)


def test_n_params_counts_the_entry_points_of_a_kernel_source():
    # --parent types an older fan_draw entry point by its own count
    src = chip_smoke.os.path.join(chip_smoke.PACKAGE_DIR, "csrc",
                                  "fan_draw.cu")
    assert chip_smoke.n_params(src, "etpu_fan_draw") == 15
    assert chip_smoke.n_params(src, "etpu_fan_draw_path") == 16
    assert chip_smoke.IDS_ONLY_FAN_PARAMS == 15 - 2
