"""The scaling bench and the ingest drill over gloo ranks on the CPU,
held against the reference's tools.

- ``tools.scaling_bench`` at ``1x4`` against tools/scaling_bench.py on
  the conftest's 8-device virtual CPU mesh, same nodes, batch, fanouts
  and feat-dim: the port's forward bytes a step by collective equal one
  step's of the reference, byte for byte, on every rank. The reference
  counts each collective when it traces it, and its ``train`` traces the
  step (and the forward inside it) more than once, so its events are
  copies of one step's forward and gradient-sync blocks; the test checks
  that they are and compares one of each. A request for NCCL past the
  cards raises.
- ``tools.ingest_drill``: ``gen_edge_file`` writes the reference's bytes
  for the same seed and sizes; the drill at 20,000 edges over 2 shards
  writes a record with every key and stage of the reference's and a
  finite loss, and each shard file its ranks load equals
  ``build_sharded`` of the same graph with the same ``feat`` table,
  array by array.
"""
import contextlib
import importlib.util
import math
import os
import tempfile

import numpy as np
import pytest

from euler_tpu_torch.graph.store import load_graph
from euler_tpu_torch.parallel import sharded
from euler_tpu_torch.tools import ingest_drill, scaling_bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = ["--nodes", "400", "--batch-per-dev", "8", "--fanouts", "3", "2",
         "--feat-dim", "8", "--shapes", "1x4"]


def reference_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_events(tmp_path, monkeypatch):
    """The reference scaling bench's accounted events at SHAPE, and its
    printed record."""
    from euler_tpu.estimator import estimator as jax_estimator
    from euler_tpu.parallel import comms as jax_comms
    ref = reference_tool("scaling_bench")
    accs = []
    account = jax_comms.account

    @contextlib.contextmanager
    def keep():
        with account() as acc:
            accs.append(acc)
            yield acc

    run_config = jax_estimator.RunConfig
    monkeypatch.setattr(jax_comms, "account", keep)
    # its graph and checkpoints under tmp_path, not /tmp
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    monkeypatch.setattr(jax_estimator, "RunConfig", lambda **kw: run_config(
        **dict(kw, model_dir=str(tmp_path / "ckpt"))))
    (rec,) = ref.main(SHAPE + ["--steps", "2", "--platform", "cpu"])
    (acc,) = accs
    return acc.events, rec


def one_step(events):
    """One step's events from the reference's: its last forward block
    (the collectives since the previous gradient sync) and last sync
    block (the trailing pmeans); every event of the list must belong to
    a copy of one of the two blocks."""
    kinds = [e[0] for e in events]
    end = len(kinds)
    sync_at = end
    while sync_at > 0 and kinds[sync_at - 1] == "pmean":
        sync_at -= 1
    fwd_at = sync_at
    while fwd_at > 0 and kinds[fwd_at - 1] != "pmean":
        fwd_at -= 1
    fwd, sync = events[fwd_at:sync_at], events[sync_at:]
    assert fwd and sync
    i = 0
    while i < end:
        for block in (fwd, sync):
            if events[i:i + len(block)] == block:
                i += len(block)
                break
        else:
            raise AssertionError(f"event {i} {events[i]} is in no copy of "
                                 f"the step's blocks")
    out = {}
    for kind, _axis, nbytes in fwd + sync:
        out[kind] = out.get(kind, 0) + nbytes
    return out


def test_scaling_bench_forward_bytes_equal_the_reference(tmp_path,
                                                         monkeypatch):
    events, ref_rec = reference_events(tmp_path, monkeypatch)
    want = one_step(events)
    S, count = 4, 8 * 4            # the graph group's draw of b * S roots
    want["all_gather"] += (S - 1) * (2 * 4 * count - 8)
    (res,) = scaling_bench.sweep(scaling_bench.parse(
        SHAPE + ["--steps", "2", "--device", "cpu"]))
    rec, ranks = res["record"], res["ranks"]
    assert set(ref_rec) <= set(rec)
    assert (rec["mesh"], rec["devices"], rec["platform"]) == ("1x4", 4,
                                                              "cpu")
    assert rec["scaling_efficiency"] == 1.0 and rec["edges_per_sec"] > 0
    assert len(ranks) == 4 and [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        got = {k: v for k, v in r["forward"].items()
               if k not in ("total", "host_staged")}
        assert got == want, (r["rank"], got, want)
        assert r["launches"] == {"fan_draw": 0, "gather_rows": 0,
                                  "ell_agg": 0, "ell_sddmm": 0,
                                  "ell_gat": 0, "rel_mean": 0,
                                  "rel_mean_tr": 0, "sigmoid_xent": 0}
    assert rec["comm_MB_per_step_per_dev"]["total"] == round(
        sum(want.values()) / 1e6, 3)
    assert "predicted_chip_efficiency" not in rec


def test_scaling_bench_never_switches_backend():
    with pytest.raises(ValueError, match="a card a rank"):
        scaling_bench.sweep(scaling_bench.parse(
            ["--shapes", "1x2", "--backend", "nccl", "--nodes", "400"]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        scaling_bench.sweep(scaling_bench.parse(
            ["--shapes", "1x1", "--backend", "nccl", "--device", "cpu"]))


def test_gen_edge_file_writes_the_reference_bytes(tmp_path):
    ref = reference_tool("ingest_drill")
    for n_edges, n_nodes, seed in ((12_345, 1000, 0), (777, 13, 3)):
        a, b = tmp_path / "port.txt", tmp_path / "ref.txt"
        assert ingest_drill.gen_edge_file(str(a), n_edges, n_nodes, seed,
                                          chunk=1000) == \
            ref.gen_edge_file(str(b), n_edges, n_nodes, seed, chunk=1000)
        assert a.read_bytes() == b.read_bytes()


#: the reference's record keys and stages (tools/ingest_drill.py:86-205)
DRILL_KEYS = {"edges", "nodes", "partitions", "shards", "host_cpus",
              "stages", "file_GB", "lines_per_s", "deepwalk_step_s",
              "deepwalk_loss", "sage_step_s"}
DRILL_STAGES = ("generate", "stream_convert", "load_store",
                "shard_and_place", "deepwalk_compile+first_step",
                "deepwalk_steps", "sage_compile+first_step", "sage_steps")


def test_ingest_drill_record_and_shards(tmp_path):
    d, out = tmp_path / "drill", tmp_path / "DRILL.json"
    args = ingest_drill.parse([
        "--edges", "20000", "--nodes", "2000", "--partitions", "2",
        "--shards", "2", "--steps", "1", "--device", "cpu", "--dir", str(d),
        "--out", str(out), "--keep"])
    rec = ingest_drill.run(args, log=lambda *a: None)
    assert DRILL_KEYS <= set(rec)
    assert set(DRILL_STAGES) <= set(rec["stages"])
    for name, st in rec["stages"].items():
        assert {"wall_s", "VmRSS", "VmHWM"} <= set(st), name
    for name in DRILL_STAGES[4:] + ("load_shard",):
        assert len(rec["stages"][name]["VmHWM_by_rank"]) == 2
    assert math.isfinite(rec["deepwalk_loss"]) and rec["sage_step_s"] >= 0
    assert all(math.isfinite(r["sage_loss"]) for r in rec["ranks"])
    assert (rec["edges"], rec["shards"], rec["backend"]) == (20000, 2,
                                                            "gloo")
    assert os.path.exists(out)

    # what each rank loads: build_sharded of the same graph and feat table
    graph = load_graph(str(d / "parts"), packs=("group",), device="cpu")
    feat = np.random.default_rng(1).normal(0, 1, (2000, 32)).astype(
        np.float32)
    sg = sharded.build_sharded(ingest_drill.with_feature(graph), 2)
    for s in range(2):
        want = sharded._flat_shard(sg, s)
        with np.load(d / "shards" / f"shard_{s}.npz") as z:
            got = {k: z[k] for k in z.files if k != "_meta"}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        rows = got["dense_nf:feat"]
        np.testing.assert_array_equal(rows[: len(feat[s::2])], feat[s::2])
        view = sharded.load_shard(str(d / "shards"), s, "cpu")
        assert view.shard == s and view.num_shards == 2
