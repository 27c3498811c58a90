"""The repo's tools on the port, held against the reference's on the CPU.

- ``euler_tpu_torch.bench``'s ``nodes``/``batch``/``dedup``: the config
  string and the count a step that bench.py forms for
  ``EULER_BENCH_NODES``/``BATCH`` (bench.py:262-282, :490-505,
  :582, :599-617), read from bench.py's own source; ``dedup=True``
  builds ``GNNNet(dedup_features=True)`` and its first loss equals the
  plain fetch's on the same weights and draws within 1e-6.
- ``tools.bench_suite``: one CPU mode and one that fails in one run: the
  record keeps the reference's keys, the failure is the reference's
  ``no_result`` record and the exit is 1; the markdown table equals the
  reference's (tools/bench_suite.py) printed from the same results.
- ``parallel.launch``: results in rank order, a failing rank's error
  and exit code, the deadline.
- ``tools.parity_run``: ``TABLE`` equals the reference's row by row
  (the script mapped to the port's module); on the miniature cora
  fixture of tests/test_datasets_raw.py:194-207 both harnesses run the
  same rows, the port every one of them (see
  ``test_parity_on_the_cora_fixture`` for the rows the reference's
  dataset reload fails); ``gin_mutag`` without raw files is skipped on
  both sides, and a stand-in runs with no delta.

tests/test_torch_tools_mesh.py holds the scaling bench and the ingest
drill.
"""
import contextlib
import importlib.util
import io
import json
import math
import operator
import os
import re
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from euler_tpu_torch import bench
from euler_tpu_torch.parallel.launch import launch
from euler_tpu_torch.tools import bench_suite, parity_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_tool(name: str):
    """tools/<name>.py of the reference, loaded by file path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- bench --

BENCH_PY = open(os.path.join(ROOT, "bench.py")).read()
#: bench.py's constants around its config strings and counts
BENCH_CONSTANTS = dict(fanout=[25, 10], avg_deg=25, n_layers=2, num_negs=5,
                       n_rel=16)


def bench_py_config(mode: str, nodes: int, batch: int) -> tuple:
    """(config, count a step) that bench.py forms for ``mode`` under
    EULER_BENCH_NODES=nodes and EULER_BENCH_BATCH=batch, evaluated from
    its source: the sampled branch's, _gcn_child's and _transe_child's
    ``"config": f"..."`` in that order, and the sampled and gcn
    ``edges_per_step`` expressions (transe counts triples, the batch)."""
    configs = re.findall(r'"config": (f"[^"]*")', BENCH_PY)
    counts = re.findall(r"edges_per_step = ((?:[^\n]*\\\n)*[^\n]*)",
                        BENCH_PY)
    ns = dict(BENCH_CONSTANTS, n_nodes=nodes, batch=batch)
    at = {"sage": 0, "gcn": 1, "transe": 2}[mode]
    config = eval(configs[at], {}, ns)
    count = batch if mode == "transe" else eval(
        counts[at].replace("\\\n", " "), {}, ns)
    return config, count


@pytest.mark.parametrize("mode", ["sage", "gcn", "transe"])
def test_bench_sizes_form_bench_py_config_and_count(mode):
    nodes, batch = 3000, (None if mode == "gcn" else 128)
    lines = []
    records = bench.run("cpu", log=lines.append, model=mode, nodes=nodes,
                        batch=batch)
    config, count = bench_py_config(mode, nodes, batch or nodes)
    assert [r["config"] for r in records] == [config] * 3
    mine = {"sage": bench.edges_per_step(batch or 0),
            "gcn": bench.gcn_edges_per_step(nodes),
            "transe": batch}[mode]
    assert mine == count
    for r in records:
        # value = count * steps / seconds, rounded to 0.1, and
        # ms_per_step = seconds / steps
        assert abs(r["value"] - count * 1e3 / r["ms_per_step"]) <= 0.0501
    assert sum(s.startswith("{") for s in lines) == 3


def test_bench_default_sizes_are_unchanged():
    assert bench.SIZES["cpu"][:2] == (5_000, 256)
    assert bench_py_config("sage", *bench.SIZES["cpu"][:2])[0] == \
        "b256_f25x10_n5000"


def test_bench_knobs_outside_their_modes_raise():
    with pytest.raises(ValueError, match="every node"):
        bench.run("cpu", model="gcn", batch=64)
    with pytest.raises(ValueError, match="sampled modes"):
        bench.run("cpu", model="transe", dedup=True)


def test_bench_dedup_builds_dedup_features_with_the_same_first_loss():
    dev = torch.device("cpu")
    est = {d: bench.build(dev, 600, 64, 1, "sage", dedup=d)
           for d in (False, True)}
    assert est[True].model.embedder.dedup_features is True
    assert est[False].model.embedder.dedup_features is False
    for a, b in zip(est[False].model.parameters(),
                    est[True].model.parameters()):
        assert torch.equal(a, b)
    roots = torch.arange(0, 600, 7, dtype=torch.int32)
    loss = {d: e.model(e.graph.tensors, roots,
                       generator=torch.Generator().manual_seed(3))["loss"]
            .detach() for d, e in est.items()}
    assert torch.isfinite(loss[True])
    assert abs(float(loss[True]) - float(loss[False])) <= 1e-6


# ---------------------------------------------------------- bench suite --

def test_bench_suite_records_a_mode_and_a_failure(tmp_path, monkeypatch):
    out = tmp_path / "suite.json"
    argv = ["--modes", "sage,nosuchmode", "--device", "cpu", "--nodes",
            "1000", "--batch", "64", "--out", str(out)]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = bench_suite.main(argv)
    assert rc == 1
    rec = json.loads(out.read_text())
    assert set(rec) == {"ts", "results"}
    sage, bad = rec["results"]["sage"], rec["results"]["nosuchmode"]
    # bench.py's line (bench.py:276-282) and the suite's wall_s
    assert set(sage) == {"metric", "model", "value", "unit", "vs_baseline",
                         "platform", "phase", "config", "wall_s"}
    assert sage["phase"] == "pipelined" and sage["platform"] == "cpu"
    assert sage["config"] == "b64_f25x10_n1000" and sage["value"] > 0
    assert bad["error"] == "no_result" and "invalid choice" in \
        bad["stderr_tail"]
    assert set(bad) == {"model", "error", "stderr_tail", "wall_s"}

    # the reference's table from the same results
    ref = reference_tool("bench_suite")
    monkeypatch.setattr(ref, "run_mode",
                        lambda mode, deadline: dict(rec["results"][mode]))
    monkeypatch.setattr(sys, "argv", ["bench_suite.py", "--modes",
                                      "sage,nosuchmode", "--out",
                                      str(tmp_path / "ref.json")])
    ref_printed = io.StringIO()
    with contextlib.redirect_stdout(ref_printed):
        ref.main()
    want = ref_printed.getvalue().split("\n\n")[-1].strip()
    assert bench_suite.table(rec["results"]) == want
    assert want in printed.getvalue()
    assert json.loads((tmp_path / "ref.json").read_text())["results"] == \
        rec["results"]


# --------------------------------------------------------------- launch --

def test_launch_returns_each_rank_result_in_rank_order():
    assert launch(dist.get_rank, 3, timeout_s=120) == [0, 1, 2]
    assert launch(operator.mul, 2, timeout_s=120, args=(6, 7)) == [42, 42]


def test_launch_raises_with_the_failed_ranks_errors():
    with pytest.raises(RuntimeError) as e:
        launch(operator.truediv, 2, timeout_s=120, args=(1, 0))
    msg = str(e.value)
    assert "2 of 2 ranks failed" in msg
    assert "rank 0: exit code 1" in msg and "rank 1: exit code 1" in msg
    assert "ZeroDivisionError" in msg


def test_launch_kills_every_rank_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="still running after 5.0 s"):
        launch(time.sleep, 2, timeout_s=5.0, args=(600,))
    assert time.monotonic() - t0 < 60


def test_launch_refuses_nccl_past_the_cards():
    with pytest.raises(ValueError, match="a card a rank"):
        launch(dist.get_rank, torch.cuda.device_count() + 1,
               backend="nccl")


# --------------------------------------------------------------- parity --

def test_parity_table_is_the_reference_table():
    ref = reference_tool("parity_run")
    assert len(parity_run.TABLE) == len(ref.TABLE) == 53
    for mine, theirs in zip(parity_run.TABLE, ref.TABLE):
        assert mine == theirs
        assert importlib.util.find_spec(parity_run.module_of(mine[1]))


def write_cora_fixture(root) -> None:
    """tests/test_datasets_raw.py:194-207's miniature cora-format raw
    files: 30 papers, 8 binary features, 3 classes."""
    raw = root / "cora"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(0)
    n = 30
    lines = []
    for i in range(n):
        fv = rng.integers(0, 2, 8)
        lines.append("\t".join([f"p{i}"] + [str(v) for v in fv]
                               + [f"class{i % 3}"]))
    (raw / "cora.content").write_text("\n".join(lines) + "\n")
    cites = [f"p{rng.integers(0, n)}\tp{rng.integers(0, n)}"
             for _ in range(80)]
    (raw / "cora.cites").write_text("\n".join(cites) + "\n")


def test_parity_on_the_cora_fixture(tmp_path):
    """Both harnesses over their own copy of the fixture. The fixture
    has 3 classes where Cora declares 7: the first row converts it and
    takes 3, and the reference's dataset, built anew for each later row
    over the converted directory, keeps the declared 7 and its model
    fails (incompatible shapes); the port reads the converted widths
    (datasets/registry.py), so it runs every row."""
    for side in ("port", "ref"):
        write_cora_fixture(tmp_path / side)
    mine = parity_run.run_parity(
        data_dir=str(tmp_path / "port"), only="_cora", steps=30,
        model_dir=str(tmp_path / "port_models"), log=lambda *a: None,
        device="cpu")
    ref = reference_tool("parity_run")
    theirs = ref.run_parity(
        data_dir=str(tmp_path / "ref"), only="_cora", steps=30,
        model_dir=str(tmp_path / "ref_models"), log=lambda *a: None)
    assert [r["run"] for r in mine] == [r["run"] for r in theirs]
    assert len(mine) == 15
    for m, t in zip(mine, theirs):
        assert m["status"] == "ran", m
        if t["status"] != "ran":
            assert t["status"] == "error" and \
                "incompatible shapes" in t["reason"], t
        assert set(m) == {"run", "dataset", "status", "metric", "value",
                          "reference", "delta"}
        assert math.isfinite(m["value"])
        assert m["delta"] == pytest.approx(m["value"] - m["reference"])
    by_run = {t["run"]: t for t in theirs}
    assert by_run["gcn_cora"]["status"] == "ran"
    assert {t["run"] for t in theirs if t["status"] == "ran"} >= {
        "gcn_cora", "deepwalk_cora", "line_cora"}
    summary = parity_run.summarize(mine)
    assert (summary["ran"], summary["skipped"], summary["errors"]) == \
        (15, 0, 0)


def test_parity_skips_and_stand_ins(tmp_path):
    ref = reference_tool("parity_run")
    data = str(tmp_path / "data")
    skipped = parity_run.run_parity(data_dir=data, only="gin_mutag",
                                    log=lambda *a: None)
    assert skipped == ref.run_parity(data_dir=data, only="gin_mutag",
                                     log=lambda *a: None)
    assert skipped[0]["status"] == "skipped"
    out = tmp_path / "p.json"
    summary = parity_run.main([
        "--data_dir", data, "--only", "gin_mutag", "--steps", "2",
        "--allow-synthetic", "--device", "cpu", "--model_dir",
        str(tmp_path / "m"), "--json", str(out)])
    (row,) = summary["results"]
    assert row["status"] == "ran_synthetic" and row["delta"] is None
    assert row["reference"] is None and row["metric"] == "accuracy"
    assert json.loads(out.read_text())["ran"] == 1
    assert summary["errors"] == 0


def test_a_fresh_cora_over_a_converted_fixture_keeps_its_widths(tmp_path):
    """The port's fix behind the parity rows above: the second object
    over the converted fixture reads 8 features and 3 classes, where the
    reference's keeps Cora's declared 1433 and 7."""
    from euler_tpu.datasets import get_dataset as jax_get_dataset
    from euler_tpu_torch.datasets import get_dataset
    write_cora_fixture(tmp_path)
    first = get_dataset("cora", str(tmp_path))
    first.load_graph(device="cpu")
    again = get_dataset("cora", str(tmp_path))
    again.load_graph(device="cpu")
    assert (first.feature_dim, first.label_dim) == (8, 3)
    assert (again.feature_dim, again.label_dim) == (8, 3)
    ref = jax_get_dataset("cora", str(tmp_path))
    ref.load_graph()
    assert (ref.feature_dim, ref.label_dim) == (1433, 7)
