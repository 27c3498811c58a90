"""BENCHMARK.json against the contract's shape and character sets, every
name found by the harness, and a cell, a mix and a metric added by files
and entries alone."""
import json
import os
import re
import shutil
from typing import List, Optional

import pytest

from benchmark.harness import runner, spec as spec_lib
from benchmark.tests.conftest import REPO, write_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def problems(doc: dict, repo: Optional[str] = None) -> List[str]:
    """What in ``doc`` (a parsed ``BENCHMARK.json``) breaks the names,
    units and references the harness relies on; empty when none."""
    out = []
    names = ([c["name"] for c in doc["configs"]]
             + [w["name"] for w in doc["workloads"]]
             + [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
             + [w["traffic"] for w in doc["workloads"]]
             + [w["config"] for w in doc["workloads"]]
             + [k for c in doc["configs"] for k in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    out += [f"bad unit {m['unit']!r}" for m in
            doc["end_to_end"] + doc["per_layer"] if not UNIT.match(m["unit"])]
    metric_names = [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    for kind, seq in (("metric", metric_names),
                      ("workload", [w["name"] for w in doc["workloads"]]),
                      ("config", [c["name"] for c in doc["configs"]])):
        dup = {n for n in seq if seq.count(n) > 1}
        out += [f"duplicate {kind} {n!r}" for n in sorted(dup)]
    cells = {w["name"] for w in doc["workloads"]}
    configs = {c["name"] for c in doc["configs"]}
    e2e = {m["name"] for m in doc["end_to_end"]}
    out += [f"workload {w['name']!r} names unknown config {w['config']!r}"
            for w in doc["workloads"] if w["config"] not in configs]
    for m in doc["end_to_end"] + doc["per_layer"]:
        out += [f"metric {m['name']!r} lists unknown cell {c!r}"
                for c in m.get("workloads", []) if c not in cells]
    for m in doc["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']!r} moves unknown {m['moves']!r}")
            continue
        mover = next(e for e in doc["end_to_end"] if e["name"] == m["moves"])
        for c in m.get("workloads", sorted(cells)):
            if c not in mover.get("workloads", [c]):
                out.append(f"{m['name']!r} in {c!r}, which does not report "
                           f"{m['moves']!r}")
    if repo is not None:
        for c in doc["configs"]:
            if not os.path.isfile(os.path.join(repo, c["file"])):
                out.append(f"config file {c['file']!r} missing")
    return out


@pytest.fixture(scope="module")
def doc():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_bounds(doc):
    assert set(doc) == TOP_KEYS
    assert doc["command"] == ["python3", "benchmark/run.py"]
    assert doc["paths"] == ["benchmark"]
    assert isinstance(doc["run_seconds"], int) and \
        1 <= doc["run_seconds"] <= 51
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in doc["end_to_end"])
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert m["better"] in ("lower", "higher")


def test_names_units_and_references(doc):
    assert problems(doc, REPO) == []


def test_problems_catches_bad_entries(doc):
    bad = json.loads(json.dumps(doc))
    bad["per_layer"][0]["unit"] = "per second"
    bad["workloads"][0]["name"] = "sage train"
    bad["per_layer"].append(dict(bad["per_layer"][0]))
    found = problems(bad)
    assert any("bad unit" in p for p in found)
    assert any("bad name" in p for p in found)
    assert any("duplicate metric" in p for p in found)


def test_every_cell_reports_setup_another_e2e_and_a_layer(doc):
    spec = spec_lib.Spec()
    for w in doc["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(w["name"])


def test_every_piece_is_found_by_name(doc):
    spec = spec_lib.Spec()
    for w in doc["workloads"]:
        kind = spec.traffic(w["traffic"])["kind"]
        assert callable(spec.drive_module(kind).Drive)
        assert spec.limits(w["name"])
        cfg = spec.config(w["config"])
        assert cfg["name"] == w["config"]
        module = spec.config_module(w["config"])
        assert callable(module.build) and callable(module.check)
    for m in doc["per_layer"]:
        reader = spec.metric_reader(m["name"])
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
        assert callable(reader.read)


def test_configs_state_source_reduced_assumed(doc):
    for c in doc["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["assumed"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank"))


TOY = '''"""A toy service: answers a request of ids with twice their
rows of a table made from the seed; its reference is its own."""
import numpy as np
import torch


def table(cfg, seed):
    gen = np.random.default_rng(seed)
    return gen.standard_normal((cfg["rows"], cfg["width"])).astype(
        np.float32)


class System:
    def __init__(self, cfg, seed, device):
        self.device = torch.device(device)
        self.id_range = cfg["rows"]
        self.t = torch.from_numpy(table(cfg, seed)).to(self.device)

    def serve(self, ids, keep=False):
        ids = torch.from_numpy(ids).to(self.device).long()
        return (2 * self.t[ids]).cpu().numpy(), None

    def release(self):
        self.t = None
        return {}


def build(cfg, seed, device):
    return System(cfg, seed, device)


def check(cfg, seed, device, handed, evidence):
    t = table(cfg, seed)
    return {"answer_gap": max(float(np.abs(a["answer"] - 2 * t[a["ids"]])
                                    .max()) for a in evidence["answers"])}
'''


def test_a_cell_mix_and_metric_added_by_files_alone(tmp_path):
    """A later change adds a configuration with a reference of its own
    (no GNN), an open-loop traffic mix, a per-layer metric and a cell:
    new files and new entries, no edited file."""
    bench = tmp_path / "bench"
    for sub in ("traffic", "limits", "metrics", "drives"):
        shutil.copytree(os.path.join(spec_lib.BENCH_DIR, sub), bench / sub)
    root = tmp_path / "repo"
    spec = write_spec(str(root), bench_dir=str(bench))
    doc = spec.doc
    # the new configuration: its sizes and its module, build and check
    (root / "cfg" / "toy.json").write_text(json.dumps(
        {"name": "toy", "source": "https://example.org/toy", "reduced": [],
         "assumed": {"table": "normal rows"}, "rows": 5000, "width": 8}))
    (root / "cfg" / "toy.py").write_text(TOY)
    doc["configs"].append(dict(name="toy", source="https://example.org/toy",
                               file="cfg/toy.json", reduced=[],
                               why="a test configuration"))
    # the new mix: open-loop Poisson arrivals of 1 to 64 ids
    (bench / "traffic" / "open-toy.json").write_text(json.dumps(
        {"kind": "requests", "loop": "open", "arrivals": "poisson",
         "rate_per_s": 400, "ids_per_request": [1, 64], "ids": "uniform",
         "warm_requests": 2, "check_requests": 4, "trace_requests": 5}))
    # the new metric: a reader of its own
    (bench / "metrics" / "requests_served.toy.py").write_text(
        'LAYER = "serve (toy)"\nMOVES = "infer_p95_ms"\n\n\n'
        'def read(ctx):\n    lat = getattr(ctx.drive, "latencies", None)'
        '\n    return len(lat) if lat else None\n')
    doc["per_layer"].append(dict(
        name="requests_served.toy", unit="count", better="higher",
        source="host_clock", layer="serve (toy)", moves="infer_p95_ms",
        workloads=["toy-serve"]))
    for m in doc["end_to_end"]:
        if m["name"] == "infer_p95_ms":
            m["workloads"].append("toy-serve")
    doc["workloads"].append(dict(name="toy-serve", config="toy",
                                 traffic="open-toy", chips=1,
                                 why="a test cell"))
    (bench / "limits" / "toy-serve.json").write_text(json.dumps(
        {"limits": {"answer_gap": 0}}))
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = spec_lib.Spec(repo=str(root), bench_dir=str(bench))
    assert problems(spec.doc, str(root)) == []
    assert "requests_served.toy" in {m["name"] for m in
                                     spec.per_layer("toy-serve")}
    reader = spec.metric_reader("requests_served.toy")

    class Drive:
        latencies = [1.0, 2.0, 3.0]
    assert reader.read(runner.Context(drive=Drive())) == 3
    out = runner.run("toy-serve", 5, 0.3, False, 0.0, device="cpu",
                     spec=spec, look_for_chip=False,
                     out=open(os.devnull, "w"), err=open(os.devnull, "w"))
    assert out["correct"] is True
    assert 60 <= out["attempted"] <= 200       # 400/s for 0.3 s
    assert set(out["metrics"]) == {"setup_s", "infer_p95_ms",
                                   "peak_mem_gb"}
    assert out["checks"]["answer_gap"]["value"] == 0
