"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the ``per_layer`` and ``end_to_end`` entries name metrics. Each lives
in files of its own under ``benchmark/``:

- configuration ``<name>``: ``configs/<name>.json`` (its sizes, at the
  path the entry's ``file`` gives) and ``configs/<name>.py`` beside it,
  whose ``build(cfg, seed, device)`` makes the system under test and
  whose ``check(cfg, seed, device, handed, evidence)`` holds a run to its
  plain reference (``handed``: the benchmark's own inputs, which the
  system's ``release()`` hands back; ``evidence``: what the drive
  collected);
- traffic mix ``<name>``: ``traffic/<name>.json``, its parameters, read
  by the generator of its ``kind``, ``drives/<kind>.py``;
- per-layer metric ``<name>``: ``metrics/<name>.py``, with ``LAYER``,
  ``MOVES`` and ``read(ctx)``;
- the limits of cell ``<name>``'s correctness check:
  ``limits/<name>.json``.

So a later change adds a cell, a mix or a metric by adding files and
entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """Import the file ``path`` as module ``name`` (names such as
    ``device_idle.train`` are no Python identifiers)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


class Spec:
    """``BENCHMARK.json`` of the checkout at ``repo`` and the files under
    its benchmark folder."""

    def __init__(self, repo: str = REPO_DIR, bench_dir: str = BENCH_DIR):
        self.repo, self.bench_dir = repo, bench_dir
        self.doc = load_json(os.path.join(repo, "BENCHMARK.json"))

    # ---- entries ---------------------------------------------------------
    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        known = [w["name"] for w in self.doc["workloads"]]
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {known}")

    def config_entry(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def end_to_end(self, workload: str) -> List[dict]:
        """The end-to-end metrics that cell ``workload`` reports."""
        return [m for m in self.doc["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics that cell ``workload`` reports, where its
        readers find something to read."""
        return [m for m in self.doc["per_layer"]
                if workload in m.get("workloads", [workload])]

    # ---- files -----------------------------------------------------------
    def config(self, name: str) -> dict:
        return load_json(os.path.join(self.repo,
                                      self.config_entry(name)["file"]))

    def config_module(self, name: str) -> ModuleType:
        path = os.path.join(self.repo, self.config_entry(name)["file"])
        return load_module(os.path.splitext(path)[0] + ".py",
                           f"benchmark_config_{name}")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.bench_dir, "traffic",
                                      f"{name}.json"))

    def drive_module(self, kind: str) -> ModuleType:
        return load_module(os.path.join(self.bench_dir, "drives",
                                        f"{kind}.py"),
                           f"benchmark_drive_{kind}")

    def limits(self, workload: str) -> Dict[str, float]:
        return load_json(os.path.join(self.bench_dir, "limits",
                                      f"{workload}.json"))["limits"]

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        f"{name}.py"),
                           f"benchmark_metric_{name}")

