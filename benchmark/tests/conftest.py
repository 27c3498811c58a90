"""Fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``; the ones marked ``cuda`` run on a
card only).

``small_spec`` is the benchmark at a size the CPU holds: a copy of
``BENCHMARK.json`` whose configurations are the real ones with fewer nodes
and roots (and no other change), beside the real traffic, limits and
metric files. At that size sound runs pass the cells' own limits
(``test_benchmark_correct.py``)."""
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: the CPU size: sampled sage at 20,000 nodes and 500,000 edges with 512
#: roots a step (an inference request of 1,024 ids runs as 2 batches),
#: gcn at 30,000 nodes and 2 x 207,000 edges with 16,000 roots, 3 and 2
#: steps a loop
SMALL = {"sage": {"graph.nodes": 20000, "graph.edges": 500000,
                  "train.batch": 512, "train.steps_per_loop": 3},
         "gcn": {"graph.nodes": 30000, "graph.edges": 207000,
                 "train.batch": 16000, "train.steps_per_loop": 2}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips itself when "
        "torch.cuda.is_available() is false")


def write_spec(root: str, sizes=SMALL, bench_dir=None):
    """A checkout-like directory ``root`` with a ``BENCHMARK.json`` whose
    configuration files are the real ones resized by ``sizes``; returns
    its ``Spec``."""
    from benchmark.harness.spec import BENCH_DIR, Spec
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        doc = json.load(f)
    os.makedirs(os.path.join(root, "cfg"), exist_ok=True)
    for c in doc["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        for key, value in sizes.get(c["name"], {}).items():
            section, name = key.split(".")
            cfg[section][name] = value
        path = os.path.join(root, "cfg", f"{c['name']}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        shutil.copy(os.path.join(REPO, c["file"][:-len(".json")] + ".py"),
                    path[:-len(".json")] + ".py")
        c["file"] = os.path.relpath(path, root)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)
    return Spec(repo=root, bench_dir=bench_dir or BENCH_DIR)


@pytest.fixture(scope="session")
def small_spec(tmp_path_factory):
    return write_spec(str(tmp_path_factory.mktemp("small")))
