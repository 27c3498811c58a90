"""No module the benchmark runs has the top-level name jax, jaxlib, flax or
euler_tpu (compared whole: euler_tpu_torch is the port), and the plain
reference imports nothing of the port or of the harness."""
import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness import runner
from benchmark.harness.spec import BENCH_DIR
from benchmark.tests.conftest import REPO


def imported(path):
    """Top-level names of every import in the file at ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def sources(sub=""):
    root = os.path.join(BENCH_DIR, sub)
    for d, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(d, name)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax_import(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & set(runner.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_reference_stands_alone(path):
    for name in imported(path):
        top = name.split(".")[0]
        assert top not in ("euler_tpu_torch", "benchmark"), name


def test_forbidden_compares_whole_names():
    assert runner.forbidden_modules(["euler_tpu_torch", "euler_tpu_torch.ops",
                                     "numpy", "jaxtyping"]) == []
    assert runner.forbidden_modules(["euler_tpu.ops", "jax.numpy",
                                     "flax"]) == ["euler_tpu", "flax", "jax"]


def test_a_run_loads_no_jax():
    """Import the harness, a configuration's builder and the port's
    modules that a run builds from; none of them loads JAX."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.harness import runner, supervised, judge, drive\n"
        "from benchmark.harness.spec import Spec\n"
        "s = Spec(); [s.metric_reader(m['name']) for m in "
        "s.doc['per_layer']]\n"
        "s.config_module('sage')\n"
        "import euler_tpu_torch.estimator, euler_tpu_torch.models\n"
        "import euler_tpu_torch.dataflow, euler_tpu_torch.graph.store\n"
        "print(runner.forbidden_modules())\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_chip_exits_nonzero_without_a_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sage-train",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
