"""The PyTorch port imports neither jax (nor flax, optax, orbax) nor the
JAX package.

A fresh interpreter imports every module of ``euler_tpu_torch`` (and the
repository's ``chip_smoke.py`` and the sharded tests' rank module,
``tests/test_torch_mesh_ranks.py``) and then checks ``sys.modules``. The
name check matches ``euler_tpu`` and ``euler_tpu.*`` only, never
``euler_tpu_torch``.
"""
import os
import pkgutil
import subprocess
import sys

import jax  # noqa: F401  (the test process itself may hold both)
import torch  # noqa: F401

import euler_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import euler_tpu_torch
names = [m.name for m in pkgutil.walk_packages(euler_tpu_torch.__path__,
                                               "euler_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
importlib.import_module("tests.test_torch_mesh_ranks")
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax", "orbax", "euler_tpu")
             or m.startswith(("jax.", "jaxlib", "flax.", "optax.", "orbax.",
                              "euler_tpu.")))
assert not bad, bad
print(len(names))
"""


def test_port_modules_import_without_jax():
    names = [m.name for m in pkgutil.walk_packages(
        euler_tpu_torch.__path__, "euler_tpu_torch.")]
    for name in ("serving", "bench", "utils.hooks", "utils.config",
                 "utils.io", "utils.dense", "ops.walk", "ops.util_ops",
                 "models.walk_models", "models.aggregators",
                 "models.autoencoders", "models.extra_nets",
                 "models.graph_model", "models.group_gnn", "models.layers",
                 "models.pooling", "models.scalable", "models.solution",
                 "datasets.synthetic", "datasets.registry",
                 "graph.convert", "graph.stream_convert", "examples.common",
                 "examples.graphsage.run_graphsage", "examples.gcn.run_gcn",
                 "examples.rgcn.run_rgcn", "query", "ops.index", "knn",
                 "examples.TransX.run_transX", "examples.TransX.run_transE",
                 "examples.TransX.run_transH", "examples.TransX.run_transR",
                 "examples.TransX.run_transD", "examples.distmult.run_distmult",
                 "examples.deepwalk.run_deepwalk", "examples.line.run_line",
                 "examples.gat.run_gat", "examples.agnn.run_agnn",
                 "examples.appnp.run_appnp", "examples.arma.run_arma",
                 "examples.sgcn.run_sgcn", "examples.tagcn.run_tagcn",
                 "examples.dna.run_dna",
                 "examples.adaptivegcn.run_adaptivegcn",
                 "examples.fastgcn.run_fastgcn", "examples.gin.run_gin",
                 "examples.graphgcn.run_graphgcn",
                 "examples.set2set.run_set2set",
                 "examples.gated_graph.run_gated_graph",
                 "examples.dgi.run_dgi", "examples.gae.run_gae",
                 "examples.geniepath.run_geniepath", "examples.lgcn.run_lgcn",
                 "examples.scalable_sage.run_scalable_sage",
                 "examples.solution.run_solution",
                 "examples.sample_solution.run_sample_solution",
                 "ops.dispatch", "parallel", "parallel.mesh",
                 "parallel.comms", "parallel.sharded", "parallel.train"):
        assert f"euler_tpu_torch.{name}" in names
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == len(names)
