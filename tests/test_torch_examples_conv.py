"""The port's runners of the conv examples against examples/: the
whole-graph convs (gat, agnn, appnp, arma, sgcn, tagcn), dna over sampled
neighborhoods, the layerwise flows (adaptivegcn, fastgcn) and the graph
classifiers (gin, graphgcn, set2set, gated_graph). For each, the same
flags build the same estimator, run config, model, widths and flow as
the reference script (``assert_same_build``); each runs
``train_and_evaluate`` on its stand-in on the CPU at small width, on
one device and as a one-rank mesh (``--mesh auto``).
``assert_same_build`` serves the other example files too, and
``one_thread`` all three files.
"""
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from euler_tpu.models import convs as jax_convs
from euler_tpu_torch.examples import common
from tests.test_torch_examples import (FLAGS, built, mesh_train,
                                      reference_script)

#: scalar and tuple fields held equal wherever the reference model has
#: them
ATTRS = ("n_entities", "n_relations", "ent_dim", "rel_dim", "num_negs",
         "margin", "n_nodes", "dim", "edge_types", "walk_len", "left_win",
         "right_win", "order", "node_type", "num_layers", "fanout",
         "use_residual", "label_dim", "label_name", "k", "dims",
         "num_graphs", "relation_from_etype")
FLOW_ATTRS = ("fanouts", "layer_sizes", "payload", "typed", "cap",
              "layout", "add_self_loops")
ESTIMATOR_ATTRS = ("train_node_type", "train_edge_type", "label_name",
                   "num_classes")
CONFIG = ("batch_size", "total_steps", "optimizer", "learning_rate",
          "log_steps", "metric", "profile")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while these files run: their models and graphs
    are tiny, and the suite's six workers each start as many threads as
    the machine has cores, which made their steps 10-20x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def norm(v):
    return tuple(norm(x) for x in v) if isinstance(v, (list, tuple)) else v


def assert_same_module(got, want, path="model"):
    """``got`` (a torch module) built as ``want`` (a flax module): the
    class name, every ATTRS field the reference has, the conv, the flow,
    and the embedders, towers and pool, recursively."""
    assert type(got).__name__ == type(want).__name__, path
    for a in ATTRS:
        if hasattr(want, a):
            assert norm(getattr(got, a)) == norm(getattr(want, a)), \
                f"{path}.{a}"
    if isinstance(getattr(want, "conv", None), str):
        conv = jax_convs.get_conv_class(want.conv).__name__
        assert {type(c).__name__ for c in got.convs} == {conv}, path
    if hasattr(want, "flow"):
        flow, jflow = got.flow, want.flow
        assert type(flow).__name__ == type(jflow).__name__, f"{path}.flow"
        assert norm(flow.metapath) == norm(jflow.metapath), f"{path}.flow"
        for a in FLOW_ATTRS:
            assert norm(getattr(flow, a, None)) == \
                norm(getattr(jflow, a, None)), f"{path}.flow.{a}"
    for sub in ("embedder", "context_embedder", "group", "pool"):
        if hasattr(want, sub):
            assert_same_module(getattr(got, sub), getattr(want, sub),
                               f"{path}.{sub}")
    if hasattr(want, "gnns"):
        assert len(got.gnns) == len(want.gnns), path
        for i, (a, b) in enumerate(zip(got.gnns, want.gnns)):
            assert_same_module(a, b, f"{path}.gnns[{i}]")


def assert_same_build(got, want):
    """Two estimators built by the same flags: class, run config (the
    model directory up to its name), the estimator's fields and model."""
    assert type(got).__name__ == type(want).__name__
    for k in CONFIG:
        assert getattr(got.config, k) == getattr(want.config, k), k
    assert os.path.basename(got.config.model_dir) == "mport"
    assert os.path.basename(want.config.model_dir) == "mref"
    for a in ESTIMATOR_ATTRS:
        if hasattr(want, a):
            assert getattr(got, a) == getattr(want, a), a
    assert_same_module(got.model, want.model)


def port_script(dir_name, script):
    return importlib.import_module(
        f"euler_tpu_torch.examples.{dir_name}.run_{script}")


def build_both(tmp_path, monkeypatch, dir_name, script, extra=(),
               ref_main=None):
    """(port estimator, reference estimator) that the two scripts hand to
    ``_dispatch`` for the same flags."""
    ref = reference_script(dir_name, script)
    argv = FLAGS + list(extra) + ["--data_dir", str(tmp_path / "ref"),
                                  "--model_dir", str(tmp_path / "mref")]
    want = built(ref_main or (lambda a: ref.main(argv=a)),
                 sys.modules["common"], argv, monkeypatch)
    argv = FLAGS + list(extra) + ["--data_dir", str(tmp_path / "port"),
                                  "--model_dir", str(tmp_path / "mport"),
                                  "--device", "cpu"]
    port = port_script(dir_name, script)
    got = built(lambda a: port.main(argv=a), common, argv, monkeypatch)
    return got, want


def train_and_evaluate(tmp_path, dir_name, script, metric, extra=()):
    out = port_script(dir_name, script).main(argv=FLAGS + list(extra) + [
        "--data_dir", str(tmp_path), "--device", "cpu", "--model_dir",
        str(tmp_path / "m"), "--run_mode", "train_and_evaluate"])
    assert out["steps"] == 3 and metric in out
    assert all(np.isfinite(v) for v in out.values())
    assert os.path.isdir(tmp_path / "m" / "ckpt")
    return out


CONVS = ["gat", "agnn", "appnp", "arma", "sgcn", "tagcn", "dna",
         "adaptivegcn", "fastgcn"]
GRAPHS = ["gin", "graphgcn", "set2set", "gated_graph"]


@pytest.mark.parametrize("name", CONVS + GRAPHS)
def test_flags_build_the_reference_estimator(tmp_path, monkeypatch, name):
    got, want = build_both(tmp_path, monkeypatch, name, name)
    assert_same_build(got, want)


@pytest.mark.parametrize("name", CONVS + GRAPHS)
def test_train_and_evaluate_runs_on_the_stand_in(tmp_path, name):
    train_and_evaluate(tmp_path, name, name,
                       "accuracy" if name in GRAPHS else "f1")


@pytest.mark.parametrize("name", CONVS + GRAPHS)
def test_mesh_trains_as_one_rank_group(tmp_path, name):
    mesh_train(tmp_path, port_script(name, name),
               metric="accuracy" if name in GRAPHS else "f1")
