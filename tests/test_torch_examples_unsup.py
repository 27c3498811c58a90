"""The port's runners of the model examples against examples/: dgi, gae
(and ``--variational``), geniepath, lgcn, scalable_sage, solution and
sample_solution. The same flags build the same estimator, run config,
model, towers, widths and flows as the reference script; each runs
``train_and_evaluate`` on the SBM stand-in on the CPU at small width, on
one device and as a one-rank mesh (``--mesh auto``).
"""
import pytest

from tests.test_torch_examples import FLAGS, mesh_train
from tests.test_torch_examples_conv import (  # noqa: F401
    assert_same_build, build_both, one_thread, port_script,
    train_and_evaluate)

CASES = [("dgi", [], "mrr"), ("gae", [], "mrr"),
         ("gae", ["--variational"], "mrr"), ("geniepath", [], "f1"),
         ("lgcn", ["--fanouts", "3", "4"], "f1"), ("lgcn", [], "f1"),
         ("scalable_sage", ["--fanouts", "5"], "f1"), ("solution", [], "f1"),
         ("sample_solution", [], "mrr")]
IDS = ["dgi", "gae", "vgae", "geniepath", "lgcn_fanouts", "lgcn",
       "scalable_sage", "solution", "sample_solution"]


@pytest.mark.parametrize("name,extra,metric", CASES, ids=IDS)
def test_flags_build_the_reference_estimator(tmp_path, monkeypatch, name,
                                             extra, metric):
    got, want = build_both(tmp_path, monkeypatch, name, name, extra)
    assert_same_build(got, want)
    assert got.config.metric == metric


@pytest.mark.parametrize("name,extra,metric", CASES, ids=IDS)
def test_train_and_evaluate_runs_on_the_stand_in(tmp_path, name, extra,
                                                 metric):
    train_and_evaluate(tmp_path, name, name, metric, extra)


@pytest.mark.parametrize("name", ["dgi", "gae", "geniepath", "lgcn",
                                  "scalable_sage", "solution",
                                  "sample_solution"])
def test_mesh_trains_as_one_rank_group(tmp_path, name):
    mesh_train(tmp_path, port_script(name, name))
