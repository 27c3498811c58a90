"""The port's runners of the knowledge-graph and walk examples against
examples/: TransX (run_transX and its four model scripts), distmult,
deepwalk and line (both orders). The same flags build the same estimator,
run config and model as the reference script; each runs
``train_and_evaluate`` (with full-entity ranking for the KG models) on
its stand-in on the CPU at small width, on one device and as a one-rank
mesh (``--mesh auto``).
"""
import pytest

from tests.test_torch_examples import FLAGS, mesh_train, reference_script
from tests.test_torch_examples_conv import (  # noqa: F401
    assert_same_build, build_both, one_thread, port_script,
    train_and_evaluate)

#: (directory, script, extra flags, the model the reference script's
#: ``__main__`` hands run_transX.main, e.g. run_transE.py's "transe")
CASES = [("TransX", "transX", ["--model", "transr"], None),
         ("TransX", "transE", [], "transe"), ("TransX", "transH", [], "transh"),
         ("TransX", "transR", [], "transr"), ("TransX", "transD", [], "transd"),
         ("distmult", "distmult", ["--embedding_dim", "12"], None),
         ("deepwalk", "deepwalk", ["--walk_len", "3", "--num_negs", "4"],
          None),
         ("line", "line", ["--order", "1"], None), ("line", "line", [], None)]
IDS = ["transX", "transE", "transH", "transR", "transD", "distmult",
       "deepwalk", "line1", "line2"]


@pytest.mark.parametrize("dir_name,script,extra,model", CASES, ids=IDS)
def test_flags_build_the_reference_estimator(tmp_path, monkeypatch,
                                             dir_name, script, extra, model):
    ref_main = None
    if model is not None:
        ref = reference_script(dir_name, script)
        def ref_main(argv):
            return ref.main(model, argv)
    got, want = build_both(tmp_path, monkeypatch, dir_name, script, extra,
                           ref_main)
    assert_same_build(got, want)
    assert type(got.model).__name__ == {
        "transX": "TransR", "transE": "TransE", "transH": "TransH",
        "transR": "TransR", "transD": "TransD", "distmult": "DistMult",
        "deepwalk": "DeepWalk", "line": "LINE"}[script]


@pytest.mark.parametrize("dir_name,script,extra,model", CASES, ids=IDS)
def test_train_and_evaluate_runs_on_the_stand_in(tmp_path, dir_name, script,
                                                 extra, model):
    out = train_and_evaluate(tmp_path, dir_name, script, "mrr", extra)
    if dir_name in ("TransX", "distmult"):
        assert {"mr", "hit1", "hit3", "hit10"} <= set(out)


@pytest.mark.parametrize("dir_name,script", [("TransX", "transX"),
                                             ("TransX", "transD"),
                                             ("distmult", "distmult"),
                                             ("deepwalk", "deepwalk"),
                                             ("line", "line")])
def test_mesh_trains_as_one_rank_group(tmp_path, dir_name, script):
    out = mesh_train(tmp_path, port_script(dir_name, script), metric="mrr")
    if dir_name in ("TransX", "distmult"):
        assert {"mr", "hit1", "hit3", "hit10"} <= set(out)
