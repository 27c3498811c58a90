"""The example runners of the PyTorch port against examples/: for
run_graphsage (supervised and ``--unsupervised``), run_gcn and run_rgcn,
the same flags build the same flow (class, fanouts, metapath, payload
and typed), the same model widths and convs, and the same estimator and
run config as the reference script; each runs ``train_and_evaluate`` on
the SBM stand-in on the CPU at small width, on one device and with
``--mesh auto`` (a one-rank group in this process, through the Spmd
estimators; ``mesh_train``), and ``--mesh 2x2`` without a launcher's
four ranks raises.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch.distributed as dist

from euler_tpu.models import convs as jax_convs
from euler_tpu_torch.examples import common
from euler_tpu_torch.examples.gcn import run_gcn
from euler_tpu_torch.examples.graphsage import run_graphsage
from euler_tpu_torch.examples.rgcn import run_rgcn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"graphsage": run_graphsage, "gcn": run_gcn, "rgcn": run_rgcn}
FLAGS = ["--dataset", "sbm", "--hidden_dim", "8", "--batch_size", "16",
         "--total_steps", "3", "--learning_rate", "0.005", "--log_steps", "2"]


def reference_script(name, script=None):
    """examples/<name>/run_<script or name>.py, imported as the script
    imports itself (its directory's parent on sys.path, ``common`` beside
    it)."""
    script = script or name
    path = os.path.join(REPO, "examples", name, f"run_{script}.py")
    spec = importlib.util.spec_from_file_location(f"ref_run_{script}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def built(main, common_mod, argv, monkeypatch):
    """The estimator that ``main(argv)`` hands to ``_dispatch``."""
    seen = []
    monkeypatch.setattr(common_mod, "_dispatch",
                        lambda args, ds, est: seen.append(est) or est)
    main(argv)
    return seen[0]


def flow_of(est):
    model = est.model
    net = getattr(model, "embedder", model)
    return net, net.flow


CASES = [("graphsage", []), ("graphsage", ["--unsupervised"]),
         ("gcn", []), ("rgcn", ["--fanouts", "3", "2"])]


@pytest.mark.parametrize("name,extra", CASES,
                         ids=["sage", "unsup", "gcn", "rgcn"])
def test_flags_build_the_reference_flow_widths_and_estimator(
        tmp_path, monkeypatch, name, extra):
    ref = reference_script(name)
    argv = FLAGS + extra + ["--data_dir", str(tmp_path / "ref"),
                            "--model_dir", str(tmp_path / "mref")]
    want = built(ref.main, sys.modules["common"], argv, monkeypatch)
    argv = FLAGS + extra + ["--data_dir", str(tmp_path / "port"),
                            "--model_dir", str(tmp_path / "mport"),
                            "--device", "cpu"]
    got = built(SCRIPTS[name].main, common, argv, monkeypatch)
    assert type(got).__name__ == type(want).__name__
    for k in ("batch_size", "total_steps", "optimizer", "learning_rate",
              "log_steps", "metric", "model_dir", "profile"):
        w = getattr(want.config, k)
        if k == "model_dir":
            w = w.replace("mref", "mport")
        assert getattr(got.config, k) == w, k
    assert got.train_node_type == want.train_node_type
    (net, flow), (jnet, jflow) = flow_of(got), flow_of(want)
    assert type(flow).__name__ == type(jflow).__name__
    assert [tuple(m) for m in flow.metapath] == \
        [tuple(m) for m in jflow.metapath]
    for attr in ("fanouts", "payload", "typed", "cap", "layout",
                 "add_self_loops"):
        assert getattr(flow, attr, None) == getattr(jflow, attr, None), attr
    assert tuple(net.dims) == tuple(jnet.dims)
    assert net.relation_from_etype == jnet.relation_from_etype
    conv = jax_convs.get_conv_class(jnet.conv).__name__
    assert {type(c).__name__ for c in net.convs} == {conv}
    if name == "graphsage" and extra:
        assert got.model.edge_types == want.model.edge_types
        assert got.model.num_negs == want.model.num_negs
    else:
        assert got.model.label_dim == want.model.label_dim


@pytest.mark.parametrize("name,extra", CASES,
                         ids=["sage", "unsup", "gcn", "rgcn"])
def test_train_and_evaluate_runs_on_the_stand_in(tmp_path, name, extra):
    out = SCRIPTS[name].main(
        FLAGS + extra + ["--data_dir", str(tmp_path), "--device", "cpu",
                         "--model_dir", str(tmp_path / "m"),
                         "--run_mode", "train_and_evaluate"])
    metric = "mrr" if extra == ["--unsupervised"] else "f1"
    assert set(out) == {"loss", "steps", metric} and out["steps"] == 3
    assert all(np.isfinite(v) for v in out.values())
    assert os.path.isdir(tmp_path / "m" / "ckpt")


def test_infer_writes_the_test_embeddings(tmp_path):
    out = run_graphsage.main(FLAGS + [
        "--data_dir", str(tmp_path), "--device", "cpu", "--run_mode",
        "infer", "--model_dir", str(tmp_path / "m"), "--infer_dir",
        str(tmp_path / "emb")])
    ids = np.load(tmp_path / "emb" / "ids_0.npy")
    emb = np.load(tmp_path / "emb" / "embedding_0.npy")
    assert out["embeddings"] == emb.shape == (len(ids), 8)
    assert np.isfinite(emb).all()


def test_graph_conv_example_runs(tmp_path):
    out = common.run_graph_conv_example(
        "gin", "mean", argv=["--batch_size", "8", "--total_steps", "2",
                             "--hidden_dim", "8", "--device", "cpu",
                             "--data_dir", str(tmp_path), "--model_dir",
                             str(tmp_path / "m"), "--run_mode",
                             "train_and_evaluate"])
    assert set(out) == {"loss", "steps", "accuracy"}


def mesh_train(tmp_path, script, extra=(), metric=None):
    """``script`` with ``--mesh auto``: train_and_evaluate as a one-rank
    group in this process through the Spmd estimator, a mesh checkpoint
    (``ckpt/<step>/mesh.json``), and the group left at the end; then
    ``--mesh 2x2``, which needs four ranks, raises."""
    flags = FLAGS + list(extra) + ["--data_dir", str(tmp_path), "--device",
                                   "cpu", "--model_dir", str(tmp_path / "m")]
    out = script.main(argv=flags + ["--mesh", "auto", "--run_mode",
                                    "train_and_evaluate"])
    assert out["steps"] == 3 and (metric is None or metric in out)
    assert all(np.isfinite(v) for v in out.values())
    assert os.path.exists(tmp_path / "m" / "ckpt" / "3" / "mesh.json")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="rank count"):
        script.main(argv=flags + ["--mesh", "2x2"])
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_mesh_trains_as_one_rank_group(tmp_path, name):
    mesh_train(tmp_path, SCRIPTS[name], metric="f1")
