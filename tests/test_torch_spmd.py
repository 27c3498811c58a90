"""The mesh estimators and per-rank graph loading over a CPU mesh of
gloo ranks, started once per mesh (``data=1, graph=4`` and ``data=2,
graph=2``; tests/test_torch_mesh_ranks.py).

- ``load_graph_sharded``: each rank reads only the partitions of its
  shard from a 4-partition conversion, and its shard equals
  ``build_sharded``'s over the whole graph, at 4 shards and at 2 (rows
  re-routed by ``local_id % S``; tests/test_multihost.py:158-195);
  ``health_check`` returns ok over every rank.
- The estimator surface (tests/test_spmd_estimator.py:42-84):
  ``SpmdNodeEstimator`` (sage, loops of 2 steps, a reservoir redraw,
  saves), ``SpmdEdgeEstimator`` (TransE with its entity table split over
  the graph axis, with ``evaluate_ranking``) and ``SpmdGraphEstimator``
  (gin) train, evaluate ids padded to the global batch with -1 rows,
  infer one row an id, and a second estimator restores the mesh
  checkpoint the first wrote; replicated parameters stay bit-equal
  across ranks, a graph-sharded block differs by shard.
- Evaluate and infer against the one-device estimators on the trained
  weights, over id lists that take several global batches, the last one
  padded with -1 rows: a gcn over whole-graph blocks (no draws) through
  ``SpmdNodeEstimator`` against ``NodeEstimator`` (metric, the loss over
  the live rows, embeddings), and the TransE case against
  ``EdgeEstimator`` (embeddings, the full-entity mean rank) with its
  entity table assembled from the ranks' blocks.

In this process: ``_mean_loss``, the accounting's table and predicted
efficiency, and a one-rank job through ``initialize``,
``make_global_mesh``, ``sync_hosts`` and ``health_check``.
"""
import os

import numpy as np
import pytest
import torch

from euler_tpu_torch.datasets import MotifDataset, random_graph
from euler_tpu_torch.estimator import (EdgeEstimator, NodeEstimator,
                                       RunConfig, SpmdEstimator)
from euler_tpu_torch.graph import convert, load_graph
from euler_tpu_torch.parallel import comms, distributed, sharded
from euler_tpu_torch.parallel import mesh as mesh_lib
from tests import test_torch_mesh_ranks as ranks
from tests.test_multihost import _make_graph_json
from tests.test_torch_sharded import APPLY

MESHES = {"g4": (1, 4), "d2g2": (2, 2)}
TIMEOUT_S = 240
PER_RANK = 4               # batch rows a rank
LOAD_FIELDS = ("node_type", "group_ptr", "adj_dst", "adj_w", "eid_sorted",
               "shard_node_w", "shard_edge_w")
TRANSE = dict(model="transe", seed=0, r=1, dim=8, num_negs=3)
GCN = dict(model="gcn", seed=0, dim=8, feat_dim=APPLY["feat_dim"],
           label_dim=APPLY["label_dim"])
ESTIMATOR = {"gcn": "node"}          # a case's estimator, where not its name
TOL = dict(rtol=1e-5, atol=1e-5)


def estimator_cases(work, W, n_nodes, n_graphs, n_entities):
    """(cases, arrays) of the three estimators."""
    rng = np.random.default_rng(5)
    cases, arrays = [], {}
    node_ids = rng.integers(0, n_nodes, 37).astype(np.int32)
    triples = np.stack([rng.integers(0, n_entities, 21),
                        rng.integers(0, n_entities, 21),
                        np.zeros(21, np.int64)], 1).astype(np.int32)
    graph_ids = np.arange(n_graphs, dtype=np.int32)
    for kind, graph, opts, ev, inf in (
            ("node", "apply", dict(APPLY, model="sage", metric="f1",
                                   spl=2, refresh=2, save=4, total=6),
             node_ids, node_ids[:11]),
            ("edge", "apply", dict(TRANSE, n=n_entities, metric="mrr",
                                   spl=2, total=4),
             triples, triples),
            ("gcn", "apply", dict(GCN, metric="f1", total=4),
             node_ids, node_ids),
            ("graph", "motif", dict(model="graph", seed=0, dim=8,
                                    feat_dim=4, fanouts=[3], b=PER_RANK,
                                    n_classes=2, metric="accuracy",
                                    total=4), graph_ids, graph_ids[:13])):
        name = f"est_{kind}"
        cases.append(dict(name=name, verb="estimator", graph=graph,
                          opts=dict(opts, kind=ESTIMATOR.get(kind, kind),
                                    batch=W * PER_RANK,
                                    few=3,
                                    model_dir=os.path.join(work, name),
                                    infer_dir=os.path.join(work, name,
                                                           "emb"))))
        arrays.update({f"{name}/eval_ids": np.stack([ev] * W),
                       f"{name}/infer_ids": np.stack([inf] * W)})
    return cases, arrays, dict(node=len(node_ids[:11]),
                               edge=len(triples), gcn=len(node_ids),
                               graph=len(graph_ids[:13]))


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_run(request, tmp_path_factory):
    data, graph = MESHES[request.param]
    W = data * graph
    work = str(tmp_path_factory.mktemp(request.param))
    parts = os.path.join(work, "parts")
    convert.convert_json_graph(_make_graph_json(seed=1), parts,
                               n_partitions=4, build_in_edges=False)
    whole = load_graph(parts, device="cpu")
    ga = random_graph(160, 6, feat_dim=APPLY["feat_dim"],
                      n_classes=APPLY["label_dim"], seed=2, device="cpu")
    motif = MotifDataset(os.path.join(work, "motif"), n_graphs=24, seed=3)
    gm = motif.load_graph(device="cpu")
    cases, arrays, n_infer = estimator_cases(
        work, W, ga.meta.n_nodes, gm.tensors.graph_members.shape[0],
        ga.meta.n_nodes)
    cases.insert(0, dict(name="load", verb="load", opts=dict(path=parts)))
    ranks.write_work(work, data, graph,
                     dict(apply=sharded.build_sharded(ga, graph),
                          motif=sharded.build_sharded(gm, graph)),
                     arrays, cases, TIMEOUT_S / 2)
    want = sharded.build_sharded(whole, graph)
    return dict(outs=ranks.launch(work, W, TIMEOUT_S), W=W, graph=graph,
                want=want, work=work, n_infer=n_infer, ga=ga,
                arrays=arrays, cases={c["name"]: c for c in cases},
                dense=sorted(whole.tensors.dense_nf))


def outputs(run, case: str, rank: int):
    got = run["outs"][rank]
    n = sum(1 for k in got if k.startswith(case + "/"))
    return [got[f"{case}/{i}"] for i in range(n)]


def test_load_graph_sharded_equals_build_sharded(mesh_run):
    sg = mesh_run["want"]
    for r in range(mesh_run["W"]):
        got = outputs(mesh_run, "load", r)
        s = r % mesh_run["graph"]
        for name, arr in zip(LOAD_FIELDS, got):
            want = getattr(sg, name)
            want = want if name.startswith("shard_") else want[s]
            np.testing.assert_array_equal(arr, want, err_msg=f"{name} {r}")
        for name, arr in zip(mesh_run["dense"], got[len(LOAD_FIELDS) + 1:]):
            np.testing.assert_array_equal(arr, sg.dense_nf[name][s])


def test_health_check_is_ok(mesh_run):
    for r in range(mesh_run["W"]):
        ok, devices, timed = outputs(mesh_run, "load", r)[len(LOAD_FIELDS)]
        assert ok == 1 and devices == mesh_run["W"] and timed == 1


@pytest.mark.parametrize("kind", ["node", "edge", "gcn", "graph"])
def test_estimator_trains_evaluates_infers_restores(mesh_run, kind):
    name = f"est_{kind}"
    W = mesh_run["W"]
    per = [outputs(mesh_run, name, r) for r in range(W)]
    n_state = (len(per[0]) - 2) // 3
    for r, got in enumerate(per):
        scalars, emb = got[0], got[1]
        before = got[2:2 + n_state]
        after = got[2 + n_state:2 + 2 * n_state]
        restored = got[2 + 2 * n_state:]
        loss, ev_loss, few_loss, metric, n_sharded, mr = scalars
        assert np.isfinite([loss, ev_loss, few_loss, metric]).all()
        assert n_sharded == (1 if kind == "edge" else 0)
        if kind == "edge":
            assert 1 <= mr <= 160          # the apply graph's entities
        assert emb.shape[0] == mesh_run["n_infer"][kind]
        assert np.isfinite(emb).all()
        assert any(not np.array_equal(a, b) for a, b in zip(before, after))
        for a, b in zip(after, restored):
            np.testing.assert_array_equal(a, b)
        # every rank returns the whole batch's outputs, the same
        np.testing.assert_array_equal(emb, per[0][1])
        np.testing.assert_array_equal(scalars, per[0][0])
    saved = np.load(os.path.join(mesh_run["work"], name, "emb",
                                 "embedding_0.npy"))
    np.testing.assert_array_equal(saved, per[0][1])


def test_graph_sharded_blocks_differ_and_the_rest_is_replicated(mesh_run):
    """The edge estimator's state: each graph group member holds its own
    block of the entity table, the data replicas of a shard the same
    one; every replicated tensor is bit-equal on every rank."""
    per = [outputs(mesh_run, "est_edge", r) for r in range(mesh_run["W"])]
    n_state = (len(per[0]) - 2) // 3
    S = mesh_run["graph"]
    names = sorted(ranks.build_model(dict(TRANSE, n=160)).state_dict())
    table = names.index("entity_encoder.embedding")
    for r, got in enumerate(per):
        after = got[2 + n_state:2 + 2 * n_state]
        first = per[r % S][2 + n_state:2 + 2 * n_state]
        for i, (a, b) in enumerate(zip(after, per[0][2 + n_state:])):
            if i != table:
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(after[table], first[table])
        if r % S:
            assert not np.array_equal(after[table],
                                      per[0][2 + n_state + table])


def trained_model(run, name: str):
    """(the case's options, a one-device model on the CPU holding the
    weights its ranks trained): replicated tensors from rank 0, a
    graph-sharded table assembled from the blocks (row r is local row
    r // S of shard r % S)."""
    opts = run["cases"][name]["opts"]
    model = ranks.build_model(opts)
    per = [outputs(run, name, r) for r in range(run["W"])]
    n_state = (len(per[0]) - 2) // 3
    state = model.state_dict()
    S = run["graph"]
    for i, k in enumerate(sorted(state)):
        blocks = [torch.from_numpy(per[g][2 + n_state + i])
                  for g in range(S)]
        if blocks[0].shape == state[k].shape:
            state[k] = blocks[0]
        else:
            rows = torch.arange(state[k].shape[0])
            state[k] = torch.stack(blocks)[rows % S, rows // S]
    model.load_state_dict(state)
    return opts, model, per[0][0]


def live_row_loss(est, model, ids) -> float:
    """The one-device model's loss over the live rows of ``ids``, taken
    in the estimator's padded batches (each batch's masked loss weighted
    by its live rows)."""
    B = est.config.batch_size
    model.eval()
    with torch.no_grad():
        outs, n = est._batched_apply(
            ids, lambda g, b, gen: model(g, b, generator=gen))
    live = [min(B, n - i) for i in range(0, n, B)]
    return sum(float(o["loss"]) * c for o, c in zip(outs, live)) / n


def test_node_evaluate_and_infer_equal_the_one_device_estimator(mesh_run):
    """gcn over whole-graph blocks, without draws: the mesh's metric, its
    loss over the live rows (of all ids and of a few, which leave whole
    ranks to pad rows) and its embeddings equal ``NodeEstimator``'s on
    the same weights, over ids taking several padded global batches."""
    name = "est_gcn"
    opts, model, scalars = trained_model(mesh_run, name)
    ids = mesh_run["arrays"][f"{name}/eval_ids"][0]
    assert len(ids) > 2 * opts["batch"] and len(ids) % opts["batch"]
    est = NodeEstimator(model, mesh_run["ga"],
                        RunConfig(batch_size=opts["batch"],
                                  metric=opts["metric"]), device="cpu")
    _, ev_loss, few_loss, metric = scalars[:4]
    np.testing.assert_allclose(metric, est.evaluate(ids)["f1"], **TOL)
    np.testing.assert_allclose(ev_loss, live_row_loss(est, model, ids),
                               **TOL)
    np.testing.assert_allclose(
        few_loss, live_row_loss(est, model, ids[:opts["few"]]), **TOL)
    for r in range(mesh_run["W"]):
        np.testing.assert_allclose(outputs(mesh_run, name, r)[1],
                                   est.infer(ids), err_msg=f"rank {r}",
                                   **TOL)


def test_edge_infer_and_ranking_equal_the_one_device_estimator(mesh_run):
    """TransE with its entity table split over the graph axis: the mesh's
    embeddings of triples taking two padded global batches and its
    full-entity mean rank equal ``EdgeEstimator``'s on the assembled
    table."""
    name = "est_edge"
    opts, model, scalars = trained_model(mesh_run, name)
    triples = mesh_run["arrays"][f"{name}/infer_ids"][0]
    assert len(triples) > opts["batch"] and len(triples) % opts["batch"]
    est = EdgeEstimator(model, mesh_run["ga"],
                        RunConfig(batch_size=opts["batch"]), device="cpu")
    np.testing.assert_allclose(
        scalars[5], est.evaluate_ranking(
            mesh_run["arrays"][f"{name}/eval_ids"][0])["mr"], **TOL)
    for r in range(mesh_run["W"]):
        np.testing.assert_allclose(outputs(mesh_run, name, r)[1],
                                   est.infer(triples), err_msg=f"rank {r}",
                                   **TOL)


def test_mean_loss_weights_each_batch_by_its_live_rows():
    outs = [{"loss": torch.tensor(2.0)}, {"loss": torch.tensor(4.0)}]
    assert SpmdEstimator._mean_loss(outs, [3, 1]) == 2.5
    assert SpmdEstimator._mean_loss(outs, [0, 0]) == 0.0


def test_accounting_table_and_predicted_efficiency():
    acc = comms.Accounting()
    acc.add("psum", 4, 3e6)
    acc.add("all_to_all", 4, 1e6, comms.BACKWARD)
    acc.staged[comms.FORWARD] = 5e6
    assert acc.totals() == {"psum": 3_000_000, "all_to_all": 1_000_000,
                            "total": 4_000_000, "host_staged": 5e6}
    assert acc.totals(comms.BACKWARD)["total"] == 1_000_000
    table = acc.table()
    assert "psum" in table and "4.000 MB/step/rank" in table
    assert "host_staged" in table
    # 4 MB over 4 MB/s: a 1 s step predicts 1 / (1 + 1)
    assert acc.predicted_efficiency(1.0, 4e6) == 0.5


def test_one_rank_job_initializes_and_checks_health(tmp_path):
    distributed.initialize("file://" + str(tmp_path / "store"),
                           world_size=1, rank=0, device="cpu")
    try:
        m = distributed.make_global_mesh(device="cpu")
        assert (m.data, m.graph, m.data_index, m.graph_index) == (1, 1, 0, 0)
        distributed.sync_hosts(m)
        assert distributed.health_check(m)["ok"]
        with pytest.raises(ValueError, match="ranks"):
            distributed.make_global_mesh(data=2, device="cpu")
    finally:
        mesh_lib.close()
