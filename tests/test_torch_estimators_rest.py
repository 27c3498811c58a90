"""The Gae, Sample and Graph estimators of the PyTorch port against
euler_tpu on the CPU, on the toy and motif fixtures.

Training: the reference estimator's own ``train`` runs two single steps
from a flax tree (its batch source, its model, its optax Adam); each
step's draws are then made again from the keys its loop hands out (the
batch's key directly, the model's keys recorded from a trace), and the
port's ``step`` takes the same two steps on them: its batch source's
select (``select_nodes``, ``select_rows``, ``make_graph_batch``) on the
reference's uniforms, row indices or graph indices, its model on the
recorded draws, and its Adam. The batches must be equal, and the last
loss and every parameter within rtol = atol = 1e-5. Also held: the id
and sample files read as the reference reads them; evaluation and
inference through a flow that draws nothing (the whole graph), from the
same flax tree, within 1e-5 (accuracy and the embeddings written to
disk too); and on the CPU, loops of k steps equal to single steps from
the same seed, the graph estimator's dict batch included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.datasets.synthetic import MotifDataset
from euler_tpu.estimator import estimator as jax_est
from euler_tpu.models import autoencoders as jax_ae
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu.models import graph_model as jax_graph_model
from euler_tpu.models import pooling as jax_pooling
from euler_tpu_torch.dataflow import SageDataFlow, WholeDataFlow
from euler_tpu_torch.estimator import (GaeEstimator, GraphEstimator,
                                       RunConfig, SampleEstimator,
                                       get_optimizer)
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import (DGI, GAE, GNNNet, GraphModel,
                                    SegmentPool, Set2SetPool, ShallowEncoder,
                                    SolutionModel, load_flax_params)
from euler_tpu_torch.ops import sampling
from tests.test_torch_models_rest import (FEAT, JaxSolutionModel,
                                          init_tree, nbr_uniforms,
                                          pair,  # noqa: F401 (a fixture)
                                          reference)
from tests.test_torch_train import _as_port
from tests.test_torch_unsup import node_uniforms

TOL = dict(rtol=1e-5, atol=1e-5)


def whole_gnn_jax(conv="gcn", dims=(8, 8), feat="dense2"):
    return jax_gnn.GNNNet(
        conv=conv, flow=jax_flows.WholeDataFlow(1, [(0,)],
                                                layout="edge_list"),
        dims=dims, feature=jax_encoders.ShallowEncoder(
            dense_names=(feat,)))


def whole_gnn(conv="gcn", dims=(8, 8), feat="dense2", in_dim=2, seed=0):
    return GNNNet(conv, WholeDataFlow(1, [(0,)], layout="edge_list"), dims,
                  ShallowEncoder((feat,)), in_dim=in_dim, device="cpu",
                  generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def port_toy(toy_dir):
    return load_graph(toy_dir, device="cpu")


#: the settings both sides train with: single steps of Adam, no reservoir
#: redraw, no log line
TRAIN = dict(optimizer="adam", learning_rate=0.01, log_steps=0,
             reservoir_refresh=0)


def reference_training(ref, mj, tree, steps=2):
    """(last loss, final flax tree, each step's (batch key, batch, model
    keys)) of the reference estimator's ``train`` for ``steps`` single
    steps from ``tree``. Its loop splits PRNGKey(seed + 1) into each
    step's key and that into the batch's key and the model's
    (estimator.py:175-236); the model's keys are recorded from a trace
    of the model on the batch."""
    ref._params = tree
    ref._save = lambda step: None
    loss = ref.train(total_steps=steps, log_fn=lambda _: None)["loss"]
    g = ref.graph.tensors
    key = jax.random.PRNGKey(ref.config.seed + 1)
    draws = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        kb, ks = jax.random.split(sub)
        batch = ref.train_batch(g, kb)
        draws.append((kb, batch, reference(mj, tree, g, batch, key=ks)[2]))
    return loss, ref.params, draws


def assert_trains_alike(est, steps, want_loss, want):
    """The port's ``step`` over ``steps`` ((batch, uniforms) a step) with
    a fresh optimizer of its config: the last loss and every parameter
    against the reference's."""
    cfg = est.config
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate,
                        est.model.parameters())
    for batch, u in steps:
        loss = est.step(opt, batch, uniforms=u)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5, abs=1e-5)
    want = _as_port(est.model, want)
    assert want
    for name, p in est.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   err_msg=name, **TOL)


# ------------------------------------------------------------ GaeEstimator --

def test_gae_estimator_id_files_and_inference_match(toy_graph, port_toy,
                                                    tmp_path):
    path = tmp_path / "ids.txt"
    ids = np.array([0, 3, 5, 1, 2, 4])
    np.savetxt(path, ids, fmt="%d")
    np.testing.assert_array_equal(GaeEstimator.ids_from_file(str(path)),
                                  jax_est.GaeEstimator.ids_from_file(
                                      str(path)))
    mj = jax_ae.GAE(embedder=whole_gnn_jax(), edge_types=(0,), num_negs=2)
    ref = jax_est.GaeEstimator(mj, toy_graph, jax_est.RunConfig(
        model_dir=str(tmp_path / "ref"), batch_size=4))
    tree = init_tree(mj, toy_graph.tensors, jnp.arange(4, dtype=jnp.int32))
    ref._params = tree
    want = ref.infer_id_file(str(path), str(tmp_path / "ref_out"))
    model = load_flax_params(GAE(whole_gnn(), (0,), num_negs=2,
                                 device="cpu"),
                             jax.tree.map(np.asarray, tree))
    est = GaeEstimator(model, port_toy, RunConfig(batch_size=4),
                       device="cpu")
    got = est.infer_id_file(str(path), str(tmp_path / "out"))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(
        np.load(tmp_path / "out" / "embedding_0.npy"),
        np.load(tmp_path / "ref_out" / "embedding_0.npy"), **TOL)
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "ids_0.npy"),
                                  np.load(tmp_path / "ref_out" /
                                          "ids_0.npy"))
    res = est.evaluate_id_file(str(path))
    assert set(res) == {"f1", "loss"} and np.isfinite(res["loss"])


@pytest.mark.parametrize("kind", ["gae", "dgi"])
def test_gae_estimator_train_steps_match_the_reference(pair, tmp_path, kind):
    # the random graph, whose unit-scale features keep the logits off the
    # sigmoid's flat tails, so that each negative's place shows in the loss
    gj, gt = pair
    B, negs = 16, 3
    net_j, net_t = (whole_gnn_jax(feat="feature"),
                    whole_gnn(feat="feature", in_dim=FEAT))
    if kind == "gae":
        mj = jax_ae.GAE(embedder=net_j, edge_types=(0,), num_negs=negs)
        mt = GAE(net_t, (0,), num_negs=negs, device="cpu")
    else:
        mj = jax_ae.DGI(embedder=net_j, num_negs=negs)
        mt = DGI(net_t, num_negs=negs, device="cpu")
    ref = jax_est.GaeEstimator(mj, gj, jax_est.RunConfig(
        model_dir=str(tmp_path), batch_size=B, **TRAIN))
    tree = init_tree(mj, gj.tensors, jnp.arange(B, dtype=jnp.int32))
    want_loss, want, draws = reference_training(ref, mj, tree)
    load_flax_params(mt, jax.tree.map(np.asarray, tree))
    est = GaeEstimator(mt, gt, RunConfig(batch_size=B, **TRAIN),
                       device="cpu")
    steps = []
    for kb, batch, keys in draws:
        roots = sampling.select_nodes(gt.tensors, -1, *node_uniforms(kb, B))
        np.testing.assert_array_equal(roots.numpy(), np.asarray(batch))
        u_neg = node_uniforms(keys["node"][0], B * negs)
        steps.append((roots, [u_neg, None, None] if kind == "dgi" else
                      [nbr_uniforms(keys["nbr"][0], B), u_neg]))
    assert_trains_alike(est, steps, want_loss, want)


@pytest.mark.parametrize("cls", [GAE, DGI])
def test_gae_estimator_trains_in_loops_as_in_single_steps(port_toy, cls):
    def est(spl):
        net = whole_gnn(seed=1)
        model = cls(net, (0,), num_negs=2, device="cpu") if cls is GAE \
            else cls(net, num_negs=2, device="cpu",
                     generator=torch.Generator().manual_seed(2))
        return GaeEstimator(model, port_toy, RunConfig(
            batch_size=4, total_steps=6, steps_per_loop=spl, log_steps=0,
            reservoir_refresh=0, metric="mrr"), device="cpu")
    a, b = est(3), est(1)
    ra, rb = a.train(log_fn=lambda _: None), b.train(log_fn=lambda _: None)
    assert ra == rb and np.isfinite(ra["loss"])
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                 b.model.parameters()))
    res = a.evaluate(np.arange(6))
    assert set(res) == {"mrr", "loss"} and np.isfinite(res["mrr"])


# --------------------------------------------------------- SampleEstimator --

def sample_file(tmp_path, cols):
    rng = np.random.default_rng(cols)
    rows = rng.integers(0, 6, (9, cols))
    path = tmp_path / f"samples_{cols}.txt"
    np.savetxt(path, rows, fmt="%d", delimiter=",")
    return str(path)


@pytest.mark.parametrize("cols", [1, 3])
def test_sample_estimator_selects_the_reference_rows(toy_graph, port_toy,
                                                     tmp_path, cols):
    path = sample_file(tmp_path, cols)
    ref = jax_est.SampleEstimator(None, toy_graph, jax_est.RunConfig(
        batch_size=16), path)
    model = SolutionModel(whole_gnn(), "price", 1, device="cpu")
    est = SampleEstimator(model, port_toy, RunConfig(batch_size=16), path,
                          device="cpu")
    np.testing.assert_array_equal(est.samples.numpy(),
                                  np.asarray(ref._samples))
    key = jax.random.PRNGKey(5)
    want = ref.train_batch(toy_graph.tensors, key)
    idx = jax.random.randint(key, (16,), 0, ref._samples.shape[0])
    got = est.select_rows(torch.from_numpy(np.asarray(idx, np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == ((16,) if cols == 1 else (16, cols))
    drawn = est.draw_rows(torch.Generator().manual_seed(0))
    assert drawn.shape == (16,) and 0 <= int(drawn.min()) and \
        int(drawn.max()) < 9


def test_sample_estimator_train_steps_match_the_reference(toy_graph,
                                                          port_toy, tmp_path):
    B = 8
    path = sample_file(tmp_path, 1)
    mj = JaxSolutionModel(embedder=whole_gnn_jax(), label_name="price",
                          label_dim=1)
    ref = jax_est.SampleEstimator(mj, toy_graph, jax_est.RunConfig(
        model_dir=str(tmp_path), batch_size=B, **TRAIN), path)
    tree = init_tree(mj, toy_graph.tensors, jnp.arange(B, dtype=jnp.int32))
    want_loss, want, draws = reference_training(ref, mj, tree)
    mt = load_flax_params(SolutionModel(whole_gnn(), "price", 1,
                                        device="cpu"),
                          jax.tree.map(np.asarray, tree))
    est = SampleEstimator(mt, port_toy, RunConfig(batch_size=B, **TRAIN),
                          path, device="cpu")
    steps = []
    for kb, batch, _ in draws:
        idx = jax.random.randint(kb, (B,), 0, est.samples.shape[0])
        roots = est.select_rows(torch.from_numpy(np.asarray(idx, np.int64)))
        np.testing.assert_array_equal(roots.numpy(), np.asarray(batch))
        steps.append((roots, None))
    assert_trains_alike(est, steps, want_loss, want)


def test_sample_estimator_trains_the_solution_model(port_toy, tmp_path):
    path = sample_file(tmp_path, 1)

    def est(spl):
        model = SolutionModel(whole_gnn(seed=3), "price", 1, device="cpu",
                              generator=torch.Generator().manual_seed(3))
        return SampleEstimator(model, port_toy, RunConfig(
            batch_size=8, total_steps=4, steps_per_loop=spl, log_steps=0,
            reservoir_refresh=0), path, device="cpu")
    a, b = est(2), est(1)
    ra, rb = a.train(log_fn=lambda _: None), b.train(log_fn=lambda _: None)
    assert ra == rb and np.isfinite(ra["loss"])
    with pytest.raises(ValueError, match="empty"):
        SampleEstimator(a.model, port_toy, RunConfig(), np.zeros((0, 1)),
                        device="cpu")


# ---------------------------------------------------------- GraphEstimator --

@pytest.fixture(scope="module")
def motif(tmp_path_factory):
    ds = MotifDataset(str(tmp_path_factory.mktemp("motif_est")),
                      n_graphs=14, seed=6)
    return ds.load_graph(), load_graph(ds.data_dir, device="cpu")


def graph_models(gj, pool, B):
    """(reference GraphModel, its flax tree, the port's GraphModel with
    that tree): gin over the whole graph, ``pool`` over ``B`` graphs."""
    net_j = jax_gnn.GNNNet(
        conv="gin", flow=jax_flows.WholeDataFlow(1, [(0,)],
                                                 layout="edge_list"),
        dims=(8, 8), feature=jax_encoders.ShallowEncoder(
            dense_names=("feature",)))
    if pool == "set2set":
        pj, pt = jax_pooling.Set2SetPool(dim=8, num_graphs=B), \
            Set2SetPool(8, B, 8)
    else:
        pj, pt = jax_pooling.SegmentPool(aggr="mean", num_graphs=B), \
            SegmentPool(8, B, "mean")
    mj = jax_graph_model.GraphModel(embedder=net_j, pool=pj, label_dim=2)
    batch = jax_est.make_graph_batch(gj.tensors,
                                     jnp.arange(B, dtype=jnp.int32),
                                     "label", 2)
    tree = init_tree(mj, gj.tensors, batch)
    mt = load_flax_params(GraphModel(whole_gnn("gin", feat="feature",
                                               in_dim=4), pt, 2,
                                     device="cpu"),
                          jax.tree.map(np.asarray, tree))
    return mj, tree, mt


@pytest.mark.parametrize("pool", ["mean", "set2set"])
def test_graph_estimator_train_steps_match_the_reference(motif, tmp_path,
                                                         pool):
    gj, gt = motif
    B = 4
    mj, tree, mt = graph_models(gj, pool, B)
    ref = jax_est.GraphEstimator(mj, gj, jax_est.RunConfig(
        model_dir=str(tmp_path), batch_size=B, **TRAIN),
        label_name="label", num_classes=2)
    want_loss, want, draws = reference_training(ref, mj, tree)
    est = GraphEstimator(mt, gt, RunConfig(batch_size=B, **TRAIN),
                         label_name="label", num_classes=2, device="cpu")
    steps = []
    for kb, batch, _ in draws:
        gidx = jax.random.randint(kb, (B,), 0, gt.tensors.graph_members
                                  .shape[0], dtype=jnp.int32)
        got = est.make_batch(gt.tensors, torch.from_numpy(np.array(gidx)))
        assert set(got) == set(batch)
        for name, v in got.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(batch[name]),
                                          err_msg=name)
        steps.append((got, None))
    assert_trains_alike(est, steps, want_loss, want)


@pytest.mark.parametrize("pool", ["mean", "set2set"])
def test_graph_estimator_evaluate_and_infer_match(motif, tmp_path, pool):
    gj, gt = motif
    B = 4
    mj, tree, model = graph_models(gj, pool, B)
    pt = model.pool
    ref = jax_est.GraphEstimator(mj, gj, jax_est.RunConfig(
        model_dir=str(tmp_path / "ref"), batch_size=B), label_name="label",
        num_classes=2)
    ref._params = tree
    graphs = np.array([0, 5, 2, 13, 7, 1, 9])
    want = ref.evaluate(graphs)
    want_emb = ref.infer(graphs, str(tmp_path / "ref_out"))
    est = GraphEstimator(model, gt, RunConfig(batch_size=B),
                         label_name="label", num_classes=2, device="cpu")
    got = est.evaluate(graphs)
    assert set(got) == set(want) == {"accuracy", "loss"}
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-7)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5, abs=1e-5)
    emb = est.infer(graphs, str(tmp_path / "out"))
    assert emb.shape == (len(graphs), pt.out_dim)
    np.testing.assert_allclose(emb, np.asarray(want_emb), **TOL)
    for name in ("embedding_0.npy", "ids_0.npy"):
        np.testing.assert_allclose(
            np.load(tmp_path / "out" / name),
            np.load(tmp_path / "ref_out" / name), **TOL)


def test_graph_estimator_trains_dict_batches_in_loops(motif):
    _, gt = motif

    def est(spl):
        net = GNNNet("gin", SageDataFlow([2, 2], [(0,), (0,)]), (8, 8, 8),
                     ShallowEncoder(("feature",)), in_dim=4, device="cpu",
                     generator=torch.Generator().manual_seed(4))
        model = GraphModel(net, Set2SetPool(8, 6, 8,
                                            generator=torch.Generator()
                                            .manual_seed(5)), 2,
                           device="cpu",
                           generator=torch.Generator().manual_seed(6))
        return GraphEstimator(model, gt, RunConfig(
            batch_size=6, total_steps=6, steps_per_loop=spl, log_steps=0,
            reservoir_refresh=0), device="cpu")
    a, b = est(3), est(1)
    batch = a.train_batch(gt.tensors, torch.Generator().manual_seed(0))
    assert set(batch) == {"node_ids", "mask", "node_graph_idx", "label"}
    ra, rb = a.train(log_fn=lambda _: None), b.train(log_fn=lambda _: None)
    assert ra == rb and np.isfinite(ra["loss"])
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                 b.model.parameters()))
    res = a.evaluate(np.arange(14))
    assert 0.0 <= res["accuracy"] <= 1.0 and np.isfinite(res["loss"])
