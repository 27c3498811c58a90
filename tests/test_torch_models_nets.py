"""Layers (with flax's LSTM cell), aggregators, pooling, the solution
kit's functions, the group nets, GeniePath and LGCN of the PyTorch port
against euler_tpu in f32 on the CPU, with the helpers of
tests/test_torch_models_rest.py.

Each reference module's flax tree is traced (``jax.eval_shape``, not
compiled), filled with numpy draws and loaded into the port
(``load_flax_params``); a reference that draws inside has its flow keys
recorded and replayed as uniforms. Forward, loss and every gradient must
agree within rtol = atol = 1e-5; the LSTM cell's parameters must have
flax's names and shapes exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.models import aggregators as jax_agg
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import extra_nets as jax_extra
from euler_tpu.models import gnn as jax_gnn
from euler_tpu.models import group_gnn as jax_group
from euler_tpu.models import layers as jax_layers
from euler_tpu.models import pooling as jax_pooling
from euler_tpu.models import solution as jax_solution
from euler_tpu_torch.dataflow import SageDataFlow, WholeDataFlow
from euler_tpu_torch.models import (AttentionPool, AttLayer, CosineLogits,
                                    DenseLogits, Embedding,
                                    GeniePathLazyNet, GroupGNNNet,
                                    HashEmbedding, LGCNNet, LSTMCell,
                                    LSTMLayer, PosNegLogits, SegmentPool,
                                    Set2SetPool, ShallowEncoder,
                                    ShardedEmbedding, SharedGroupGNNNet,
                                    SparseEmbedding, SuperviseModel,
                                    load_flax_params)
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.models import aggregators, solution
from euler_tpu_torch.parallel import sharded, train
from tests import test_torch_mesh_ranks
from tests.test_torch_models_rest import (FANOUTS, FEAT, CLASSES, TOL,
                                          Recording, check_model, close,
                                          grads_match, init_tree,
                                          jax_sage_flow, nbr_uniforms, pair,
                                          port_sage, reference, roots, t)
from tests.test_torch_models import hop_uniforms
from tests.test_torch_unsup import node_uniforms


# ------------------------------------------------------------------ layers --

def test_lstm_cell_has_flax_layout_and_values():
    cell = jax_layers.nn.OptimizedLSTMCell(features=6)
    x = np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32)
    h0 = np.random.default_rng(1).normal(size=(4, 6)).astype(np.float32)
    c0 = np.random.default_rng(2).normal(size=(4, 6)).astype(np.float32)
    carry = (jnp.asarray(c0), jnp.asarray(h0))
    tree = init_tree(cell, carry, jnp.asarray(x))
    want_carry, want = cell.apply(tree, carry, jnp.asarray(x))
    port = LSTMCell(5, 6)
    flax_names = {f"gates.{g}.{'weight' if k == 'kernel' else 'bias'}":
                  v.shape[::-1] for g, sub in tree["params"].items()
                  for k, v in sub.items()}
    assert {n: tuple(p.shape) for n, p in port.named_parameters()} == \
        flax_names
    assert sorted(n for n in flax_names if n.endswith("bias")) == [
        f"gates.h{g}.bias" for g in "fgio"]
    load_flax_params(port, jax.tree.map(np.asarray, tree))
    (c, h), y = port((t(c0), t(h0)), t(x))
    close(y, want)
    close(c, want_carry[0])
    close(h, want_carry[1])
    z = port.zero_carry(3, t(x))
    assert all(v.shape == (3, 6) and not v.any() for v in z)


def test_lstm_layer_matches():
    x = np.random.default_rng(3).normal(size=(3, 4, 5)).astype(np.float32)
    mj = jax_layers.LSTMLayer(out_dim=6)
    tree = init_tree(mj, jnp.asarray(x))

    def f(p, x):
        ys, carry = mj.apply(p, x)
        return (ys.sum() + carry[0].sum()), (ys, carry)
    (_, (ys, carry)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        tree, jnp.asarray(x))
    port = load_flax_params(LSTMLayer(5, 6, device="cpu"),
                            jax.tree.map(np.asarray, tree))
    got, (c, h) = port(t(x))
    close(got, ys)
    close(c, carry[0])
    close(h, carry[1])
    (got.sum() + c.sum()).backward()
    grads_match(port, grads)


def mesh_branch(port, tree, ids, weight, tmp_path):
    """The table laid out over a one-rank mesh and read over its view
    (the owner exchange of the mesh branch) gives the one-device rows;
    its gradient is the clipped rows' (the mesh branch clips ids past
    the table, layers.py:116, so their rows take a gradient); unlaid, a
    view raises, and laid out, a plain graph does."""
    g = random_graph(12, 2, device="cpu")
    with pytest.raises(ValueError, match="ShardView"):
        port(sharded.take_shard(sharded.build_sharded(g, 2), 0, "cpu"),
             t(ids))
    want = port(None, t(ids)).detach()
    with test_torch_mesh_ranks.one_rank_mesh(str(tmp_path)) as mesh:
        view = train.place_sharded_graph(sharded.build_sharded(g, 1), mesh)
        train.init_sharded_params(port, mesh)
        load_flax_params(port, jax.tree.map(np.asarray, tree))
        got = port(view, t(ids))
        torch.nansum(got * t(weight)).backward()
        with pytest.raises(ValueError, match="ShardView"):
            port(g.tensors, t(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    expect = np.zeros((port.num, port.dim), np.float32)
    ok = ids >= 0
    np.add.at(expect, np.minimum(ids[ok], port.num - 1), weight[ok])
    np.testing.assert_allclose(port.embedding.grad.numpy(), expect,
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["embedding", "sparse_sum", "sparse_mean",
                                  "hash", "hash_sparse_mean", "sharded"])
def test_embedding_layers_match(kind, tmp_path):
    rng = np.random.default_rng(4)
    if kind == "embedding":
        mj, ids = jax_layers.Embedding(max_id=9, dim=4), [3, -1, 9, 0, 11]
        port = Embedding(9, 4, device="cpu")
    elif kind.startswith("sparse"):
        comb = kind.split("_")[1]
        mj = jax_layers.SparseEmbedding(max_id=9, dim=4, combiner=comb)
        port = SparseEmbedding(9, 4, comb, device="cpu")
        ids = [[1, 2, -1], [-1, -1, -1], [9, 9, 4], [0, 11, -1]]
    elif kind.startswith("hash"):
        sparse = "sparse" in kind
        mj = jax_layers.HashEmbedding(buckets=5, dim=4, combiner="mean",
                                      sparse=sparse)
        port = HashEmbedding(5, 4, "mean", sparse, device="cpu")
        ids = [[17, 3, -1], [-1, -1, -1]] if sparse else [17, -1, 4, 1000]
    else:
        mj = jax_layers.ShardedEmbedding(num=7, dim=4)
        port = ShardedEmbedding(7, 4, device="cpu")
        ids = [[3, -1], [6, 9]]
    ids = np.asarray(ids, np.int32)
    args = (None, jnp.asarray(ids)) if kind == "sharded" else (
        jnp.asarray(ids),)
    tree = init_tree(mj, *args)
    wshape = jax.eval_shape(lambda: mj.apply(tree, *args)).shape
    weight = rng.normal(size=wshape).astype(np.float32)

    def f(p):
        out = mj.apply(p, *args)
        return jnp.nansum(out * weight), out
    (_, want), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(tree)
    load_flax_params(port, jax.tree.map(np.asarray, tree))
    got = port(None, t(ids)) if kind == "sharded" else port(t(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               equal_nan=True, **TOL)
    torch.nansum(got * t(weight)).backward()
    grads_match(port, grads)
    if kind == "sharded":
        mesh_branch(port, tree, ids, weight, tmp_path)


@pytest.mark.parametrize("masked", [True, False])
def test_att_layer_matches(masked):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [0, 1, 0, 1]], bool)
    mj = jax_layers.AttLayer(out_dim=3, hidden_dim=(4,), head_num=(2, 2))
    m = jnp.asarray(mask) if masked else None
    tree = init_tree(mj, jnp.asarray(x), m)

    def f(p):
        out = mj.apply(p, jnp.asarray(x), m)
        return (out ** 2).sum(), out
    (_, want), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(tree)
    port = load_flax_params(AttLayer(5, 3, (4,), (2, 2), device="cpu"),
                            jax.tree.map(np.asarray, tree))
    got = port(t(x), t(mask) if masked else None)
    close(got, want)
    (got ** 2).sum().backward()
    grads_match(port, grads)
    with pytest.raises(ValueError, match="head_num"):
        AttLayer(5, 3, (4,), (1,))


# ------------------------------------------------------------- aggregators --

@pytest.mark.parametrize("name,concat", [("gcn", False), ("mean", False),
                                         ("mean", True), ("meanpool", False),
                                         ("maxpool", False),
                                         ("maxpool", True)])
@pytest.mark.parametrize("masked", [True, False])
def test_aggregators_match(name, concat, masked):
    rng = np.random.default_rng(6)
    s = rng.normal(size=(5, 6)).astype(np.float32)
    nb = rng.normal(size=(5, 3, 6)).astype(np.float32)
    mask = rng.random((5, 3)) < 0.6
    mask[1] = False                            # a row with no neighbor
    kw = {} if name == "gcn" else dict(concat=concat)
    mj = jax_agg.get(name)(dim=4, **kw)
    m = jnp.asarray(mask) if masked else None
    tree = init_tree(mj, jnp.asarray(s), jnp.asarray(nb), m)

    def f(p):
        out = mj.apply(p, jnp.asarray(s), jnp.asarray(nb), m)
        return (out ** 2).sum(), out
    (_, want), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(tree)
    port = load_flax_params(aggregators.get(name)(6, 4, **kw),
                            jax.tree.map(np.asarray, tree))
    got = port(t(s), t(nb), t(mask) if masked else None)
    close(got, want)
    (got ** 2).sum().backward()
    grads_match(port, grads)


def test_masked_mean_divides_by_at_least_one():
    x = torch.ones(2, 3, 4)
    m = torch.tensor([[False] * 3, [True, False, False]])
    out = aggregators._masked_mean(x, m)
    assert torch.equal(out, torch.tensor([[0.0] * 4, [1.0] * 4]))


# ----------------------------------------------------------------- pooling --

GRAPH_INDEX = np.array([0, 0, 1, 1, 1, 2, 3, 3], np.int32)
POOL_MASK = np.array([1, 1, 1, 0, 1, 0, 1, 1], np.float32)


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "attention",
                                  "set2set"])
@pytest.mark.parametrize("masked", [True, False])
def test_pools_match(kind, masked):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    if kind == "attention":
        mj, port = (jax_pooling.AttentionPool(num_graphs=4),
                    AttentionPool(5, 4))
    elif kind == "set2set":
        mj, port = (jax_pooling.Set2SetPool(num_graphs=4, dim=3),
                    Set2SetPool(5, 4, 3))
    else:
        mj, port = (jax_pooling.SegmentPool(aggr=kind, num_graphs=4),
                    SegmentPool(5, 4, kind))
    m = POOL_MASK if masked else None
    args = (jnp.asarray(x), jnp.asarray(GRAPH_INDEX),
            None if m is None else jnp.asarray(m))
    tree = init_tree(mj, *args)
    xj = args[0]

    def f(p, x):
        out = mj.apply(p, x, *args[1:])
        return (out ** 2).sum(), out
    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(tree, xj)
    load_flax_params(port, jax.tree.map(np.asarray, tree))
    xt = t(x).requires_grad_()
    got = port(xt, t(GRAPH_INDEX), None if m is None else t(m))
    close(got, want)
    assert got.shape[1] == port.out_dim
    (got ** 2).sum().backward()
    close(xt.grad, gx)
    if kind in ("attention", "set2set"):
        grads_match(port, gp)


# ----------------------------------------- solution kit and group nets --

def test_solution_kit_functions_match():
    rng = np.random.default_rng(8)
    lg = rng.normal(size=(6, 3)).astype(np.float32)
    lab = (rng.random((6, 3)) < 0.5).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], bool)[:, None]
    neg = rng.normal(size=(6, 4)).astype(np.float32)
    pos_mask = mask.astype(np.float32)
    for args, fn in (((lg, lab), "sigmoid_loss"),
                     ((lg, lab, mask), "sigmoid_loss"),
                     ((lg[:, :1], neg), "xent_loss"),
                     ((lg[:, :1], neg, pos_mask), "xent_loss")):
        want = jax.jit(getattr(jax_solution, fn))(*map(jnp.asarray, args))
        close(getattr(solution, fn)(*map(t, args)), want, fn)
    a, b = rng.normal(size=(2, 5, 4)).astype(np.float32)
    b[1] = 0.0
    close(CosineLogits()(t(a), t(b)),
          jax.jit(jax_solution.CosineLogits().apply)({}, jnp.asarray(a),
                                                     jnp.asarray(b)))
    nb = rng.normal(size=(5, 3, 4)).astype(np.float32)
    for got, want in zip(PosNegLogits()(t(a), t(b), t(nb)),
                         jax.jit(jax_solution.PosNegLogits().apply)(
                             {}, jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(nb))):
        close(got, want)
    mj = jax_solution.DenseLogits(3)
    tree = init_tree(mj, jnp.asarray(a))
    port = DenseLogits(4, 3)
    with torch.no_grad():
        port.fc.weight.copy_(t(np.asarray(tree["params"]["Dense_0"]
                                          ["kernel"]).T))
    close(port(t(a)), jax.jit(mj.apply)(tree, jnp.asarray(a)))


def test_solution_samplers_match(pair, roots):
    gj, gt = pair
    key = jax.random.PRNGKey(4)
    (pos, ok), negs = jax.jit(lambda g, r: (
        jax_solution.sample_pos_with_types(g, key, r, (0,), 2),
        jax_solution.sample_neg_with_types(g, key, r, -1, 3)))(
        gj.tensors, jnp.asarray(roots))
    gp, gok = solution.select_pos_with_types(gt.tensors, t(roots), (0,),
                                             nbr_uniforms(key, len(roots), 2))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(gok.numpy(), np.asarray(ok))
    got = solution.select_neg_with_types(gt.tensors, t(roots), -1, 3,
                                         node_uniforms(key, 3 * len(roots)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(negs))


def test_shared_group_gnn_matches(pair, roots):
    gj, gt = pair
    flows = [Recording(jax_flows.SageDataFlow([3], [(0,)])), jax_sage_flow()]
    mj = jax_group.SharedGroupGNNNet(
        conv="sage", group_flows=tuple(flows), dims=(8, 8, 6),
        feature=jax_encoders.ShallowEncoder(dense_names=("feature",)))
    r2 = roots[:7]
    args = (gj.tensors, [jnp.asarray(roots), jnp.asarray(r2)])
    tree = init_tree(mj, *args)

    def f(p):
        for fl in flows:
            fl.keys.clear()
        outs = mj.apply(p, *args, rngs={"sample": jax.random.PRNGKey(3)})
        return sum((o ** 2).sum() for o in outs), (outs, [fl.keys[0]
                                                         for fl in flows])
    (_, (want, keys)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(tree)
    port = SharedGroupGNNNet(
        "sage", [SageDataFlow([3], [(0,)]), SageDataFlow(FANOUTS,
                                                         [(0,), (0,)])],
        (8, 8, 6), ShallowEncoder(("feature",)), in_dim=FEAT, device="cpu")
    load_flax_params(port, jax.tree.map(np.asarray, tree))
    u = [hop_uniforms(keys[0], len(roots), [3]),
         hop_uniforms(keys[1], len(r2), FANOUTS)]
    got = port(gt.tensors, [t(roots), t(r2)], uniforms=u)
    for a, b in zip(got, want):
        close(a, b)
    sum((o ** 2).sum() for o in got).backward()
    grads_match(port, grads)
    with pytest.raises(ValueError, match="whole dataflow"):
        SharedGroupGNNNet("sage", [WholeDataFlow(1, [(0,)])], (8, 8),
                          ShallowEncoder(("feature",)), in_dim=FEAT,
                          device="cpu")
    with pytest.raises(ValueError, match="2 flows"):
        port(gt.tensors, [t(roots)])
    with pytest.raises(ValueError, match="2 towers"):
        GroupGNNNet([port_sage(), port_sage()], device="cpu")(
            gt.tensors, [t(roots)])


@pytest.mark.parametrize("kind", ["geniepath", "lgcn"])
def test_extra_nets_match(pair, roots, kind):
    gj, gt = pair
    fanouts = [4, 3]
    flow = jax_sage_flow(fanouts)
    feat = jax_encoders.ShallowEncoder(dense_names=("feature",))
    port_flow = SageDataFlow(fanouts, [(0,), (0,)])
    if kind == "geniepath":
        net = jax_extra.GeniePathLazyNet(flow=flow, dims=(8, 6),
                                         feature=feat)
        pnet = GeniePathLazyNet(port_flow, (8, 6),
                                ShallowEncoder(("feature",)), in_dim=FEAT,
                                device="cpu")
    else:
        net = jax_extra.LGCNNet(flow=flow, dims=(8, 7, 6), feature=feat, k=3)
        pnet = LGCNNet(port_flow, (8, 7, 6), ShallowEncoder(("feature",)),
                       in_dim=FEAT, k=3, device="cpu")
    mj = jax_gnn.SuperviseModel(embedder=net, label_name="label",
                                label_dim=CLASSES)
    tree = init_tree(mj, gj.tensors, jnp.asarray(roots))
    want, grads, keys = reference(mj, tree, gj.tensors, jnp.asarray(roots),
                                  [flow])
    mt = load_flax_params(SuperviseModel(pnet, "label", CLASSES,
                                         device="cpu"),
                          jax.tree.map(np.asarray, tree))
    got = mt(gt.tensors, t(roots),
             uniforms=hop_uniforms(keys["flows"][0][0], len(roots), fanouts))
    check_model(mt, want, grads, got, ["embedding", "logit"])
