"""The rest of the model modules of the PyTorch port against euler_tpu in
f32 on the CPU: the graph classifier, the autoencoders, the solution kit
and its two example models, the group nets, GeniePath, LGCN and the
scalable nets (tests/test_torch_models_nets.py has the layers, the
aggregators and the pools, with these helpers).

Each reference module's flax tree is traced (``jax.eval_shape``, not
compiled), filled with numpy draws and loaded into the port
(``load_flax_params``). Where the reference draws inside a model, the
keys it hands ``sampling.sample_neighbor``, ``sample_node``, its flows
and ``jax.random.normal`` are recorded from inside the jitted
``value_and_grad`` and returned beside its outputs; the uniforms (and
normals) derived from them are replayed into the port. Forward, loss and
every gradient must agree within rtol = atol = 1e-5. The scalable stores
are compared after two SGD steps whose roots repeat: the port's write
lets a repeated root's last occurrence win, and so does the reference's
scatter on the CPU.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.estimator import estimator as jax_est
from euler_tpu.models import autoencoders as jax_ae
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu.models import graph_model as jax_graph_model
from euler_tpu.models import group_gnn as jax_group
from euler_tpu.models import layers as jax_layers
from euler_tpu.models import pooling as jax_pooling
from euler_tpu.models import scalable as jax_scalable
from euler_tpu.models import solution as jax_solution
from euler_tpu.ops import feature_ops as jax_feature_ops
from euler_tpu.ops import sampling as jax_sampling
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import make_graph_batch
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import (DGI, GAE, VGAE, AttentionPool, GNNNet,
                                    GraphModel, GroupGNNNet,
                                    SampleSolutionModel, ScalableSageNet,
                                    SegmentPool, Set2SetPool, ShallowEncoder,
                                    SolutionModel, SuperviseModel,
                                    load_flax_params)
from euler_tpu_torch.models.scalable import last_write_rows
from tests.test_torch_graph import native_off
from tests.test_torch_models import hop_uniforms
from tests.test_torch_unsup import node_uniforms

TOL = dict(rtol=1e-5, atol=1e-5)
PACKS = ("group", "adj", "sample", "fan")
N, FEAT, CLASSES, FANOUTS, NEGS = 300, 8, 4, [3, 2], 3


def fill(shapes, seed=0):
    """A flax tree of ``shapes`` with numpy normal values scaled by
    1/sqrt(fan)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: jnp.asarray(
        (rng.standard_normal(s.shape) * s.shape[-1] ** -0.5).astype(
            s.dtype)), shapes)


def init_tree(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda *a: module.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        *a, **kw), *args)
    return fill(shapes, seed)


def close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


def grads_match(port, grads):
    """Every parameter gradient of ``port`` against the reference's flax
    gradient tree (loaded into a copy of the port)."""
    import copy
    holder = load_flax_params(copy.deepcopy(port),
                              jax.tree.map(np.asarray, grads))
    want = dict(holder.named_parameters())
    names = [n for n, _ in port.named_parameters()]
    assert names
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        close(p.grad, want[name].detach(), name)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------- models that draw inside --

@pytest.fixture(scope="module")
def pair():
    kw = dict(feat_dim=FEAT, n_classes=CLASSES, seed=2, packs=PACKS)
    with native_off(("build_csr_native",)):
        return jax_random_graph(N, 12, **kw), random_graph(N, 12,
                                                           device="cpu", **kw)


@pytest.fixture(scope="module")
def roots():
    r = np.arange(3, 19, dtype=np.int32)
    r[5] = -1                                   # a padded batch row
    return r


class Recording:
    """Wraps a JAX flow and keeps the keys it is called with."""

    def __init__(self, flow):
        self.flow, self.keys = flow, []
        self.fanouts = getattr(flow, "fanouts", None)

    def __call__(self, g, key, roots):
        self.keys.append(key)
        return self.flow(g, key, roots)


@contextlib.contextmanager
def recorded(flows=()):
    """Record the keys of the reference's ``sample_neighbor``,
    ``sample_node`` and ``jax.random.normal`` calls (with the normals'
    shapes) while a model is traced, and of ``flows``."""
    rec = {"nbr": [], "node": [], "normal": []}
    real = (jax_sampling.sample_neighbor, jax_sampling.sample_node,
            jax.random.normal)

    def nbr(g, k, *a, **kw):
        rec["nbr"].append(k)
        return real[0](g, k, *a, **kw)

    def node(g, k, *a, **kw):
        rec["node"].append(k)
        return real[1](g, k, *a, **kw)

    def normal(k, shape, *a, **kw):
        rec["normal"].append((k, tuple(shape)))
        return real[2](k, shape, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sampling, "sample_neighbor", nbr)
        mp.setattr(jax_sampling, "sample_node", node)
        mp.setattr(jax.random, "normal", normal)
        rec["flows"] = flows
        yield rec


def reference(mj, tree, g, batch, flows=(), key=7):
    """(outputs, gradients, recorded keys) of one apply of ``mj`` whose
    sample key is ``PRNGKey(key)`` for an int ``key``, else ``key``."""
    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    with recorded(flows) as rec:
        def loss_fn(p, g, batch):
            for v in list(rec.values())[:3]:
                v.clear()
            for f in flows:
                f.keys.clear()
            out = mj.apply(p, g, batch,
                           rngs={"sample": key})
            keys = dict(nbr=list(rec["nbr"]), node=list(rec["node"]),
                        normal=[k for k, _ in rec["normal"]],
                        flows=[list(f.keys) for f in flows])
            return out["loss"], (out, keys)

        (_, (out, keys)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(tree, g, batch)
        # the normals' shapes are static, recorded when the step was traced
        keys["normal_shapes"] = [s for _, s in rec["normal"]]
    return out, grads, keys


def nbr_uniforms(key, B, count=1):
    """(u_type, u1, u2) [B, count] of the reference's sample_neighbor."""
    kt, kd = jax.random.split(key)
    k1, k2 = jax.random.split(kd)
    return tuple(t(np.array(jax.random.uniform(k, (B, count))))
                 for k in (kt, k1, k2))


def sage_net(flow, conv="sage"):
    return jax_gnn.GNNNet(
        conv=conv, flow=flow, dims=(8, 8, 8),
        feature=jax_encoders.ShallowEncoder(dense_names=("feature",)))


def port_sage(conv="sage", fanouts=FANOUTS):
    return GNNNet(conv, SageDataFlow(fanouts, [(0,)] * len(fanouts)),
                  (8, 8, 8), ShallowEncoder(("feature",)), in_dim=FEAT,
                  device="cpu")


def jax_sage_flow(fanouts=FANOUTS):
    return Recording(jax_flows.SageDataFlow(fanouts,
                                            [(0,)] * len(fanouts)))


def check_model(port, want, grads, got, names, loss="loss"):
    for name in names:
        close(got[name], want[name], name)
    np.testing.assert_allclose(got[loss].item(), float(want[loss]), **TOL)
    got[loss].backward()
    grads_match(port, grads)


@pytest.mark.parametrize("kind", ["gae", "vgae", "dgi"])
def test_autoencoders_match(pair, roots, kind):
    gj, gt = pair
    B = len(roots)
    flow = jax_sage_flow()
    net = sage_net(flow, "gcn")
    if kind == "dgi":
        mj = jax_ae.DGI(embedder=net, num_negs=NEGS)
        mt = DGI(port_sage("gcn"), num_negs=NEGS, device="cpu")
    else:
        cls = (jax_ae.GAE, GAE) if kind == "gae" else (jax_ae.VGAE, VGAE)
        mj = cls[0](embedder=net, edge_types=(0,), num_negs=NEGS)
        mt = cls[1](port_sage("gcn"), (0,), num_negs=NEGS, device="cpu")
    tree = init_tree(mj, gj.tensors, jnp.asarray(roots))
    want, grads, keys = reference(mj, tree, gj.tensors, jnp.asarray(roots),
                                  [flow])
    load_flax_params(mt, jax.tree.map(np.asarray, tree))
    counts = (B, B * NEGS) if kind == "dgi" else (B, B, B * NEGS)
    towers = [hop_uniforms(k, c, FANOUTS)
              for k, c in zip(keys["flows"][0], counts)]
    u_neg = node_uniforms(keys["node"][0], B * NEGS)
    if kind == "dgi":
        u = [u_neg] + towers
    else:
        u = [nbr_uniforms(keys["nbr"][0], B), u_neg] + towers
    if kind == "vgae":
        u += [t(np.array(jax.random.normal(k, s)))
              for k, s in zip(keys["normal"], keys["normal_shapes"])]
    got = mt(gt.tensors, t(roots), uniforms=u)
    names = ["embedding", "logits", "neg_logits"]
    check_model(mt, want, grads, got,
                names + ([] if kind == "dgi" else ["pos_mask"]))
    if kind != "dgi":
        assert got["pos_mask"][5, 0] == 0 and got["pos_mask"].mean() > 0.5


def test_vgae_draws_from_the_generator(pair, roots):
    _, gt = pair
    mt = VGAE(port_sage("gcn"), (0,), num_negs=NEGS, device="cpu")
    a, b = (mt(gt.tensors, t(roots),
               generator=torch.Generator().manual_seed(s))["loss"]
            for s in (1, 1))
    assert torch.equal(a, b) and torch.isfinite(a)


class JaxSolutionModel(jax_layers.nn.Module):
    """examples/solution/run_solution.py's model."""
    embedder: jax_layers.nn.Module
    label_name: str = "label"
    label_dim: int = CLASSES

    @jax_layers.nn.compact
    def __call__(self, g, roots):
        emb = self.embedder(g, roots)
        logit = jax_solution.DenseLogits(self.label_dim)(emb)
        (label,) = jax_feature_ops.get_dense_feature(g, roots,
                                                     [self.label_name])
        label = label[:, :self.label_dim]
        loss = jax_solution.sigmoid_loss(logit, label,
                                         (roots >= 0)[:, None])
        return dict(embedding=emb, logit=logit, label=label, loss=loss)


class JaxSampleSolutionModel(jax_layers.nn.Module):
    """examples/sample_solution/run_sample_solution.py's model."""
    group: jax_layers.nn.Module

    @jax_layers.nn.compact
    def __call__(self, g, roots):
        ks, kn = jax.random.split(self.make_rng("sample"))
        pos, pos_ok = jax_solution.sample_pos_with_types(g, ks, roots, (0,))
        negs = jax_solution.sample_neg_with_types(g, kn, roots, -1, NEGS)
        B = roots.shape[0]
        ctx_ids = jnp.concatenate([pos[:, 0], negs.reshape(-1)])
        emb, ctx = self.group(g, [roots, ctx_ids])
        logits, neg_logits = jax_solution.PosNegLogits()(
            emb, ctx[:B], ctx[B:].reshape(B, NEGS, -1))
        loss = jax_solution.xent_loss(logits, neg_logits, pos_ok[:, :1])
        return dict(embedding=emb, logits=logits, neg_logits=neg_logits,
                    loss=loss)


def test_solution_model_matches(pair, roots):
    gj, gt = pair
    flow = jax_sage_flow()
    mj = JaxSolutionModel(embedder=sage_net(flow))
    tree = init_tree(mj, gj.tensors, jnp.asarray(roots))
    want, grads, keys = reference(mj, tree, gj.tensors, jnp.asarray(roots),
                                  [flow])
    mt = load_flax_params(SolutionModel(port_sage(), "label", CLASSES,
                                        device="cpu"),
                          jax.tree.map(np.asarray, tree))
    got = mt(gt.tensors, t(roots),
             uniforms=hop_uniforms(keys["flows"][0][0], len(roots), FANOUTS))
    check_model(mt, want, grads, got, ["embedding", "logit", "label"])


def test_sample_solution_model_matches(pair, roots):
    gj, gt = pair
    B = len(roots)
    flows = [jax_sage_flow(), jax_sage_flow()]
    mj = JaxSampleSolutionModel(group=jax_group.GroupGNNNet(
        gnns=tuple(sage_net(f) for f in flows)))
    tree = init_tree(mj, gj.tensors, jnp.asarray(roots))
    want, grads, keys = reference(mj, tree, gj.tensors, jnp.asarray(roots),
                                  flows)
    mt = load_flax_params(SampleSolutionModel(
        GroupGNNNet([port_sage(), port_sage()], device="cpu"), (0,),
        num_negs=NEGS,
        device="cpu"), jax.tree.map(np.asarray, tree))
    u = [nbr_uniforms(keys["nbr"][0], B),
         node_uniforms(keys["node"][0], B * NEGS),
         [hop_uniforms(keys["flows"][0][0], B, FANOUTS),
          hop_uniforms(keys["flows"][1][0], B * (1 + NEGS), FANOUTS)]]
    got = mt(gt.tensors, t(roots), uniforms=u)
    check_model(mt, want, grads, got, ["embedding", "logits",
                                       "neg_logits"])


# ---------------------------------------------------------- graph model --

@pytest.fixture(scope="module")
def motif(tmp_path_factory):
    from euler_tpu.datasets.synthetic import MotifDataset
    ds = MotifDataset(str(tmp_path_factory.mktemp("motif_rest")),
                      n_graphs=12, seed=5)
    return ds.load_graph(), load_graph(ds.data_dir, device="cpu")


GIDX = np.array([0, 3, 7, -1, 11, 2], np.int32)


def test_make_graph_batch_matches(motif):
    gj, gt = motif
    want = jax_est.make_graph_batch(gj.tensors, jnp.asarray(GIDX), "label",
                                    2)
    got = make_graph_batch(gt.tensors, t(GIDX), "label", 2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["label"].sum() == 5 and got["mask"].any()


@pytest.mark.parametrize("pool", ["mean", "set2set", "attention"])
def test_graph_model_matches(motif, pool):
    gj, gt = motif
    flow = jax_sage_flow([2, 2])
    net = jax_gnn.GNNNet(
        conv="gin", flow=flow, dims=(8, 8, 8),
        feature=jax_encoders.ShallowEncoder(dense_names=("feature",)))
    G = len(GIDX)
    if pool == "set2set":
        pj, pt = jax_pooling.Set2SetPool(dim=8, num_graphs=G), \
            Set2SetPool(8, G, 8)
    elif pool == "attention":
        pj, pt = jax_pooling.AttentionPool(num_graphs=G), AttentionPool(8, G)
    else:
        pj, pt = jax_pooling.SegmentPool(aggr="mean", num_graphs=G), \
            SegmentPool(8, G, "mean")
    mj = jax_graph_model.GraphModel(embedder=net, pool=pj, label_dim=2)
    batch = jax_est.make_graph_batch(gj.tensors, jnp.asarray(GIDX), "label",
                                     2)
    tree = init_tree(mj, gj.tensors, batch)
    want, grads, keys = reference(mj, tree, gj.tensors, batch, [flow])
    pnet = GNNNet("gin", SageDataFlow([2, 2], [(0,), (0,)]), (8, 8, 8),
                  ShallowEncoder(("feature",)), in_dim=4, device="cpu")
    mt = load_flax_params(GraphModel(pnet, pt, 2, device="cpu"),
                          jax.tree.map(np.asarray, tree))
    bt = make_graph_batch(gt.tensors, t(GIDX), "label", 2)
    got = mt(gt.tensors, bt, uniforms=hop_uniforms(
        keys["flows"][0][0], len(bt["node_ids"]), [2, 2]))
    check_model(mt, want, grads, got, ["embedding", "logit", "label"])


# ------------------------------------------------------------- scalable --

def test_last_write_rows_keeps_the_last_occurrence():
    rows = torch.tensor([4, 2, 4, -1, 2, 4, 0])
    got = last_write_rows(rows, rows >= 0, 9)
    assert got.tolist() == [9, 9, 9, 9, 2, 4, 0]


@pytest.mark.parametrize("aggregator", ["mean", "meanpool", "gcn"])
def test_scalable_stores_after_two_steps_match(pair, aggregator):
    """Two SGD steps of a 3-layer ScalableSageNet under SuperviseModel on
    roots that repeat (5 and 9 twice in a step, 12 in both steps): the
    parameters, the loss and both stores equal the reference's, within
    1e-5, where the reference's CPU scatter also lets a repeated root's
    last occurrence win."""
    gj, gt = pair
    steps = [np.array([5, 9, 12, 5, -1, 9, 30, 31], np.int32),
             np.array([12, 40, 41, 12, 42, 43, -1, 44], np.int32)]
    net = jax_scalable.ScalableSageNet(
        edge_types=(0,), num_layers=3, dim=8, n_nodes=N, fanout=4,
        aggregator=aggregator,
        feature=jax_encoders.ShallowEncoder(dense_names=("feature",)))
    mj = jax_gnn.SuperviseModel(embedder=net, label_name="label",
                                label_dim=CLASSES)
    variables = init_tree(mj, gj.tensors, jnp.asarray(steps[0]))
    variables = dict(variables)
    # stores drawn as flax's init draws them, uniform in [0, 0.05)
    cache = jax.eval_shape(lambda: variables["cache"])
    variables["cache"] = jax.tree.map(
        lambda s: np.random.default_rng(1).random(s.shape).astype(
            np.float32) * 0.05, cache)
    port_net = ScalableSageNet((0,), 3, 8, ShallowEncoder(("feature",)),
                               FEAT, N, fanout=4, aggregator=aggregator,
                               device="cpu")
    mt = load_flax_params(SuperviseModel(port_net, "label", CLASSES,
                                         device="cpu"),
                          jax.tree.map(np.asarray, variables))
    tx = optax.sgd(0.5)
    params, state = variables["params"], {"cache": variables["cache"]}
    opt_state = tx.init(params)
    opt = torch.optim.SGD(mt.parameters(), 0.5)
    for i, r in enumerate(steps):
        key = jax.random.PRNGKey(20 + i)
        with recorded() as rec:
            def loss_fn(p, s, g, roots):
                rec["nbr"].clear()
                out, new = mj.apply({"params": p, **s}, g, roots,
                                    rngs={"sample": key}, mutable=["cache"])
                return out["loss"], (new, rec["nbr"][0])
            (loss, (state, k)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(params, state, gj.tensors,
                                        jnp.asarray(r))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        mt.train()
        opt.zero_grad()
        out = mt(gt.tensors, t(r), uniforms=nbr_uniforms(k, len(r), 4))
        np.testing.assert_allclose(out["loss"].item(), float(loss), **TOL)
        out["loss"].backward()
        opt.step()
    for j, store in enumerate(port_net.stores(), start=1):
        close(store, state["cache"]["embedder"][f"store_layer_{j}"],
              f"store_layer_{j}")
    want = load_flax_params(
        SuperviseModel(ScalableSageNet((0,), 3, 8,
                                       ShallowEncoder(("feature",)), FEAT, N,
                                       fanout=4, aggregator=aggregator,
                                       device="cpu"), "label", CLASSES,
                       device="cpu"), jax.tree.map(np.asarray, params))
    for (name, p), q in zip(mt.named_parameters(), want.parameters()):
        close(p, q.detach(), name)
    # evaluation reads the stores and writes nothing
    before = [s.clone() for s in port_net.stores()]
    mt.eval()
    with torch.no_grad():
        mt(gt.tensors, t(steps[1]),
           generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 port_net.stores()))
