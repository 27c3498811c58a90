"""The gin, gat and rgcn bench families of the PyTorch port against
euler_tpu, in f32 on the CPU.

- Block pieces the convs read: ``gather_src``, ``gather_tgt``, scaled
  ``aggregate_neighbors`` and ``softmax`` (regular layout, with and
  without mask and self loops, fully masked targets), and ``fanout_block``
  with edge types: within rtol = atol = 1e-5 (exact where nothing is
  summed).
- ``GINConv``, ``GATConv`` and ``RelationConv`` forward against flax with
  the flax parameters loaded: rtol = atol = 1e-5 (summation order of the
  CPU matmuls).
- Each family's ``SuperviseModel`` through its flow with the reference's
  uniforms replayed (rgcn: 4 edge types, union rows, typed flow,
  relations from the sampled types): sampled blocks equal, embeddings
  and loss within 1e-5, every gradient within 1e-4 against
  ``jax.value_and_grad`` (GIN's ``eps`` and RGCN's ``matrix`` included).
"""
import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import block as jax_block
from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.models import convs as jax_convs
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu_torch.dataflow import SageDataFlow, fanout_block
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.models import (GATConv, GINConv, GNNNet, RelationConv,
                                    ShallowEncoder, SuperviseModel,
                                    get_conv_class, load_flax_params)
from euler_tpu_torch.models.from_flax import load_conv
from tests.test_torch_graph import native_off
from tests.test_torch_models import RecordingFlow, hop_uniforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
T, C = 12, 3


def block_pair(self_loops=True, seed=0, dead_target=True):
    """(reference Block, port Block) of one hop of T targets and C draws,
    with dead draws, typed draws and (``dead_target``) a target whose
    edges are all masked."""
    rng = np.random.default_rng(seed)
    targets = np.arange(T, dtype=np.int32)
    sampled = rng.integers(-1, 40, (T, C)).astype(np.int32)
    if dead_target:
        targets[0] = -1
        sampled[0] = -1
    sampled[1] = -1                      # a live target with no neighbor
    types = np.where(sampled >= 0, rng.integers(0, 4, (T, C)), -1).astype(
        np.int32)
    args = (targets, sampled, (sampled >= 0).astype(np.float32),
            np.full((T, C), -1, np.int32))
    bj = jax_block.fanout_block(*map(jnp.asarray, args), C, self_loops,
                                etypes=jnp.asarray(types))
    bt = fanout_block(*map(torch.from_numpy, args), C, self_loops,
                      etypes=torch.from_numpy(types))
    return bj, bt


def features(bt, dim, seed=1):
    return np.random.default_rng(seed).normal(
        size=(bt.size[1], dim)).astype(np.float32)


def test_fanout_block_carries_edge_types():
    for self_loops in (True, False):
        bj, bt = block_pair(self_loops)
        np.testing.assert_array_equal(bt.e_type.numpy(),
                                      np.asarray(bj.e_type))
        if self_loops:
            assert (bt.e_type[-T:] == -1).all()
    plain = fanout_block(torch.zeros(2, dtype=torch.int32),
                         torch.zeros((2, 1), dtype=torch.int32),
                         torch.ones((2, 1)),
                         torch.full((2, 1), -1, dtype=torch.int32), 1)
    assert plain.e_type is None


@pytest.mark.parametrize("self_loops", [True, False])
def test_per_edge_views_match(self_loops):
    bj, bt = block_pair(self_loops)
    x = features(bt, 5)
    v = x[:T]
    np.testing.assert_array_equal(bt.gather_src(torch.from_numpy(x)).numpy(),
                                  np.asarray(bj.gather_src(jnp.asarray(x))))
    np.testing.assert_array_equal(bt.gather_tgt(torch.from_numpy(v)).numpy(),
                                  np.asarray(bj.gather_tgt(jnp.asarray(v))))
    # a 1-D per-target value broadcasts the same way
    np.testing.assert_array_equal(
        bt.gather_tgt(torch.from_numpy(v[:, 0])).numpy(),
        np.asarray(bj.gather_tgt(jnp.asarray(v[:, 0]))))


@pytest.mark.parametrize("op", ["add", "mean"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("scale_dims", [1, 2])
def test_scaled_aggregate_matches(op, masked, self_loops, scale_dims):
    bj, bt = block_pair(self_loops)
    x = features(bt, 6)
    E = bt.edge_index.shape[1]
    scale = np.random.default_rng(2).random((E, 1)[:scale_dims]).astype(
        np.float32)
    want = bj.aggregate_neighbors(op, jnp.asarray(x),
                                  bj.mask if masked else None,
                                  scale=jnp.asarray(scale))
    got = bt.aggregate_neighbors(op, torch.from_numpy(x),
                                 bt.mask if masked else None,
                                 scale=torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("width", [1, 3])
def test_block_softmax_matches(masked, self_loops, width):
    bj, bt = block_pair(self_loops)
    E = bt.edge_index.shape[1]
    scores = (np.random.default_rng(3).normal(size=(E, width)) * 4).astype(
        np.float32)
    want = np.asarray(bj.softmax(jnp.asarray(scores),
                                 bj.mask if masked else None))
    got = bt.softmax(torch.from_numpy(scores),
                     bt.mask if masked else None).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got).all()


def test_masked_softmax_rows_give_zero():
    # target 0 is -1 (its self loop masked too) and draws nothing: every
    # probability of its row is 0, never NaN; target 1 keeps its self loop
    _, bt = block_pair(self_loops=True)
    E = bt.edge_index.shape[1]
    p = bt.softmax(torch.randn((E, 1)), bt.mask)
    assert torch.isfinite(p).all()
    assert (p[:C] == 0).all() and p[T * C] == 0
    np.testing.assert_allclose(float(p[T * C + 1]), 1.0, rtol=1e-6)
    assert (p[bt.mask == 0] == 0).all()


# ------------------------------------------------------------- convs --

def _conv_pair(name, in_dim, dim, block, x, **kw):
    """(reference output, port conv with the flax parameters loaded)."""
    xj = jnp.asarray(x)
    args = ((xj[:T], xj), block)
    conv = jax_convs.get_conv_class(name)(dim=dim, **{
        k: v for k, v in kw.items() if k != "edge_attr"})
    extra = {"edge_attr": jnp.asarray(kw["edge_attr"])} \
        if "edge_attr" in kw else {}
    params = conv.init(jax.random.PRNGKey(0), *args, **extra)
    want = conv.apply(params, *args, **extra)
    ct = get_conv_class(name)(in_dim, dim, **{
        k: v for k, v in kw.items() if k != "edge_attr"})
    load_conv(ct, jax.tree.map(np.asarray, params["params"]))
    return np.asarray(want), ct


@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("improved", [False, True])
def test_gat_conv_matches_flax(self_loops, improved):
    # scores go negative, so the slope shows: tf's 0.2, not flax's 0.01
    bj, bt = block_pair(self_loops)
    x = features(bt, 6) * 3
    want, ct = _conv_pair("gat", 6, 5, bj, x, improved=improved)
    xt = torch.from_numpy(x)
    got = ct((xt[:T], xt), bt)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    ct.a1.weight.data.neg_()               # flip the score's sign
    assert not np.allclose(ct((xt[:T], xt), bt).detach().numpy(), want,
                           **TOL)


@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("train_eps,eps", [(True, 0.0), (False, 0.5)])
def test_gin_conv_matches_flax(self_loops, train_eps, eps):
    bj, bt = block_pair(self_loops)
    x = features(bt, 6)
    want, ct = _conv_pair("gin", 6, 5, bj, x, train_eps=train_eps, eps=eps)
    if train_eps:
        assert isinstance(ct.eps, torch.nn.Parameter)
        # a non-zero eps, the same on both sides
        ct.eps.data.fill_(0.25)
        xj = jnp.asarray(x)
        conv = jax_convs.GINConv(dim=5)
        params = conv.init(jax.random.PRNGKey(0), (xj[:T], xj), bj)
        params = {"params": dict(params["params"],
                                 eps=jnp.asarray([0.25]))}
        want = np.asarray(conv.apply(params, (xj[:T], xj), bj))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(ct((xt[:T], xt), bt).detach().numpy(), want,
                               **TOL)


@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("R", [1, 3])
def test_relation_conv_matches_flax(self_loops, R):
    # edge_attr holds -1 (invalid draws) and types >= R: both clip
    bj, bt = block_pair(self_loops)
    x = features(bt, 6)
    attr = bt.e_type.clone()
    attr[2::5] = 5
    want, ct = _conv_pair("relation", 6, 5, bj, x, num_relations=R,
                          edge_attr=attr.numpy())
    assert tuple(ct.matrix.shape) == (R, 5, 6)
    xt = torch.from_numpy(x)
    got = ct((xt[:T], xt), bt, edge_attr=attr)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_self_loops_count_as_relation_0():
    # GNNNet feeds max(e_type, 0): the self loops' -1 is relation 0
    _, bt = block_pair(self_loops=True)
    x = torch.from_numpy(features(bt, 6))
    conv = RelationConv(6, 5, num_relations=3,
                        generator=torch.Generator().manual_seed(0))
    attr = bt.e_type.clamp_min(0)
    assert (attr[-T:] == 0).all()
    explicit = bt.e_type.clone()
    explicit[-T:] = 0
    out = conv((x[:T], x), bt, edge_attr=attr)
    assert torch.equal(out, conv((x[:T], x), bt, edge_attr=explicit))
    other = explicit.clone()
    other[-T:] = 2
    assert not torch.allclose(out, conv((x[:T], x), bt, edge_attr=other))


def test_relation_matrix_init_is_fan_avg_truncated_normal():
    conv = RelationConv(96, 64, num_relations=4,
                        generator=torch.Generator().manual_seed(0))
    fan_avg = (64 * 4 + 96 * 4) / 2
    std = (1 / fan_avg) ** 0.5
    m = conv.matrix.detach()
    np.testing.assert_allclose(float(m.std()), std, rtol=0.05)
    assert float(m.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6


def test_flax_trees_of_the_three_convs_load():
    # the names of a real model.init tree, and wrong shapes raise
    bj, bt = block_pair()
    x = features(bt, 6)
    for name, cls, kw in (("gat", GATConv, {}), ("gin", GINConv, {}),
                          ("relation", RelationConv, {"num_relations": 2})):
        xj = jnp.asarray(x)
        conv = jax_convs.get_conv_class(name)(dim=5, **kw)
        extra = {"edge_attr": bj.e_type} if name == "relation" else {}
        tree = jax.tree.map(np.asarray, conv.init(
            jax.random.PRNGKey(1), (xj[:T], xj), bj, **extra)["params"])
        ct = cls(6, 5, **kw)
        load_conv(ct, tree)
        wrong = cls(7, 5, **kw)
        with pytest.raises(ValueError, match="flax shape"):
            load_conv(wrong, tree)


# -------------------------------------------- the three families, whole --

FANOUTS, B, RGCN_TYPES = [3, 2], 32, 4
FAMILIES = ["gin", "gat", "rgcn"]


@pytest.fixture(scope="module")
def family_graphs():
    """gin/gat: the one-type graph with the fan pack; rgcn: 4 edge types
    and the fanu pack only, as bench.py builds them."""
    out = {}
    with native_off(("build_csr_native",)):
        for name, n_et, packs in (("one", 1, ("fan",)),
                                  ("rgcn", RGCN_TYPES, ("fanu",))):
            kw = dict(feat_dim=16, n_classes=4, seed=0, num_edge_types=n_et,
                      packs=packs)
            out[name] = (jax_random_graph(2000, 25, **kw),
                         random_graph(2000, 25, device="cpu", **kw))
    return out


@pytest.fixture(scope="module")
def roots():
    r = np.arange(5, 5 + B, dtype=np.int32)
    r[-2:] = -1
    return r


def _family(family, family_graphs, roots, seed=0):
    """(jax model, variables, recording flow, port model, graphs)."""
    rgcn = family == "rgcn"
    gj, gt = family_graphs["rgcn" if rgcn else "one"]
    n_et = RGCN_TYPES if rgcn else 1
    metapath = [tuple(range(n_et))] * 2
    conv = "relation" if rgcn else family
    kw = {"num_relations": n_et} if rgcn else None
    flow = RecordingFlow(jax_flows.SageDataFlow(FANOUTS, metapath,
                                                typed=rgcn))
    net = jax_gnn.GNNNet(conv=conv, flow=flow, dims=(16, 16),
                         feature=jax_encoders.ShallowEncoder(
                             dense_names=("feature",)),
                         conv_kwargs=kw, relation_from_etype=rgcn)
    model = jax_gnn.SuperviseModel(embedder=net, label_name="label",
                                   label_dim=4)
    variables = model.init({"params": jax.random.PRNGKey(seed),
                            "sample": jax.random.PRNGKey(1)}, gj.tensors,
                           jnp.asarray(roots))
    pnet = GNNNet(conv, SageDataFlow(FANOUTS, metapath, typed=rgcn), (16, 16),
                  ShallowEncoder(("feature",)), in_dim=16, device="cpu",
                  conv_kwargs=kw, relation_from_etype=rgcn)
    port = load_flax_params(SuperviseModel(pnet, "label", 4, device="cpu"),
                            jax.tree.map(np.asarray, variables))
    return model, variables, flow, port, (gj, gt)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_samples_the_same_blocks(family, family_graphs, roots):
    rgcn = family == "rgcn"
    gj, gt = family_graphs["rgcn" if rgcn else "one"]
    metapath = [tuple(range(RGCN_TYPES if rgcn else 1))] * 2
    key = jax.random.PRNGKey(3)
    want = jax_flows.SageDataFlow(FANOUTS, metapath, typed=rgcn)(
        gj.tensors, key, jnp.asarray(roots))
    got = SageDataFlow(FANOUTS, metapath, typed=rgcn)(
        gt.tensors, torch.from_numpy(roots),
        uniforms=hop_uniforms(key, B, FANOUTS))
    for bt, bj in zip(got, want):
        for name in ("n_id", "edge_index", "mask", "e_id") + (
                ("e_type",) if rgcn else ()):
            np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                          np.asarray(getattr(bj, name)),
                                          err_msg=name)
    if rgcn:
        assert set(np.unique(got[0].e_type.numpy())) == {-1, 0, 1, 2, 3}


@pytest.mark.parametrize("family", FAMILIES)
def test_family_forward_matches(family, family_graphs, roots):
    model, variables, flow, port, (gj, gt) = _family(family, family_graphs,
                                                     roots)
    rj = jnp.asarray(roots)
    want = model.apply(variables, gj.tensors, rj,
                       rngs={"sample": jax.random.PRNGKey(7)})
    with torch.no_grad():
        got = port(gt.tensors, torch.from_numpy(roots),
                   uniforms=hop_uniforms(flow.keys[-1], B, FANOUTS))
    for name in ("embedding", "logit", "label", "valid"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_loss_and_gradients_match_value_and_grad(family,
                                                        family_graphs,
                                                        roots):
    model, variables, flow, port, (gj, gt) = _family(family, family_graphs,
                                                     roots, seed=2)
    key = jax.random.PRNGKey(11)

    def loss_fn(p):
        return model.apply(p, gj.tensors, jnp.asarray(roots),
                           rngs={"sample": key})["loss"]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(variables)
    out = port(gt.tensors, torch.from_numpy(roots),
               uniforms=hop_uniforms(flow.keys[-1], B, FANOUTS))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(loss_j), **TOL)
    holder = load_flax_params(copy.deepcopy(port),
                              jax.tree.map(np.asarray, grads_j))
    want = {n: p.detach().numpy() for n, p in holder.named_parameters()}
    special = {"gin": "eps", "gat": "a1.weight", "rgcn": "matrix"}[family]
    assert any(n.endswith(special) for n in want)
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name],
                                   err_msg=name, **GRAD_TOL)
        assert np.abs(want[name]).max() > 0, name


def test_relation_from_etype_needs_a_typed_flow():
    with pytest.raises(ValueError, match="typed=True"):
        GNNNet("relation", SageDataFlow(FANOUTS, [(0, 1)] * 2), (16, 16),
               ShallowEncoder(("feature",)), in_dim=16, device="cpu",
               conv_kwargs={"num_relations": 2}, relation_from_etype=True)


def test_bench_prints_bench_py_lines_for_rgcn_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "euler_tpu_torch.bench",
                          "--device", "cpu", "--model", "rgcn"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(s) for s in out.stdout.splitlines()
             if s.startswith("{")]
    assert [r["phase"] for r in lines] == ["warmup", "single_loop",
                                           "pipelined"]
    for r in lines:
        assert set(r) == {"metric", "model", "value", "unit", "vs_baseline",
                          "platform", "phase", "config"}
        assert r["model"] == "rgcn" and r["platform"] == "cpu"
        assert r["metric"] == "sampled_aggregate_edges_per_sec_per_chip"
        assert r["config"] == "b256_f25x10_n5000" and r["value"] > 0
        assert r["vs_baseline"] is None
