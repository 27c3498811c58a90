"""The fan-less fallback, the payload flow, the flows' unknown keywords
and ``train_and_evaluate`` of the PyTorch port against euler_tpu on the
CPU.

- A hop over a graph without the ``fan`` pack (and, for a hop over every
  type, without ``fanu``) draws through ``select_sampled_neighbors``, as
  the reference's ``sample_neighbor_fast`` falls back to
  ``sample_neighbor``: ids, validity and types equal bit for bit from
  the reference key's uniforms (``kt, kd = split(key); k1, k2 =
  split(kd)``), on graphs built with equal packs on both sides (with the
  ``sample`` pack the reference draws otherwise).
- ``SageDataFlow(payload=True)`` blocks equal the reference's in every
  field; a payload rgcn's loss within 1e-5 and every gradient within
  1e-4 of ``jax.value_and_grad`` through the flax parameters.
- Every flow ignores an unknown keyword; ``train_and_evaluate`` returns
  the reference's keys.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.estimator import estimator as jax_estimator
from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu.ops import sampling as jax_sampling
from euler_tpu_torch.dataflow import SageDataFlow, flows
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import NodeEstimator, RunConfig
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import (GNNNet, ShallowEncoder, SuperviseModel,
                                    load_flax_params)
from euler_tpu_torch.ops import fan_draw as fd
from euler_tpu_torch.ops import sampling
from tests.test_torch_graph import native_off
from tests.test_torch_verbs import assert_equal, uniforms

N, ET = 300, 4
NODES = np.concatenate([np.arange(-2, 40), [N - 1, N, N + 7]]).astype(
    np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
FANOUTS = [4, 3]
B = 24
ALL_PACKS = ("group", "adj", "sample", "fan")


def graph_pair(packs, n=N, **kw):
    """(euler_tpu Graph, port Graph on the CPU) of one 4-type random
    graph built with ``packs`` on both sides, the numpy CSR sort on both
    (ROADMAP Queue C)."""
    kw = dict(dict(num_edge_types=ET, seed=1), **kw, packs=packs)
    with native_off(("build_csr_native",)):
        return (jax_random_graph(n, 12, **kw),
                random_graph(n, 12, device="cpu", **kw))


@pytest.fixture(scope="module")
def pairs():
    return {packs: graph_pair(packs)
            for packs in ((), ("group",), ("sample",), ("fanu",))}


# ------------------------------------------------------- the fallback hop --

@pytest.mark.parametrize("packs", [(), ("group",), ("sample",), ("fanu",)])
@pytest.mark.parametrize("ets", [(0,), (2, 1), (0, 1, 2, 3)])
def test_fan_less_hop_bit_exact(pairs, packs, ets):
    gj, gt = pairs[packs]
    union = packs == ("fanu",) and len(ets) == ET
    assert sampling.hop_kind(gt.tensors, ets) == (
        "union" if union else "sampled")
    key = jax.random.PRNGKey(len(ets) + 3 * len(packs))
    want = jax.jit(lambda g, n: jax_sampling.sample_neighbor_fast(
        g, key, n, ets, 7, -3, return_types=True))(gj.tensors,
                                                    jnp.asarray(NODES))
    u = uniforms(key, (len(NODES), 7), typed=not union)
    got = sampling.select_neighbors(gt.tensors, torch.from_numpy(NODES), ets,
                                    u, -3, return_types=True)
    assert_equal(got, want, ("ids", "valid", "type"))
    ids, valid = sampling.select_neighbors(gt.tensors,
                                           torch.from_numpy(NODES), ets, u,
                                           -3)
    assert torch.equal(ids, got[0]) and torch.equal(valid, got[1])
    assert (got[0].numpy()[2:40] >= 0).mean() > 0.8
    drawn = sampling.draw_neighbor_uniforms(gt.tensors, ets, None, 5, 2,
                                            "cpu")
    assert len(drawn) == (2 if union else 3)


def test_fan_less_hop_on_the_toy_graph(toy_dir):
    with native_off():
        gj = jax_load_graph(toy_dir, packs=())
        gt = load_graph(toy_dir, packs=(), device="cpu")
    nodes = np.asarray([gt.local_id(e) for e in (100, 101, 102, 105)] + [-1],
                       np.int32)
    for ets in ((0,), (0, 1)):
        key = jax.random.PRNGKey(7)
        want = jax.jit(lambda g, n: jax_sampling.sample_neighbor_fast(
            g, key, n, ets, 5, return_types=True))(gj.tensors,
                                                   jnp.asarray(nodes))
        got = sampling.select_neighbors(
            gt.tensors, torch.from_numpy(nodes), ets,
            uniforms(key, (len(nodes), 5)), return_types=True)
        assert_equal(got, want, ("ids", "valid", "type"))


def test_fan_less_hop_launches_no_fan_draw(pairs):
    _, gt = pairs[()]
    before = fd.fan_draw.launches
    blocks = SageDataFlow(FANOUTS, [(0,)] * 2)(
        gt.tensors, torch.arange(8, dtype=torch.int32),
        generator=torch.Generator().manual_seed(0))
    assert fd.fan_draw.launches == before
    assert blocks[0].n_id.shape == (8 * 5 * 4,)


def test_fan_selects_without_the_pack_point_to_the_fallback(pairs):
    _, gt = pairs[()]
    nodes = torch.arange(3, dtype=torch.int32)
    u = torch.rand(3, 2)
    with pytest.raises(ValueError, match="select_sampled_neighbors"):
        sampling.select_fan_neighbors(gt.tensors, nodes, (0,), u, u)
    with pytest.raises(ValueError, match="select_sampled_neighbors"):
        sampling.select_typed_neighbors(gt.tensors, nodes, (0, 1), u, u, u)


# ------------------------------------------------------------ the flows --

def flow_uniforms(key, B, fanouts, typed=True):
    """The uniforms the reference's SageDataFlow hands each hop's verb:
    ``key, sub = split(key)`` a hop, then ``uniforms(sub, ...)``."""
    out, n = [], B
    for c in fanouts:
        key, sub = jax.random.split(key)
        out.append(uniforms(sub, (n, c), typed=typed))
        n *= 1 + c
    return out


BLOCK_FIELDS = ("n_id", "res_n_id", "edge_index", "e_id", "edge_weight",
                "mask", "e_type")


def assert_blocks_equal(got, want):
    assert len(got) == len(want)
    for bt, bj in zip(got, want):
        for name in BLOCK_FIELDS:
            a, b = getattr(bt, name), getattr(bj, name)
            assert (a is None) == (b is None), name
            if a is not None:
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype, name
                np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        assert tuple(bt.size) == tuple(bj.size) and bt.fanout == bj.fanout


@pytest.mark.parametrize("packs", [(), ALL_PACKS])
@pytest.mark.parametrize("ets", [(0,), (3, 1), (0, 1, 2, 3)])
def test_payload_blocks_equal_the_reference(packs, ets):
    gj, gt = graph_pair(packs, seed=2)
    roots = np.arange(-1, 12, dtype=np.int32)
    key = jax.random.PRNGKey(5)
    metapath = [ets] * 2
    want = jax.jit(lambda g, r: jax_flows.SageDataFlow(
        FANOUTS, metapath, payload=True, typed=True)(g, key, r))(
        gj.tensors, jnp.asarray(roots))
    flow = SageDataFlow(FANOUTS, metapath, payload=True, typed=True)
    got = flow(gt.tensors, torch.from_numpy(roots),
               uniforms=flow_uniforms(key, len(roots), FANOUTS))
    assert_blocks_equal(got, want)
    w = got[-1].edge_weight.numpy()[:len(roots) * FANOUTS[0]]
    assert len(np.unique(w[w > 0])) > 3        # true edge weights, not 0/1
    assert (got[-1].e_id.numpy() >= 0).any()
    drawn = flow.draw_hop(gt.tensors, ets, None, 4, 2, "cpu")
    assert len(drawn) == 3 and drawn[0].shape == (4, 2)


@pytest.mark.parametrize("typed", [False, True])
def test_fan_less_flow_blocks_equal_the_reference(pairs, typed):
    gj, gt = pairs[()]
    roots = np.arange(-1, 12, dtype=np.int32)
    key = jax.random.PRNGKey(9)
    metapath = [(0,), (1, 2)]
    want = jax.jit(lambda g, r: jax_flows.SageDataFlow(
        FANOUTS, metapath, typed=typed)(g, key, r))(gj.tensors,
                                                    jnp.asarray(roots))
    got = SageDataFlow(FANOUTS, metapath, typed=typed)(
        gt.tensors, torch.from_numpy(roots),
        uniforms=flow_uniforms(key, len(roots), FANOUTS))
    assert_blocks_equal(got, want)


@pytest.mark.parametrize("cls", sorted(set(flows._FLOWS.values()),
                                       key=lambda c: c.__name__))
def test_every_flow_ignores_unknown_keywords(cls):
    first = 2 if cls is flows.WholeDataFlow else [3, 3]
    flow = cls(first, [(0,), (0,)], not_a_flag=1, payload_dim=7)
    assert flow.num_layers == 2
    getattr(jax_flows, cls.__name__)(first, [(0,), (0,)], not_a_flag=1)


# ---------------------------------------------------------- payload rgcn --

@pytest.fixture(scope="module")
def rgcn_pair():
    return graph_pair(ALL_PACKS, n=500, feat_dim=16, n_classes=4, seed=0)


class RecordingFlow(jax_flows.SageDataFlow):
    """The reference's flow, keeping each key it is called with (a tracer
    under jit: return it from the jitted function)."""

    def __call__(self, g, key, roots):
        self.keys.append(key)
        return super().__call__(g, key, roots)


def test_payload_rgcn_loss_and_gradients_match(rgcn_pair):
    gj, gt = rgcn_pair
    roots = np.arange(5, 5 + B, dtype=np.int32)
    roots[-2:] = -1
    metapath = [tuple(range(ET))] * 2
    kw = {"num_relations": ET}
    flow = RecordingFlow(FANOUTS, metapath, payload=True)
    flow.keys = []
    model = jax_gnn.SuperviseModel(
        embedder=jax_gnn.GNNNet(
            conv="relation", flow=flow, dims=(16, 16),
            feature=jax_encoders.ShallowEncoder(dense_names=("feature",)),
            conv_kwargs=kw, relation_from_etype=True),
        label_name="label", label_dim=4)
    variables = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(2), "sample": jax.random.PRNGKey(1)},
        gj.tensors, jnp.asarray(roots))
    net = GNNNet("relation", SageDataFlow(FANOUTS, metapath, payload=True),
                 (16, 16), ShallowEncoder(("feature",)), in_dim=16,
                 device="cpu", conv_kwargs=kw, relation_from_etype=True)
    port = load_flax_params(SuperviseModel(net, "label", 4, device="cpu"),
                            jax.tree.map(np.asarray, variables))

    def loss_fn(p, g):
        out = model.apply(p, g, jnp.asarray(roots),
                          rngs={"sample": jax.random.PRNGKey(11)})
        return out["loss"], (out["embedding"], flow.keys[-1])

    (loss_j, (emb_j, key)), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables, gj.tensors)
    out = port(gt.tensors, torch.from_numpy(roots),
               uniforms=flow_uniforms(key, B, FANOUTS))
    out["loss"].backward()
    np.testing.assert_allclose(out["embedding"].detach().numpy(),
                               np.asarray(emb_j), **TOL)
    np.testing.assert_allclose(out["loss"].item(), float(loss_j), **TOL)
    holder = load_flax_params(copy.deepcopy(port),
                              jax.tree.map(np.asarray, grads_j))
    want = {n: p.detach().numpy() for n, p in holder.named_parameters()}
    assert any(n.endswith("matrix") for n in want)
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name],
                                   err_msg=name, **GRAD_TOL)
        assert np.abs(want[name]).max() > 0, name


def test_relation_from_etype_takes_a_payload_flow():
    kw = dict(conv_kwargs={"num_relations": 2}, relation_from_etype=True,
              in_dim=16, device="cpu")
    GNNNet("relation", SageDataFlow(FANOUTS, [(0, 1)] * 2, payload=True),
           (16, 16), ShallowEncoder(("feature",)), **kw)
    GNNNet("relation", flows.WholeDataFlow(2, [(0,)]), (16, 16),
           ShallowEncoder(("feature",)), **kw)
    with pytest.raises(ValueError, match="payload=True"):
        GNNNet("relation", SageDataFlow(FANOUTS, [(0, 1)] * 2), (16, 16),
               ShallowEncoder(("feature",)), **kw)


# ---------------------------------------------------- train_and_evaluate --

def test_train_and_evaluate_returns_the_reference_keys(tmp_path):
    gj, gt = graph_pair(("fan",), n=200, feat_dim=16, n_classes=4, seed=3,
                        num_edge_types=1)
    flow = [[3, 2], [(0,)] * 2]
    ref = jax_gnn.SuperviseModel(
        embedder=jax_gnn.GNNNet(
            conv="sage", flow=jax_flows.SageDataFlow(*flow), dims=(8, 8),
            feature=jax_encoders.ShallowEncoder(dense_names=("feature",))),
        label_name="label", label_dim=4)
    cfg = dict(batch_size=16, total_steps=2, log_steps=100)
    want = jax_estimator.NodeEstimator(
        ref, gj, jax_estimator.RunConfig(model_dir=str(tmp_path), **cfg)
    ).train_and_evaluate(np.arange(40))
    port = SuperviseModel(
        GNNNet("sage", SageDataFlow(*flow), (8, 8),
               ShallowEncoder(("feature",)), in_dim=16, device="cpu"),
        "label", 4, device="cpu")
    got = NodeEstimator(port, gt, RunConfig(**cfg), device="cpu"
                        ).train_and_evaluate(np.arange(40))
    assert set(got) == set(want) == {"loss", "steps", "f1"}
    assert got["steps"] == want["steps"] == 2
    assert all(np.isfinite(v) for v in got.values())
