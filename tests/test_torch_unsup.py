"""``UnsuperviseModel`` and ``EmbedOnly`` of the PyTorch port against
euler_tpu, in f32 on the CPU.

The flax tree is loaded into the port. The reference draws inside the
model: the positive hop's key and the negatives' key are recorded by
wrapping ``euler_tpu.ops.sampling.sample_neighbor_fast`` and
``sample_node`` (gnn.py calls both through the module), each sage
tower's flow key by the ``RecordingFlow`` of tests/test_torch_models.py,
and all of them are returned by the jitted ``value_and_grad`` beside its
outputs. The uniforms derived from them are replayed into the port, in
the order ``UnsuperviseModel`` documents. Sampled ids must be equal;
loss, logits and every gradient within rtol = atol = 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu.ops import sampling as jax_sampling
from euler_tpu.utils import metrics as jax_metrics
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.estimator import NodeEstimator, RunConfig
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import (EmbedOnly, GNNNet, ShallowEncoder,
                                    UnsuperviseModel, load_flax_params)
from tests.test_torch_graph import native_off, random_pair
from tests.test_torch_models import RecordingFlow, hop_uniforms
from tests.test_torch_typed import key_uniforms

TOL = dict(rtol=1e-5, atol=1e-5)
NEGS = 5
FANOUTS = [3, 2]


def node_uniforms(key, count):
    """(u_type, u1, u2) that the reference's sample_node(-1) draws."""
    kt, kd = jax.random.split(key)
    k1, k2 = jax.random.split(kd)
    return tuple(torch.from_numpy(np.array(jax.random.uniform(k, (count,))))
                 for k in (kt, k1, k2))


@pytest.fixture(scope="module")
def toy_pair(toy_dir):
    from euler_tpu.graph import load_graph as jax_load_graph
    with native_off(("build_csr_native",)):
        return jax_load_graph(toy_dir), load_graph(toy_dir, device="cpu")


@pytest.fixture(scope="module")
def sage_pair():
    return random_pair(2000, 25, feat_dim=16, n_classes=4, seed=0)


def embed_models(n):
    """(reference, port) UnsuperviseModel over EmbedOnly towers on a
    graph of n nodes with two edge types."""
    mj = jax_gnn.UnsuperviseModel(
        embedder=jax_gnn.EmbedOnly(max_id=n - 1, dim=8),
        context_embedder=jax_gnn.EmbedOnly(max_id=n - 1, dim=8),
        edge_types=(0, 1), num_negs=NEGS)
    mt = UnsuperviseModel(EmbedOnly(n - 1, 8, device="cpu"),
                          EmbedOnly(n - 1, 8, device="cpu"), (0, 1),
                          num_negs=NEGS, device="cpu")
    return mj, mt, []


def sage_models():
    """(reference, port, the reference's recording flows) over sage
    GNNNet towers on one edge type."""
    def jax_net(flow):
        return jax_gnn.GNNNet(
            conv="sage", flow=flow, dims=(16, 16),
            feature=jax_encoders.ShallowEncoder(dense_names=("feature",)))

    def port_net():
        return GNNNet("sage", SageDataFlow(FANOUTS, [(0,), (0,)]), (16, 16),
                      ShallowEncoder(("feature",)), in_dim=16, device="cpu")

    flows = [RecordingFlow(jax_flows.SageDataFlow(FANOUTS, [(0,), (0,)]))
             for _ in range(2)]
    mj = jax_gnn.UnsuperviseModel(embedder=jax_net(flows[0]),
                                  context_embedder=jax_net(flows[1]),
                                  edge_types=(0,), num_negs=NEGS)
    mt = UnsuperviseModel(port_net(), port_net(), (0,), num_negs=NEGS,
                          device="cpu")
    return mj, mt, flows


def reference(monkeypatch, mj, flows, variables, gj, roots, key):
    """The reference's outputs and gradients, and the keys of its draws:
    (outputs, grads, positive hop key, negatives key, tower flow keys)."""
    rec = {"snf": [], "node": []}
    real_snf = jax_sampling.sample_neighbor_fast
    real_node = jax_sampling.sample_node

    def snf(g, k, *a, **kw):
        rec["snf"].append(k)
        return real_snf(g, k, *a, **kw)

    def node(g, k, *a, **kw):
        rec["node"].append(k)
        return real_node(g, k, *a, **kw)

    def loss_fn(p, g, roots, key):
        for lst in list(rec.values()) + [f.keys for f in flows]:
            lst.clear()
        out = mj.apply(p, g, roots, rngs={"sample": key})
        keys = (rec["snf"][0], rec["node"][0],
                [k for f in flows for k in f.keys])
        return out["loss"], (out, keys)

    monkeypatch.setattr(jax_sampling, "sample_neighbor_fast", snf)
    monkeypatch.setattr(jax_sampling, "sample_node", node)
    (_, (out, keys)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables, gj.tensors, jnp.asarray(roots),
                                key)
    monkeypatch.setattr(jax_sampling, "sample_neighbor_fast", real_snf)
    monkeypatch.setattr(jax_sampling, "sample_node", real_node)
    return out, grads, keys


def as_port(mt, tree):
    holder = load_flax_params(copy.deepcopy(mt),
                              jax.tree.map(np.asarray, tree))
    return {k: v.detach().numpy().copy()
            for k, v in holder.named_parameters()}


def run_both(monkeypatch, which, toy_pair, sage_pair, seed=0):
    """(reference outputs, reference grads in the port's layout, port
    model, port outputs) of one forward from the same tree and draws."""
    gj, gt = toy_pair if which == "embed" else sage_pair
    n = gt.meta.n_nodes
    mj, mt, flows = (embed_models(n) if which == "embed" else sage_models())
    roots = (np.arange(n, dtype=np.int32) if which == "embed" else
             np.arange(5, 37, dtype=np.int32))
    roots[-1] = -1                                  # a padded batch row
    B = len(roots)
    # flax's tree, traced and not compiled, with values drawn by numpy
    shapes = jax.eval_shape(mj.init, {"params": jax.random.PRNGKey(0),
                                      "sample": jax.random.PRNGKey(1)},
                            gj.tensors, jnp.asarray(roots))
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   * s.shape[-1] ** -0.5).astype(s.dtype), shapes)
    load_flax_params(mt, jax.tree.map(np.asarray, variables))
    out, grads, (k_pos, k_neg, k_towers) = reference(
        monkeypatch, mj, flows, variables, gj, roots, jax.random.PRNGKey(7))
    typed = which == "embed"                  # two edge types, no fanu
    uniforms = [key_uniforms(k_pos, B, 1, typed), node_uniforms(k_neg,
                                                                B * NEGS)]
    if flows:
        uniforms += [hop_uniforms(k, c, FANOUTS)
                     for k, c in zip(k_towers, (B, B, B * NEGS))]
    else:
        uniforms += [None] * 3
    got = mt(gt.tensors, torch.from_numpy(roots), uniforms=uniforms)
    return out, as_port(mt, grads), mt, got


@pytest.mark.parametrize("which", ["embed", "sage"])
def test_forward_loss_and_gradients_match(monkeypatch, toy_pair, sage_pair,
                                          which):
    want, g_want, mt, got = run_both(monkeypatch, which, toy_pair,
                                     sage_pair)
    for name in ("embedding", "logits", "neg_logits", "pos_mask"):
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(want[name]), err_msg=name,
                                   **TOL)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               **TOL)
    # the padded row has no positive; most others do
    pos_ok = got["pos_mask"][:, 0]
    assert pos_ok[-1] == 0 and pos_ok.mean() > 0.5
    got["loss"].backward()
    names = [n for n, _ in mt.named_parameters()]
    assert sorted(g_want) == sorted(names)
    assert len(names) == (2 if which == "embed" else 12)
    for n, p in mt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_want[n], err_msg=n,
                                   **TOL)
        assert np.abs(g_want[n]).max() > 0, n


def test_embed_only_minus_one_row():
    mj = jax_gnn.EmbedOnly(max_id=9, dim=4)
    roots = np.array([0, -1, 9, 3, -1], np.int32)
    variables = mj.init(jax.random.PRNGKey(0), None, jnp.asarray(roots))
    want = np.asarray(mj.apply(variables, None, jnp.asarray(roots)))
    mt = load_flax_params(EmbedOnly(9, 4, device="cpu"),
                          jax.tree.map(np.asarray, variables))
    assert mt.embed.weight.shape == (11, 4)
    got = mt(None, torch.from_numpy(roots)).detach().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], mt.embed.weight[10].detach())
    np.testing.assert_array_equal(got[1], got[4])


def test_unsupervised_evaluate_is_the_reference_metric(toy_pair):
    # evaluate pools the positives' logits and their negatives' over the
    # batches, strips the padding and applies the metric: the reference's
    # mrr, mr and hit3 of the same outputs
    _, gt = toy_pair
    n = gt.meta.n_nodes
    _, mt, _ = embed_models(n)
    est = NodeEstimator(mt, gt, RunConfig(batch_size=3, metric="mrr"),
                        device="cpu")
    seen = []
    forward = mt.forward
    mt.forward = lambda *a, **kw: seen.append(forward(*a, **kw)) or seen[-1]
    ids = np.arange(n)
    for name in ("mrr", "mr", "hit3"):
        seen.clear()
        est.config.metric = name
        res = est.evaluate(ids)
        assert len(seen) == -(-n // 3)
        pos = np.concatenate([o["logits"].numpy() for o in seen])[:n]
        neg = np.concatenate([o["neg_logits"].numpy() for o in seen])[:n]
        want = jax_metrics.get(name)(jnp.asarray(pos), jnp.asarray(neg))
        np.testing.assert_allclose(res[name], float(want), rtol=1e-6)
        loss = np.mean([float(o["loss"]) for o in seen])
        np.testing.assert_allclose(res["loss"], loss, rtol=1e-6)


def test_unsupervised_model_trains(sage_pair):
    _, gt = sage_pair
    gen = torch.Generator().manual_seed(0)

    def net():
        return GNNNet("sage", SageDataFlow(FANOUTS, [(0,), (0,)]), (16, 16),
                      ShallowEncoder(("feature",)), in_dim=16, device="cpu",
                      generator=gen)
    model = UnsuperviseModel(net(), net(), (0,), num_negs=NEGS, device="cpu")
    est = NodeEstimator(model, gt, RunConfig(
        batch_size=64, total_steps=20, learning_rate=0.01, log_steps=0,
        metric="mrr", reservoir_refresh=10), device="cpu")
    before = est.evaluate(np.arange(256))
    res = est.train()
    after = est.evaluate(np.arange(256))
    assert np.isfinite(res["loss"]) and after["loss"] < before["loss"]
    emb = est.infer(np.arange(100))
    assert emb.shape == (100, 16) and np.isfinite(emb).all()
