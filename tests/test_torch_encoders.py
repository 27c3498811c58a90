"""Sparse and edge features, and ``ShallowEncoder``'s id and sparse-id
embeddings, of the PyTorch port against euler_tpu, in f32 on the CPU.

- The store: the toy graph's sparse node features, dense and sparse edge
  features and each edge row's type, equal array for array.
- The lookups ``get_sparse_feature`` (-1 rows for ids < 0, INT32_MIN,
  ``jnp.take``'s integer fill, for ids >= N), ``get_edge_dense_feature``,
  ``get_edge_sparse_feature`` and ``get_edge_type``: equal.
- ``ShallowEncoder`` with the id table, dense features and a sparse
  feature (sum and mean), on ids -1, in range and past the graph: the
  forward equal where NaN (ids past the tables), within rtol = atol =
  1e-6 elsewhere, and the tables' gradients within 1e-5.
- A sage ``SuperviseModel`` over that encoder through ``SageDataFlow``
  with the reference's uniforms: loss and embeddings within 1e-5, every
  gradient, the tables' included, within 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu.ops import feature_ops as jax_feature_ops
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import (GNNNet, ShallowEncoder, SuperviseModel,
                                    load_flax_params)
from euler_tpu_torch.models.from_flax import _load_encoder
from euler_tpu_torch.ops import feature_ops
from tests.test_torch_graph import random_pair
from tests.test_torch_models import RecordingFlow, hop_uniforms
from tests.test_torch_train import _as_port

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# the toy graph's 8 nodes, padding, and ids past the graph (8 is the id
# table's row of -1 when max_id = 7, 9 and 100 past every table)
NODES = np.array([-1, 0, 3, 7, 2, 8, 9, 100, 5, 5], np.int32)
EIDS = np.array([-1, 0, 4, 10, 11, 50, 3, 3], np.int32)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def toy_pair(toy_dir):
    return jax_load_graph(toy_dir), load_graph(toy_dir, device="cpu")


def test_store_holds_sparse_and_edge_features(toy_pair):
    gj, gt = toy_pair
    tj, tt = gj.tensors, gt.tensors
    for name in ("sparse_nf", "sparse_ef"):
        a, b = getattr(tj, name), getattr(tt, name)
        assert set(a) == set(b) and a, name
        for k in a:
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(y.numpy(), np.asarray(x),
                                              err_msg=f"{name} {k}")
    assert set(tj.dense_ef) == set(tt.dense_ef) == {"edense"}
    np.testing.assert_array_equal(tt.dense_ef["edense"].numpy(),
                                  np.asarray(tj.dense_ef["edense"]))
    np.testing.assert_array_equal(tt.eid_type.numpy(),
                                  np.asarray(tj.eid_type))
    moved = tt.to("meta")
    ids, lens = moved.sparse_nf["sparse_ids"]
    assert ids.device.type == lens.device.type == "meta"
    assert moved.eid_type.device.type == "meta"
    assert moved.dense_ef["edense"].device.type == "meta"


def test_edge_ids_must_be_a_dense_permutation():
    from euler_tpu_torch.graph.store import _check_edge_ids
    _check_edge_ids(np.array([2, 0, 1], np.int32))
    with pytest.raises(ValueError, match="dense permutation"):
        _check_edge_ids(np.array([0, 1, 3], np.int32))


def test_sparse_lookup_fills_as_jnp_take(toy_pair):
    gj, gt = toy_pair
    (ids_j, m_j), = jax.jit(lambda g, n: jax_feature_ops.get_sparse_feature(
        g, n, ["sparse_ids"]))(gj.tensors, jnp.asarray(NODES))
    (ids_t, m_t), = feature_ops.get_sparse_feature(gt.tensors, t(NODES),
                                                   ["sparse_ids"])
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    past = NODES >= 8
    assert (ids_t.numpy()[past] == np.iinfo(np.int32).min).all()
    assert (ids_t.numpy()[NODES < 0] == -1).all()
    assert not m_t.numpy()[past | (NODES < 0)].any()
    # a 2-D batch of ids keeps its shape
    (ids2, _), = feature_ops.get_sparse_feature(
        gt.tensors, t(NODES.reshape(2, 5)), ["sparse_ids"])
    assert ids2.shape == (2, 5, ids_t.shape[1])


def test_edge_lookups_match(toy_pair):
    gj, gt = toy_pair

    def ref(g, e):
        return (jax_feature_ops.get_edge_dense_feature(g, e, ["edense"]),
                jax_feature_ops.get_edge_sparse_feature(g, e, ["esparse"]),
                jax_feature_ops.get_edge_type(g, e))
    (dense_j,), ((sp_j, m_j),), ty_j = jax.jit(ref)(gj.tensors,
                                                   jnp.asarray(EIDS))
    e = t(EIDS)
    (dense_t,) = feature_ops.get_edge_dense_feature(gt.tensors, e,
                                                    ["edense"])
    ((sp_t, m_t),) = feature_ops.get_edge_sparse_feature(gt.tensors, e,
                                                         ["esparse"])
    ty_t = feature_ops.get_edge_type(gt.tensors, e)
    # dense: zeros for -1, NaN past E (compared as bits)
    np.testing.assert_array_equal(dense_t.numpy().view(np.int32),
                                  np.asarray(dense_j).view(np.int32))
    np.testing.assert_array_equal(sp_t.numpy(), np.asarray(sp_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(ty_t.numpy(), np.asarray(ty_j))
    assert ty_t.dtype == torch.int32 and int(ty_t[0]) == -1


ENCODERS = {
    "id": dict(use_id=True, max_id=7, id_dim=3),
    "sparse": dict(sparse_names=("sparse_ids",), sparse_buckets=5,
                   sparse_dim=4),
    "all": dict(dense_names=("dense2", "price"), use_id=True, max_id=7,
                id_dim=3, sparse_names=("sparse_ids",), sparse_buckets=7,
                sparse_dim=2),
}


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("parts", list(ENCODERS))
def test_shallow_encoder_matches(toy_pair, parts, combiner):
    gj, gt = toy_pair
    kw = dict(ENCODERS[parts], sparse_combiner=combiner)
    enc = jax_encoders.ShallowEncoder(**kw)
    rng = np.random.default_rng(len(parts))

    def ref(g, n):
        params = enc.init(jax.random.PRNGKey(3), g, n)
        out = enc.apply(params, g, n)
        cot = jnp.asarray(rng.normal(size=out.shape).astype(np.float32))

        def loss(p):
            o = enc.apply(p, g, n)
            return jnp.sum(jnp.where(jnp.isnan(o), 0.0, o) * cot)
        return params, out, cot, jax.grad(loss)(params)
    params, want, cot, grads = jax.jit(ref)(gj.tensors, jnp.asarray(NODES))
    port = ShallowEncoder(**{k: v for k, v in kw.items()})
    _load_encoder(port, jax.tree.map(np.asarray, params["params"]), "")
    got = port(gt.tensors, t(NODES))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert np.isnan(got.detach().numpy()).any() == (parts != "sparse")
    (torch.where(torch.isnan(got), 0.0, got) * t(cot)).sum().backward()
    twin = ShallowEncoder(**kw)
    _load_encoder(twin, jax.tree.map(np.asarray, grads["params"]), "")
    want_g = dict(twin.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want_g[name].detach().numpy(),
                                   err_msg=name, rtol=1e-5, atol=1e-5)


def test_shallow_encoder_needs_inputs_and_buckets():
    with pytest.raises(ValueError, match="no inputs"):
        ShallowEncoder()
    with pytest.raises(ValueError, match="sparse_buckets"):
        ShallowEncoder(sparse_names=("tags",))
    enc = ShallowEncoder(("feature",), use_id=True, max_id=9,
                         sparse_names=("a", "b"), sparse_buckets=4)
    assert [n for n, _ in enc.named_parameters()] == [
        "id_embedding.weight", "sparse.a.weight", "sparse.b.weight"]


# ------------------------------------------------------- the whole model --

FANOUTS, B, N = [3, 2], 32, 2000


@functools.lru_cache(maxsize=None)
def tagged_graphs():
    """The 2000-node test graph with an [N, 5] ``tags`` table (ids 0..99,
    -1 padding after random lengths 0-5) attached to both stores."""
    gj, gt = random_pair(N, 25, feat_dim=16, n_classes=4, seed=0)
    rng = np.random.default_rng(5)
    lens = rng.integers(0, 6, N).astype(np.int32)
    ids = rng.integers(0, 100, (N, 5)).astype(np.int32)
    ids[np.arange(5)[None, :] >= lens[:, None]] = -1
    gj_t = gj.tensors.replace(sparse_nf={"tags": (jnp.asarray(ids),
                                                  jnp.asarray(lens))})
    gt_t = dataclasses.replace(gt.tensors,
                               sparse_nf={"tags": (t(ids), t(lens))})
    return gj_t, gt_t


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_encoder_model_loss_and_gradients_match(combiner):
    gj, gt = tagged_graphs()
    kw = dict(dense_names=("feature",), use_id=True, max_id=N - 1,
              id_dim=8, sparse_names=("tags",), sparse_buckets=30,
              sparse_dim=8, sparse_combiner=combiner)
    metapath = [(0,), (0,)]
    flow = RecordingFlow(jax_flows.SageDataFlow(FANOUTS, metapath))
    model = jax_gnn.SuperviseModel(
        embedder=jax_gnn.GNNNet(conv="sage", flow=flow, dims=(16, 16),
                                feature=jax_encoders.ShallowEncoder(**kw)),
        label_name="label", label_dim=4)
    roots = np.arange(5, 5 + B, dtype=np.int32)
    roots[-2:] = -1

    def run(g, r):
        params = model.init({"params": jax.random.PRNGKey(0),
                             "sample": jax.random.PRNGKey(1)}, g, r)

        def loss(p):
            flow.keys.clear()
            out = model.apply(p, g, r, rngs={"sample": jax.random.PRNGKey(9)})
            return out["loss"], (out, flow.keys[-1])
        return params, jax.value_and_grad(loss, has_aux=True)(params)
    params, ((loss_j, (out_j, key)), grads) = jax.jit(run)(
        gj, jnp.asarray(roots))
    net = GNNNet("sage", SageDataFlow(FANOUTS, metapath), (16, 16),
                 ShallowEncoder(**kw), in_dim=8 + 16 + 8, device="cpu")
    port = load_flax_params(SuperviseModel(net, "label", 4, device="cpu"),
                            jax.tree.map(np.asarray, params))
    out = port(gt, t(roots), uniforms=hop_uniforms(key, B, FANOUTS))
    for name in ("embedding", "logit"):
        np.testing.assert_allclose(out[name].detach().numpy(),
                                   np.asarray(out_j[name]), err_msg=name,
                                   **TOL)
    np.testing.assert_allclose(out["loss"].item(), float(loss_j), **TOL)
    out["loss"].backward()
    want = _as_port(port, grads)
    assert {"embedder.feature.id_embedding.weight",
            "embedder.feature.sparse.tags.weight"} <= set(want)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)
        if "feature" in name:
            assert np.abs(want[name]).max() > 0, name
