"""The transe slice of the PyTorch port against euler_tpu, in f32 on the
CPU: the edge alias tables, the edge draw, the TransX family, full-entity
ranking, the ranking metrics and ``EdgeEstimator``.

- ``edge_alias`` and ``select_edges`` must equal the reference bit for
  bit; the uniforms the reference derives from its key (``kt, kd =
  split(key)``, then ``k1, k2 = split(kd)`` for a draw over every type,
  ``k1, k2 = split(key)`` for one type) are handed to the port's select.
  Every graph here is built with the numpy CSR sort on both sides, so the
  CSR slots (the edge population) come in one order.
- The models: flax's tree (traced with ``eval_shape``, never compiled)
  with values drawn by numpy, loaded into the port; the negative draw's key
  recorded by wrapping ``euler_tpu.ops.sampling.sample_node`` (which
  kg.py calls through the module) and returned by the jitted
  ``value_and_grad`` beside its outputs; loss,
  logits, neg_logits, embedding and every gradient within rtol = atol =
  1e-5 (different summation order of the CPU reductions).
- Full-entity ranks: scores within 1e-5; ranks equal except where two of
  the reference's scores lie within 1e-6 of each other, and there equal
  to a numpy ranking of the port's own scores.
"""
import copy
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from euler_tpu.models import kg as jax_kg
from euler_tpu.ops import sampling as jax_sampling
from euler_tpu.utils import metrics as jax_metrics
from euler_tpu_torch import bench
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import EdgeEstimator, RunConfig, get_optimizer
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.graph.store import xla_cumsum
from euler_tpu_torch.models import ShardedEmbedding, kg, load_flax_params
from euler_tpu_torch.ops import sampling
from euler_tpu_torch.parallel import train
from euler_tpu_torch.utils import metrics
from tests.test_torch_graph import native_off, random_pair

TOL = dict(rtol=1e-5, atol=1e-5)
ALIAS_FIELDS = ("ids", "type_ptr", "prob", "alias", "w_sum")
DIM, NEGS, B = 8, 4, 24


_sample_edge = jax.jit(jax_sampling.sample_edge, static_argnums=(2, 3))


def t(x):
    return torch.from_numpy(np.array(x))


def edge_uniforms(key, count, edge_type):
    """(u_type, u1, u2) that the reference's sample_edge draws from key."""
    if edge_type == -1:
        kt, key = jax.random.split(key)
        u_type = jax.random.uniform(kt, (count,))
    else:
        u_type = jnp.zeros((count,), jnp.float32)
    k1, k2 = jax.random.split(key)
    return tuple(t(u) for u in (u_type, jax.random.uniform(k1, (count,)),
                                jax.random.uniform(k2, (count,))))


@pytest.fixture(scope="module")
def graphs():
    """bench.py's transe graph at test size: 16 edge types."""
    return random_pair(2000, 25, num_edge_types=16, seed=0)


@pytest.fixture(scope="module")
def sparse_types():
    """40 edge types over 30 edges: most types are empty."""
    return random_pair(30, 1, num_edge_types=40, seed=4)


@pytest.fixture(scope="module")
def toy_pair(toy_dir):
    from euler_tpu.graph import load_graph as jax_load_graph
    with native_off(("build_csr_native",)):
        return jax_load_graph(toy_dir), load_graph(toy_dir, device="cpu")


# ---------------------------------------------------------- edge draws --

@pytest.mark.parametrize("which", ["toy", "random16", "sparse"])
def test_edge_alias_tables_match(which, toy_pair, graphs, sparse_types):
    gj, gt = {"toy": toy_pair, "random16": graphs,
              "sparse": sparse_types}[which]
    ej, et = gj.tensors.edge_alias, gt.tensors.edge_alias
    for name in ALIAS_FIELDS:
        np.testing.assert_array_equal(getattr(et, name).numpy(),
                                      np.asarray(getattr(ej, name)),
                                      err_msg=name)
    # the cdf is the reference's jnp.cumsum(w_sum), bit for bit
    np.testing.assert_array_equal(et.cdf.numpy(),
                                  np.asarray(jnp.cumsum(ej.w_sum)))
    assert et.type_ptr.shape[0] == gt.meta.num_edge_types + 1
    moved = gt.tensors.to("meta").edge_alias
    assert all(getattr(moved, f).device.type == "meta"
               for f in ALIAS_FIELDS + ("cdf",))


@pytest.mark.parametrize("n", [3, 16, 17, 300, 5000])
def test_xla_cumsum_matches_jnp_cumsum(n):
    # past 16 values XLA sums in blocks, and past 256 the block totals in
    # blocks again: 300 and 5000 reach the recursion, bit for bit
    w = np.random.default_rng(n).random(n).astype(np.float32) * 1000
    np.testing.assert_array_equal(xla_cumsum(w), np.asarray(jnp.cumsum(w)))


def test_edge_alias_exists_without_packs():
    g = random_graph(300, 5, num_edge_types=3, packs=(), device="cpu")
    assert g.tensors.fan_pack is None
    assert int(g.tensors.edge_alias.type_ptr[-1]) == 300 * 5


@pytest.mark.parametrize("edge_type", [-1, 3, "11", 15])
def test_select_edges_bit_exact(graphs, edge_type):
    gj, gt = graphs
    key = jax.random.PRNGKey(hash(str(edge_type)) % 1000)
    count = 4097
    want = _sample_edge(gj.tensors, key, count, edge_type)
    got = sampling.select_edges(gt.tensors, edge_type,
                                *edge_uniforms(key, count, edge_type))
    for name, w, g in zip(("src", "dst", "etype", "eid"), want, got):
        assert g.dtype == torch.int32 and g.shape == (count,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    types = set(got[2].tolist())
    assert types == (set(range(16)) if edge_type == -1 else
                     {gt.meta.edge_type_id(edge_type)})


def test_select_edges_over_empty_types(sparse_types):
    gj, gt = sparse_types
    counts = np.bincount(gt.tensors.adj_type.numpy(), minlength=40)
    empty = int(np.nonzero(counts == 0)[0][0])
    for edge_type in (-1, empty):
        key = jax.random.PRNGKey(3)
        want = _sample_edge(gj.tensors, key, 500, edge_type)
        got = sampling.select_edges(gt.tensors, edge_type,
                                    *edge_uniforms(key, 500, edge_type))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if edge_type == -1:
            # an empty type has weight 0: the cdf never lands on it
            assert (got[0] >= 0).all() and (counts[got[2].numpy()] > 0).all()
        else:
            assert all((g == -1).all() for g in got)


def test_sample_edge_distribution():
    # P(edge) = w / sum(w) over every type: each slot's frequency
    g = random_graph(40, 2, num_edge_types=3, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(0)
    n = 200_000
    src, dst, ty, eid = sampling.sample_edge(g.tensors, n, -1, gen)
    w = g.tensors.adj_w.numpy()
    slot_of = np.argsort(g.tensors.adj_eid.numpy())
    freq = np.bincount(slot_of[eid.numpy()], minlength=len(w)) / n
    np.testing.assert_allclose(freq, w / w.sum(), atol=0.004)
    s = slot_of[eid.numpy()]
    assert (g.tensors.adj_src.numpy()[s] == src.numpy()).all()
    assert (g.tensors.adj_type.numpy()[s] == ty.numpy()).all()


# -------------------------------------------------------------- models --

MODELS = {
    "TransE": (jax_kg.TransE, kg.TransE, {}),
    "TransH": (jax_kg.TransH, kg.TransH, {}),
    "TransR": (jax_kg.TransR, kg.TransR, {}),
    "TransD": (jax_kg.TransD, kg.TransD, {}),
    "DistMult": (jax_kg.DistMult, kg.DistMult, {}),
    "DistMult-l2": (jax_kg.DistMult, kg.DistMult,
                    dict(l2_regular=True, regular_param=0.01)),
    "TransE-L2-tail": (jax_kg.TransE, kg.TransE,
                       dict(l1=False, corrupt="tail")),
    "TransE-front": (jax_kg.TransE, kg.TransE, dict(corrupt="front")),
}


def triples_of(gj, n, seed):
    src, dst, ty, _ = _sample_edge(gj.tensors, jax.random.PRNGKey(seed), n,
                                   -1)
    return np.stack([np.asarray(x) for x in (src, dst, ty)], 1)


@functools.lru_cache(maxsize=None)
def reference_model(name, over, n_entities, n_relations):
    """The flax model of one configuration (``over``: sorted (key, value)
    pairs over ``MODELS[name]``'s) with its jitted ``init`` and its jitted
    ``value_and_grad`` step, compiled once for every test that uses them.

    The step returns, beside the outputs, the key the model hands
    ``sample_node``: ``sample_node`` is wrapped to record it while the
    step is traced. ``init`` gives the tree of flax's init (traced, not
    compiled) with values drawn from ``seed`` by numpy, normal with a
    standard deviation of features ** -0.5, as flax's embed init."""
    cls_j, _, kw = MODELS[name]
    mj = cls_j(n_entities=n_entities, n_relations=n_relations, ent_dim=DIM,
               rel_dim=DIM, num_negs=NEGS, **dict(kw, **dict(over)))
    real = jax_sampling.sample_node
    keys = []

    def record(g, k, count, node_type=-1):
        keys.append(k)
        return real(g, k, count, node_type)

    def loss_fn(p, g, batch, key):
        keys.clear()
        jax_sampling.sample_node = record
        try:
            out = mj.apply(p, g, batch, rngs={"sample": key})
        finally:
            jax_sampling.sample_node = real
        return out["loss"], (out, keys[0])

    def init(seed, g, batch):
        shapes = jax.eval_shape(mj.init, {"params": jax.random.PRNGKey(0),
                                          "sample": jax.random.PRNGKey(1)},
                                g, batch)
        rng = np.random.default_rng(seed)
        return jax.tree.map(
            lambda s: (rng.standard_normal(s.shape)
                       * s.shape[-1] ** -0.5).astype(s.dtype), shapes)

    return mj, init, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def build(name, gj, seed=0, **over):
    """(jax model, variables in its tree drawn from ``seed``, the port's
    model with them, the reference's step: (variables, graph, batch, key)
    -> its outputs, its gradients and the uniforms of its negative
    draw)."""
    mj, init, step = reference_model(name, tuple(sorted(over.items())),
                                     gj.meta.n_nodes, gj.meta.num_edge_types)
    variables = init(seed, gj.tensors, jnp.zeros((B, 3), jnp.int32))
    mt = MODELS[name][1](n_entities=mj.n_entities, n_relations=mj.n_relations,
                         ent_dim=DIM, rel_dim=DIM, num_negs=NEGS,
                         **dict(MODELS[name][2], **over), device="cpu")
    load_flax_params(mt, jax.tree.map(np.asarray, variables))

    def run(variables, gj, batch, key):
        (_, (out, k)), grads = step(variables, gj.tensors,
                                    jnp.asarray(batch), key)
        kt, kd = jax.random.split(k)
        k1, k2 = jax.random.split(kd)
        n = len(batch) * NEGS
        u = tuple(t(jax.random.uniform(x, (n,))) for x in (kt, k1, k2))
        return out, grads, u
    return mj, variables, mt, run


def as_port(mt, tree):
    """A flax-layout tree in the port's layout: parameter name -> array."""
    holder = load_flax_params(copy.deepcopy(mt),
                              jax.tree.map(np.asarray, tree))
    return {k: v.detach().numpy().copy()
            for k, v in holder.named_parameters()}


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_gradients_match(graphs, name):
    check_forward_and_gradients(graphs, name)


def check_forward_and_gradients(graphs, name, **over):
    gj, gt = graphs
    _, variables, mt, reference_step = build(name, gj, **over)
    batch = triples_of(gj, B, 7)
    batch[3, 0] = -1                          # clamped to entity 0
    want, grads_j, u = reference_step(variables, gj, batch,
                                      jax.random.PRNGKey(5))
    got = mt(gt.tensors, t(batch), uniforms=u)
    for out in ("logits", "neg_logits", "embedding"):
        assert got[out].shape == tuple(np.shape(want[out])), out
        np.testing.assert_allclose(got[out].detach().numpy(),
                                   np.asarray(want[out]), err_msg=out, **TOL)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               **TOL)
    assert float(want["loss"]) > 0
    got["loss"].backward()
    g_want = as_port(mt, grads_j)
    assert sorted(g_want) == sorted(n for n, _ in mt.named_parameters())
    for n, p in mt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_want[n], err_msg=n,
                                   **TOL)
        assert np.abs(g_want[n]).max() > 0, n


def test_l1_gradient_at_a_zero_difference(graphs, monkeypatch):
    # XLA's |x| has gradient 1 at x = 0 (torch.abs: 0): triples whose head
    # is their tail under a relation with zero components differ by an
    # exact 0 there, and the gradients must still match
    gj, gt = graphs
    # a wide margin keeps every row's hinge active
    _, variables, mt, reference_step = build("TransE", gj, seed=3,
                                             margin=10.0)
    p = jax.tree.map(np.array, variables)
    p["params"]["relation_encoder"]["embedding"][:, ::2] = 0.0
    load_flax_params(mt, p)
    batch = triples_of(gj, B, 8)
    batch[:, 1] = batch[:, 0]
    want, grads_j, u = reference_step(p, gj, batch, jax.random.PRNGKey(4))
    got = mt(gt.tensors, t(batch), uniforms=u)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               **TOL)
    got["loss"].backward()
    g_want = as_port(mt, grads_j)
    for n, q in mt.named_parameters():
        np.testing.assert_allclose(q.grad.numpy(), g_want[n], err_msg=n,
                                   **TOL)
    # and the zero differences matter: torch.abs's gradient there differs
    monkeypatch.setattr(kg, "xla_abs", torch.abs)
    mt.zero_grad()
    mt(gt.tensors, t(batch), uniforms=u)["loss"].backward()
    assert not all(np.allclose(q.grad.numpy(), g_want[n], **TOL)
                   for n, q in mt.named_parameters())


def test_three_adam_steps_match_optax(graphs):
    # dense Adam over whole tables: rows without a gradient still move
    # once their moments are set, on both sides
    gj, gt = graphs
    _, variables, mt, step = build("TransE", gj, seed=2)
    tx = optax.adam(1e-3)
    params, state = variables, tx.init(variables)
    update = jax.jit(tx.update)
    est = EdgeEstimator(mt, gt, RunConfig(batch_size=B), device="cpu")
    opt = get_optimizer("adam", 1e-3, mt.parameters())
    ok = None
    for k in range(3):
        batch = triples_of(gj, B, 20 + k)
        out, grads_j, u = step(params, gj, batch, jax.random.PRNGKey(30 + k))
        loss_j = out["loss"]
        upd, state = update(grads_j, state, params)
        params = optax.apply_updates(params, upd)
        loss_t = est.step(opt, t(batch), uniforms=u)
        np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
        g_want = as_port(mt, grads_j)
        # an element whose gradient is tiny may take Adam's step in either
        # direction: compare where the gradients are 0 or clearly not
        now = {n: ((np.abs(g_want[n]) > 1e-6) & (np.abs(p.grad.numpy())
                                                 > 1e-6))
               | ((g_want[n] == 0) & (p.grad.numpy() == 0))
               for n, p in mt.named_parameters()}
        ok = now if ok is None else {n: ok[n] & now[n] for n in now}
        want = as_port(mt, params)
        for n, p in mt.named_parameters():
            m = ok[n]
            assert m.mean() > 0.9, n
            np.testing.assert_allclose(p.detach().numpy()[m], want[n][m],
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{n} step {k}")
    touched = np.abs(as_port(mt, params)["entity_encoder.weight"]
                     - as_port(mt, variables)["entity_encoder.weight"])
    assert (touched.max(1) > 0).mean() > 0.05


def test_ids_past_the_table_give_nan_rows(graphs):
    # flax's Embed is jnp.take in fill mode: src = n_entities + 1 reads no
    # row; the port gives the same NaN row and no gradient to the row its
    # clamped id reads
    gj, gt = graphs
    _, variables, mt, reference_step = build("TransE", gj)
    E = gj.meta.n_nodes
    batch = triples_of(gj, B, 3)
    batch[0, 0] = E + 1
    batch[1, 0] = E                       # the table's extra row: valid
    want, _, u = reference_step(variables, gj, batch, jax.random.PRNGKey(2))
    got = mt(gt.tensors, t(batch), uniforms=u)
    emb_j, emb_t = np.asarray(want["embedding"]), got["embedding"]
    assert np.isnan(emb_j[0]).all() and torch.isnan(emb_t[0]).all()
    assert np.isfinite(emb_j[1:]).all() and torch.isfinite(emb_t[1:]).all()
    np.testing.assert_allclose(emb_t[1:].detach().numpy(), emb_j[1:], **TOL)
    emb_t[1:].sum().backward()
    grad = mt.entity_encoder.weight.grad
    assert torch.isfinite(grad).all()
    rows = set(batch[1:, 0].tolist())
    assert E in rows and (grad[E] != 0).any()
    others = torch.ones(E + 1, dtype=torch.bool)
    others[list(rows)] = False
    assert (grad[others] == 0).all()


def test_shard_embeddings_on_one_device_matches(graphs):
    """``shard_embeddings=True`` (which raised before the mesh path):
    the entity table is a ``ShardedEmbedding``; on one device its
    forward and gradients are the reference's non-mesh branch's, and
    over the mesh it lays out one block a shard (the mesh's steps:
    tests/test_torch_sharded_models.py)."""
    check_forward_and_gradients(graphs, "TransE", shard_embeddings=True)
    m = kg.TransE(10, 2, 4, 4, shard_embeddings=True, device="cpu")
    assert isinstance(m.entity_encoder, ShardedEmbedding)
    specs = train.init_sharded_params(
        m, types.SimpleNamespace(graph=4, graph_index=1))
    assert m.entity_encoder.embedding.shape == (3, 4)     # ceil(11 / 4)
    assert {k for k, v in specs.items() if v == "graph"} == {
        "entity_encoder.embedding"}


# ------------------------------------------------------------- ranking --

T_RANK = 10


@pytest.fixture(scope="module")
def ranked(graphs):
    """name -> (flax model, variables, port model, T_RANK triples, {direction:
    (the reference's [T, E] scores, the port's)}), computed once a model
    for the ranking tests."""
    gj, gt = graphs
    cache = {}

    def get(name):
        if name not in cache:
            mj, variables, mt, _ = build(name, gj, seed=6)
            triples = triples_of(gj, T_RANK, 11)
            scores = {}
            for d in ("tail", "head"):
                sj = mj.apply(variables, gj.tensors, jnp.asarray(triples),
                              method=mj.rank_against_all, direction=d)
                with torch.no_grad():
                    st = mt.rank_against_all(gt.tensors, t(triples), d)
                scores[d] = (np.asarray(sj), st.numpy())
            cache[name] = mj, variables, mt, triples, scores
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["TransE", "TransH", "TransR", "TransD",
                                  "DistMult"])
def test_rank_against_all_matches(graphs, ranked, name):
    *_, scores = ranked(name)
    for d, (want, got) in scores.items():
        assert got.shape == (T_RANK, graphs[1].meta.n_nodes)
        np.testing.assert_allclose(got, want, err_msg=d, **TOL)


def expected_ranks(score_j, score_t, tgt, known):
    """Ranks under the near-tie rule: the reference's where no other score
    lies within 1e-6 of the true one, the port's own numpy ranking where
    one does. ``known`` masks filtered candidates ([B, E] bool)."""
    rows = np.arange(len(tgt))
    pos_j = score_j[rows, tgt][:, None]
    pos_t = score_t[rows, tgt][:, None]
    rank_j = 1 + ((score_j > pos_j) & ~known).sum(1)
    rank_t = 1 + ((score_t > pos_t) & ~known).sum(1)
    other = np.ones_like(known)
    other[rows, tgt] = False
    near = (np.abs(score_j - pos_j) < 1e-6) & other
    return np.where(near.any(1), rank_t, rank_j), rank_j


def summary(ranks, hit_ks=(1, 3, 10)):
    r = np.asarray(ranks, np.float64)
    out = {"mr": r.mean(), "mrr": (1.0 / r).mean()}
    out.update({f"hit{k}": (r <= k).mean() for k in hit_ks})
    return out


@pytest.fixture(scope="module")
def known(graphs, ranked):
    """The filtered setting's known triples: each ranked triple's best
    competitor in both directions, the triples themselves and a sample of
    the graph's edges; and per direction the [T, E] mask of candidates
    they filter out."""
    gj, _ = graphs
    *_, triples, scores = ranked("TransE")
    rows = []
    for d, o in (("tail", 1), ("head", 0)):
        s = scores[d][0].copy()
        s[np.arange(T_RANK), triples[:, o]] = -np.inf
        r = triples.copy()
        r[:, o] = s.argmax(1)
        rows.append(r)
    known_triples = np.concatenate(rows + [triples, triples_of(gj, 3000, 12)])
    kt = {tuple(x) for x in known_triples.tolist()}
    masks = {}
    for d, o in (("tail", 1), ("head", 0)):
        m = np.zeros((T_RANK, gj.meta.n_nodes), bool)
        for i, row in enumerate(triples.tolist()):
            for e in range(gj.meta.n_nodes):
                cand = list(row)
                cand[o] = e
                m[i, e] = e != row[o] and tuple(cand) in kt
        masks[d] = m
    return known_triples, masks


@pytest.mark.parametrize("corrupt", ["head", "tail", "both"])
@pytest.mark.parametrize("filtered", [False, True])
def test_rank_all_entities_matches(graphs, ranked, known, corrupt, filtered):
    gj, gt = graphs
    mj, variables, mt, triples, scores = ranked("TransE")
    E = gj.meta.n_nodes
    known_triples, masks = known if filtered else (None, None)
    ref = jax_kg.rank_all_entities(mj, variables, gj.tensors, triples,
                                   batch_size=4, corrupt=corrupt,
                                   filter_known=known_triples)
    got = kg.rank_all_entities(mt, gt.tensors, triples, batch_size=4,
                               corrupt=corrupt, filter_known=known_triples)
    exp, exp_ref = [], []
    for d in {"head": ["head"], "tail": ["tail"],
              "both": ["tail", "head"]}[corrupt]:
        o = 1 if d == "tail" else 0
        mask = masks[d] if filtered else np.zeros((T_RANK, E), bool)
        e_port, e_ref = expected_ranks(*scores[d], triples[:, o], mask)
        exp.append(e_port)
        exp_ref.append(e_ref)
    for k, v in summary(np.concatenate(exp_ref)).items():
        assert ref[k] == pytest.approx(v, rel=1e-12), k
    for k, v in summary(np.concatenate(exp)).items():
        assert got[k] == pytest.approx(v, rel=1e-12), k
    np.testing.assert_array_equal(
        kg.entity_ranks(mt, gt.tensors, triples, batch_size=4,
                        corrupt=corrupt, filter_known=known_triples),
        np.concatenate(exp))
    assert set(got) == set(ref)
    if filtered:
        plain = kg.rank_all_entities(mt, gt.tensors, triples, batch_size=4,
                                     corrupt=corrupt)
        assert got["mr"] < plain["mr"]


def test_rank_targets_outside_the_table(graphs):
    # a true entity of -1 (sample_edge's empty draw) reads the last score,
    # as take_along_axis wraps it; one past the table reads NaN: rank 1
    gj, gt = graphs
    mj, variables, mt, _ = build("TransE", gj, seed=8)
    E = gj.meta.n_nodes
    triples = triples_of(gj, 6, 13)
    triples[0, 1], triples[1, 1], triples[2, 0] = -1, E + 3, -1
    for corrupt in ("tail", "head"):
        want = jax_kg.rank_all_entities(mj, variables, gj.tensors, triples,
                                        batch_size=4, corrupt=corrupt)
        got = kg.rank_all_entities(mt, gt.tensors, triples, batch_size=4,
                                   corrupt=corrupt)
        assert got == pytest.approx(want, rel=1e-12), corrupt
    ranks = kg.entity_ranks(mt, gt.tensors, triples, 4, "tail")
    assert ranks[1] == 1


def test_filtered_ranking_keeps_the_int32_limit():
    m = kg.TransE(2 ** 11, 2 ** 20, 2, 2, device="cpu")
    with pytest.raises(ValueError, match="overflow"):
        kg.rank_all_entities(m, None, np.zeros((1, 3), np.int32),
                             filter_known=np.zeros((1, 3), np.int32))


# ------------------------------------------------------------- metrics --

@pytest.mark.parametrize("masked", [False, True])
def test_ranking_metrics_match_with_ties(masked):
    rng = np.random.default_rng(8)
    # integer-valued scores: many ties between a positive and its negatives
    pos = rng.integers(0, 5, (64, 1)).astype(np.float32)
    neg = rng.integers(0, 5, (64, 12)).astype(np.float32)
    mask = (rng.random(64) < 0.7).astype(np.float32) if masked else None
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else t(mask)
    for name in ("mrr", "mr", "hit1", "hit3", "hit10"):
        want = jax_metrics.get(name)(jnp.asarray(pos), jnp.asarray(neg),
                                     mask=mj)
        got = metrics.get(name)(t(pos), t(neg), mask=mt)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=name)
    labels = (rng.random(200) < 0.3).astype(np.float32)
    scores = rng.integers(0, 6, 200).astype(np.float32)   # ties: stable
    want = jax_metrics.auc(jnp.asarray(labels), jnp.asarray(scores))
    got = metrics.get("auc")(t(labels), t(scores))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ----------------------------------------------------------- estimator --

@pytest.fixture(scope="module")
def sbm(tmp_path_factory):
    from euler_tpu.datasets.synthetic import SBMDataset
    ds = SBMDataset(str(tmp_path_factory.mktemp("sbm_kg")), n_nodes=200,
                    n_classes=3, feat_dim=8, seed=3)
    ds.load_graph()
    with native_off(("build_csr_native",)):
        return load_graph(ds.data_dir, device="cpu")


def port_triples(graph, n, seed):
    gen = torch.Generator().manual_seed(seed)
    src, dst, ty, _ = sampling.sample_edge(graph.tensors, n, -1, gen)
    return torch.stack([src, dst, ty], 1).numpy()


def transe_estimator(graph, steps, **cfg):
    model = kg.TransE(n_entities=graph.meta.n_nodes,
                      n_relations=graph.meta.num_edge_types, ent_dim=16,
                      rel_dim=16, num_negs=8, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    return EdgeEstimator(model, graph, RunConfig(
        batch_size=128, total_steps=steps, learning_rate=0.05, log_steps=0,
        metric="mrr", **cfg), device="cpu")


def test_edge_estimator_rejects_node_ids(sbm):
    est = transe_estimator(sbm, 1)
    for call in (est.evaluate, est.infer):
        with pytest.raises(ValueError, match="triples"):
            call(np.arange(16))


def test_edge_estimator_trains_evaluates_and_infers(sbm):
    est = transe_estimator(sbm, 5)
    batch = est.train_batch(sbm.tensors, torch.Generator().manual_seed(1))
    assert batch.shape == (128, 3) and batch.dtype == torch.int32
    triples = port_triples(sbm, 100, 5)
    ev = est.evaluate(triples)
    assert set(ev) == {"mrr", "loss"} and 0 < ev["mrr"] <= 1
    res = est.train()
    assert res["steps"] == 5 and np.isfinite(res["loss"])
    emb = est.infer(triples)
    assert emb.shape == (100, 16) and np.isfinite(emb).all()
    rank = est.evaluate_ranking(triples[:20], corrupt="tail")
    assert set(rank) == {"mr", "mrr", "hit1", "hit3", "hit10"}


def test_infer_checks_node_columns_only():
    # relation 15 on a graph of 12 nodes is a valid triple
    g = random_graph(12, 4, num_edge_types=16, seed=2, device="cpu")
    model = kg.TransE(12, 16, 4, 4, device="cpu")
    est = EdgeEstimator(model, g, RunConfig(batch_size=8), device="cpu")
    emb = est.infer(np.array([[0, 1, 15], [11, 3, 14], [2, 2, 0]]))
    assert emb.shape == (3, 4) and np.isfinite(emb).all()
    with pytest.raises(ValueError, match="lie in"):
        est.infer(np.array([[12, 1, 0]]))


def test_transe_mrr_improves(sbm):
    # a copy of tests/test_kg_walk_graph.py::test_transe_mrr_improves
    est = transe_estimator(sbm, 150)
    test_triples = port_triples(sbm, 128, 5)
    before = est.evaluate(test_triples)["mrr"]
    est.train()
    after = est.evaluate(test_triples)["mrr"]
    assert after > before + 0.05, (before, after)


# --------------------------------------------------------------- bench --

def test_bench_transe_prints_bench_py_lines_on_the_cpu(capsys):
    # the command line ``python -m euler_tpu_torch.bench --model transe
    # --device cpu``, in this process
    assert bench.main(["--model", "transe", "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [r["phase"] for r in lines] == ["warmup", "single_loop",
                                           "pipelined"]
    for r in lines:
        assert set(r) == {"metric", "model", "value", "unit", "vs_baseline",
                          "platform", "phase", "config"}
        assert r["metric"] == "transx_triples_per_sec_per_chip"
        assert r["model"] == "transe" and r["unit"] == "triples/s"
        assert r["vs_baseline"] is None and r["platform"] == "cpu"
        assert r["config"] == "b256_negs5_n2000_r16" and r["value"] > 0
