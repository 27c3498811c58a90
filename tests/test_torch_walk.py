"""The walk family of the PyTorch port against euler_tpu on the CPU:
``_is_neighbor``, ``random_walk`` (unbiased, exact node2vec and
rejection node2vec, per-step edge types), ``check_bias_cap``,
``gen_pair``, and DeepWalk, Node2Vec and LINE loaded from flax trees and
run through ``NodeEstimator``.

The reference derives its uniforms from its key inside each verb; the
tests derive the same numbers from the key (a walk step's ``key, sub =
split(key)``, then ``sample_neighbor``'s chain, or each window's
``fold_in(sub, win)`` Gumbel keys, or each rejection try's ``sub, k1, k2
= split(sub, 3)``) and hand them to the port's deterministic selects.
Walk ids must be equal bit for bit, except in the exact node2vec step:
its Gumbel keys pass through ``log``, which XLA and torch may round
differently, so a row may differ where the reference's two best keys of
a step lie within 4 ulps; such rows are counted and must be under 0.1%.
The models' loss must agree within 1e-6 and every gradient within 1e-5,
their walks and negatives bit for bit (but for those near ties).
Generator-driven draws are tested by their distribution.
"""
import functools
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.models import walk_models as jax_walk_models
from euler_tpu.ops import sampling as jax_sampling
from euler_tpu.ops import walk as jax_walk
from euler_tpu.utils import metrics as jax_metrics
from euler_tpu_torch.estimator import NodeEstimator, RunConfig
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import LINE, DeepWalk, Node2Vec, load_flax_params
from euler_tpu_torch.ops import walk
from euler_tpu_torch.parallel import train
from tests.test_torch_verbs import graph_pair, uniforms

PACKS = ("group", "adj", "sample", "fan")
LOSS_TOL, GRAD_TOL = dict(rtol=1e-6, atol=1e-6), dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair():
    # three edge types, about 7 neighbors a node and type
    return graph_pair(400, 20, 3, seed=2)


@pytest.fixture(scope="module")
def toy_pair(toy_dir):
    return jax_load_graph(toy_dir), load_graph(toy_dir, packs=PACKS,
                                               device="cpu")


def walk_uniforms(key, B, walk_len, p=1.0, q=1.0, exact=True, cap=64,
                  windows=1):
    """The per-step uniforms the reference's random_walk draws from key."""
    out = []
    for _ in range(walk_len):
        key, sub = jax.random.split(key)
        if p == 1.0 and q == 1.0:
            out.append(uniforms(sub, (B, 1)))
        elif exact:
            out.append(tuple(t(jax.random.uniform(
                jax.random.fold_in(sub, win), (B, cap), minval=1e-20,
                maxval=1.0)) for win in range(windows)))
        else:
            tries = []
            for _ in range(walk.REJECT_TRIES):
                sub, k1, k2 = jax.random.split(sub, 3)
                tries.append(uniforms(k1, (B, 1))
                             + (t(jax.random.uniform(k2, (B,))),))
            out.append(tuple(tries))
    return out


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _reference_keys(g, cur, prev, ets, p, q, cap, offset, u):
    """One window's Gumbel-max keys of the reference's exact node2vec
    step (its walk.py:120-137, from its own verbs)."""
    nbr, w, _, _, ok = jax_sampling.get_full_neighbor(g, cur, ets, cap, -1,
                                                      offset=offset)
    prev_b = jnp.broadcast_to(prev[:, None], nbr.shape)
    is_prev = (nbr == prev_b) & (prev >= 0)[:, None]
    in_pn = jax_walk._is_neighbor(g, jnp.maximum(prev_b, 0), ets, nbr) & \
        (prev >= 0)[:, None]
    m = jnp.where(is_prev, 1.0 / p, jnp.where(in_pn, 1.0, 1.0 / q))
    m = jnp.where(prev[:, None] >= 0, m, 1.0)
    score = jnp.where(ok & (w > 0), jnp.log(jnp.maximum(w, 1e-30))
                      + jnp.log(m), -jnp.inf)
    return jnp.where(jnp.isfinite(score), score - jnp.log(-jnp.log(u)),
                     -jnp.inf)


def near_tie_rows(gj, paths, ets, p, q, cap, u_walk):
    """Rows of the reference's walks ``paths`` where a step's two best
    Gumbel keys lie within 4 ulps of each other."""
    near = np.zeros(paths.shape[0], bool)
    for s, keys in enumerate(u_walk):
        prev = paths[:, s - 1] if s else np.full_like(paths[:, 0], -1)
        scores = [np.asarray(_reference_keys(
            gj.tensors, jnp.asarray(paths[:, s]), jnp.asarray(prev),
            tuple(ets), p, q, cap, win * cap, jnp.asarray(u.numpy())))
            for win, u in enumerate(keys)]
        top = -np.sort(-np.concatenate(scores, axis=1), axis=1)[:, :2]
        with np.errstate(invalid="ignore"):
            gap = top[:, 0] - top[:, 1]
        near |= np.isfinite(top[:, 1]) & (
            gap <= 4 * np.spacing(np.abs(top[:, 0]).astype(np.float32)))
    return near


def assert_walks_equal(got, want, near):
    """Equal rows but for the near ties, which stay under 0.1%."""
    assert near.mean() < 1e-3, near.sum()
    np.testing.assert_array_equal(got[~near], want[~near])


# -------------------------------------------------------------- the walk --

def test_is_neighbor_bit_exact(pair):
    gj, gt = pair
    rng = np.random.default_rng(0)
    src = rng.integers(0, 400, (50, 9)).astype(np.int32)
    # half the candidates true neighbors, half random
    nbr = gt.tensors.adj_dst.numpy()[rng.integers(0, 8000, (50, 9))]
    cand = np.where(rng.random((50, 9)) < 0.5, nbr,
                    rng.integers(-1, 400, (50, 9))).astype(np.int32)
    for ets in ((0,), (2, 1)):
        want = jax.jit(lambda g, s, c: jax_walk._is_neighbor(g, s, ets, c))(
            gj.tensors, jnp.asarray(src), jnp.asarray(cand))
        got = walk._is_neighbor(gt.tensors, torch.from_numpy(src), ets,
                                torch.from_numpy(cand))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


@pytest.mark.parametrize("packs", ["sample", "alias"])
@pytest.mark.parametrize("ets", [(0,), (1, 2), [(0,), (1, 2), (2,), (0, 1)]],
                         ids=["one", "two", "per_step"])
def test_unbiased_walk_bit_exact(pair, packs, ets):
    gj, gt = pair
    tj, tt = gj.tensors, gt.tensors
    if packs == "alias":
        from tests.test_torch_verbs import bare
        tj, tt = bare(gj, gt)
    nodes = np.arange(-1, 120, dtype=np.int32)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda g, n: jax_walk.random_walk(g, key, n, ets, 4))(
        tj, jnp.asarray(nodes))
    got = walk.select_walk(tt, torch.from_numpy(nodes), ets, 4,
                           walk_uniforms(key, len(nodes), 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0] == -1).all() and (got[1:, -1] >= 0).float().mean() > 0.9


@pytest.mark.parametrize("cap,windows", [(64, 1), (4, 3)])
def test_exact_node2vec_walk_matches_but_for_near_ties(pair, cap, windows):
    gj, gt = pair
    nodes = np.arange(-1, 400, dtype=np.int32)
    key = jax.random.PRNGKey(5)
    p, q = 0.5, 2.0
    want = np.asarray(jax.jit(lambda g, n: jax_walk.random_walk(
        g, key, n, (0, 2), 2, p, q, bias_cap=cap, bias_windows=windows))(
            gj.tensors, jnp.asarray(nodes)))
    u = walk_uniforms(key, len(nodes), 2, p, q, cap=cap, windows=windows)
    got = walk.select_walk(gt.tensors, torch.from_numpy(nodes), (0, 2), 2,
                           u, p, q, bias_cap=cap).numpy()
    assert_walks_equal(got, want,
                       near_tie_rows(gj, want, (0, 2), p, q, cap, u))
    assert (got[1:, -1] >= 0).all()


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (3.0, 0.25)])
def test_rejection_node2vec_walk_bit_exact(pair, p, q):
    gj, gt = pair
    nodes = np.arange(-1, 200, dtype=np.int32)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda g, n: jax_walk.random_walk(
        g, key, n, (1,), 2, p, q, exact=False))(gj.tensors,
                                                jnp.asarray(nodes))
    got = walk.select_walk(gt.tensors, torch.from_numpy(nodes), (1,), 2,
                           walk_uniforms(key, len(nodes), 2, p, q,
                                         exact=False), p, q, exact=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_walk_follows_edges_and_pads_dead_ends(toy_pair):
    _, gt = toy_pair
    adj = {}
    src, dst = gt.tensors.adj_src.numpy(), gt.tensors.adj_dst.numpy()
    for a, b in zip(src, dst):
        adj.setdefault(a, set()).add(b)
    n107 = gt.local_id(107)
    nodes = torch.tensor([gt.local_id(e) for e in (100, 102, 104)] + [n107],
                         dtype=torch.int32)
    for p, q, exact in ((1.0, 1.0, True), (0.5, 2.0, True),
                        (0.5, 2.0, False)):
        paths = walk.random_walk(gt.tensors, nodes, (0, 1), 4, p, q,
                                 exact=exact,
                                 generator=torch.Generator().manual_seed(0))
        assert paths.shape == (4, 5)
        assert paths[3].tolist() == [n107, -1, -1, -1, -1]
        for row in paths[:3].numpy():
            for a, b in zip(row[:-1], row[1:]):
                assert b in adj[a] if b >= 0 else not adj.get(a)


@pytest.mark.parametrize("exact,tol", [(True, 0.015), (False, 0.05)])
def test_node2vec_step_distribution(toy_pair, exact, tol):
    # from 101 the walk goes to 100, then with prev 101: m(101) = 1/p
    # (return), m(103) = m(105) = 1/q (101 has no edge to them)
    _, gt = toy_pair
    p, q = 0.5, 2.0
    w = np.array([1.0 / p, 3.0 / q, 2.0 / q])
    starts = torch.full((20_000,), gt.local_id(101), dtype=torch.int32)
    paths = walk.random_walk(gt.tensors, starts, (0, 1), 2, p, q,
                             exact=exact,
                             generator=torch.Generator().manual_seed(4))
    ext = gt.ext_ids[paths[:, 2].numpy()]
    np.testing.assert_allclose([(ext == e).mean() for e in (101, 103, 105)],
                               w / w.sum(), atol=tol)


def test_check_bias_cap(pair):
    gj, gt = pair
    for ets, cap, windows in (((0,), 64, 1), ((0, 1, 2), 8, 1),
                              ((0, 1, 2), 8, 4)):
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            want = jax_walk.check_bias_cap(gj, ets, cap, windows)
            got = walk.check_bias_cap(gt, ets, cap, windows)
        assert got == want and isinstance(got[0], int)
        assert len(ws) == (2 if want[2] else 0)
    assert got[2] == 0 and walk.check_bias_cap(gt, (0, 1, 2), 8,
                                               warn=False)[2] > 0


@pytest.mark.parametrize("lw,rw", [(1, 1), (2, 3)])
def test_gen_pair_matches(lw, rw):
    paths = np.random.default_rng(lw).integers(-1, 50, (7, 6)).astype(
        np.int32)
    want = np.asarray(jax_walk.gen_pair(jnp.asarray(paths), lw, rw))
    got = walk.gen_pair(torch.from_numpy(paths), lw, rw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[1] == walk.pair_count(6, lw, rw)
    # the index tensors are built once per (L, lw, rw, device)
    assert walk._pair_index(6, lw, rw, torch.device("cpu")) is \
        walk._pair_index(6, lw, rw, torch.device("cpu"))


# ------------------------------------------------------------ the models --

MODELS = {
    "deepwalk": dict(walk_len=3, left_win=1, right_win=2, num_negs=3),
    "node2vec": dict(walk_len=3, num_negs=2, walk_p=0.5, walk_q=2.0,
                     bias_cap=16),
    "line1": dict(order=1, num_negs=4),
    "line2": dict(order=2, num_negs=4),
}
DIM = 8


def port_model(name, n_nodes, generator=None, **kw):
    cfg = dict(MODELS[name], **kw)
    if name.startswith("line"):
        return LINE(n_nodes, DIM, (0, 1), device="cpu", generator=generator,
                    **cfg)
    cls = Node2Vec if name == "node2vec" else DeepWalk
    return cls(n_nodes, DIM, (0, 1), device="cpu", generator=generator,
               **cfg)


@functools.lru_cache(maxsize=None)
def reference_model(name, n_nodes):
    """The flax model and its jitted ``value_and_grad`` step, compiled once
    for every test. The step returns, beside the outputs, the keys the
    model hands ``walk.random_walk`` (or ``sampling.sample_neighbor``)
    and ``sampling.sample_node``, and the reference's walks: each is
    wrapped to record them while the step is traced."""
    if name.startswith("line"):
        mj = jax_walk_models.LINE(n_nodes=n_nodes, dim=DIM, edge_types=(0, 1),
                                  **MODELS[name])
    else:
        cls = jax_walk_models.Node2Vec if name == "node2vec" else \
            jax_walk_models.DeepWalk
        mj = cls(n_nodes=n_nodes, dim=DIM, edge_types=(0, 1), **MODELS[name])
    rec = {}
    wrapped = [(jax_walk, "random_walk"), (jax_sampling, "sample_neighbor"),
               (jax_sampling, "sample_node")]

    def recording(name, fn):
        def call(g, key, *a, **kw):
            out = fn(g, key, *a, **kw)
            rec[name] = (key, out)
            return out
        return call

    def loss_fn(p, g, roots, key):
        rec.clear()
        real = [getattr(mod, n) for mod, n in wrapped]
        for mod, n in wrapped:
            setattr(mod, n, recording(n, getattr(mod, n)))
        try:
            out = mj.apply(p, g, roots, rngs={"sample": key})
        finally:
            for (mod, n), fn in zip(wrapped, real):
                setattr(mod, n, fn)
        first = "random_walk" if "random_walk" in rec else "sample_neighbor"
        return out["loss"], (out, rec[first][0], rec["sample_node"][0],
                             rec[first][1])

    return mj, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def run_both(name, gj, gt, roots, seed=0):
    """(reference outputs, its gradients in the port's names, the port's
    model, its outputs, the walks' near-tie rows) from one flax tree and
    one key."""
    n = gt.meta.n_nodes
    mj, step = reference_model(name, n)
    shapes = jax.eval_shape(mj.init, {"params": jax.random.PRNGKey(0),
                                      "sample": jax.random.PRNGKey(1)},
                            gj.tensors, jnp.asarray(roots))
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(lambda s: (rng.standard_normal(s.shape)
                                        * s.shape[-1] ** -0.5).astype(
                                            s.dtype), shapes)
    mt = load_flax_params(port_model(name, n),
                          jax.tree.map(np.asarray, variables))
    (_, (out, k_first, k_neg, first)), grads = step(
        variables, gj.tensors, jnp.asarray(roots), jax.random.PRNGKey(9))
    B = len(roots)
    r = torch.from_numpy(roots)
    near = np.zeros(B, bool)
    if name.startswith("line"):
        got = mt(gt.tensors, r, uniforms=[
            uniforms(k_first, (B, 1)), uniforms(k_neg, (B * mt.num_negs,))])
    else:
        cfg = dict(p=mt.walk_p, q=mt.walk_q, cap=mt.bias_cap)
        u_walk = walk_uniforms(k_first, B, mt.walk_len, **cfg)
        paths = mt.walk(gt.tensors, r, u_walk).numpy()
        want_paths = np.asarray(first)
        if name == "node2vec":
            near = near_tie_rows(gj, want_paths, (0, 1), mt.walk_p,
                                 mt.walk_q, mt.bias_cap, u_walk)
        assert_walks_equal(paths, want_paths, near)
        M = B * walk.pair_count(mt.walk_len + 1, mt.left_win, mt.right_win)
        u_neg = uniforms(k_neg, (M * mt.num_negs,))
        # the skip-gram head on the reference's own walks
        got = mt.score(gt.tensors, r, torch.from_numpy(want_paths.copy()),
                       u_neg)
        if not near.any():
            full = mt(gt.tensors, r, uniforms=[u_walk, u_neg])
            assert torch.equal(full["loss"], got["loss"])
    flat = {f"{k}.weight": np.asarray(v["embedding"])
            for k, v in grads["params"].items()}
    return out, flat, mt, got


@pytest.mark.parametrize("name", list(MODELS))
def test_model_loss_and_gradients_match(pair, name):
    gj, gt = pair
    roots = np.arange(-1, 47, dtype=np.int32)
    want, g_want, mt, got = run_both(name, gj, gt, roots)
    for k in ("embedding", "logits", "neg_logits", "pos_mask"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k,
                                   **GRAD_TOL)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               **LOSS_TOL)
    got["loss"].backward()
    names = sorted(n for n, _ in mt.named_parameters())
    assert names == sorted(g_want) and len(names) == (
        1 if name == "line1" else 2)
    for n, p in mt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_want[n], err_msg=n,
                                   **GRAD_TOL)
        assert np.abs(g_want[n]).max() > 0, n
    assert got["pos_mask"].mean() > 0.5


@pytest.mark.parametrize("name", list(MODELS))
def test_model_trains_evaluates_and_infers(toy_pair, name):
    _, gt = toy_pair
    n = gt.meta.n_nodes
    model = port_model(name, n, generator=torch.Generator().manual_seed(0))
    est = NodeEstimator(model, gt, RunConfig(
        batch_size=4, total_steps=30, learning_rate=0.05, log_steps=0,
        metric="mrr", optimizer="adam"), device="cpu")
    ids = np.arange(n)
    before = est.evaluate(ids)
    res = est.train()
    after = est.evaluate(ids)
    assert np.isfinite(res["loss"]) and after["loss"] < before["loss"]
    assert 0 < after["mrr"] <= 1
    emb = est.infer(ids)
    assert emb.shape == (n, DIM) and np.isfinite(emb).all()
    np.testing.assert_array_equal(emb, model.target_emb.weight.detach()
                                  .numpy()[ids])


def test_evaluate_is_the_reference_metric(toy_pair):
    # as the reference's estimator: the pooled positives' logits against
    # their negatives', cut to the number of ids
    _, gt = toy_pair
    model = port_model("deepwalk", gt.meta.n_nodes,
                       generator=torch.Generator().manual_seed(1))
    est = NodeEstimator(model, gt, RunConfig(batch_size=3, metric="mrr"),
                        device="cpu")
    seen = []
    forward = model.forward
    model.forward = lambda *a, **kw: seen.append(forward(*a, **kw)) or \
        seen[-1]
    ids = np.arange(gt.meta.n_nodes)
    res = est.evaluate(ids)
    pos = np.concatenate([o["logits"].numpy() for o in seen])[:len(ids)]
    neg = np.concatenate([o["neg_logits"].numpy() for o in seen])[:len(ids)]
    np.testing.assert_allclose(res["mrr"], float(jax_metrics.mrr(
        jnp.asarray(pos), jnp.asarray(neg))), rtol=1e-6)


def test_sharded_tables_split_over_the_mesh():
    """``shard_embeddings=True`` (which raised before the mesh path):
    the tables are ``ShardedEmbedding``s, one block a shard once laid out
    over the mesh (the mesh's steps: tests/test_torch_sharded_models.py);
    LINE of order 1 has the one table."""
    for cls, kw, names in ((DeepWalk, {}, {"target_emb", "context_emb"}),
                           (LINE, {"order": 1}, {"target_emb"})):
        m = cls(10, 4, (0,), shard_embeddings=True, device="cpu", **kw)
        specs = train.init_sharded_params(
            m, types.SimpleNamespace(graph=2, graph_index=1), seed=1)
        assert {k for k, v in specs.items() if v == "graph"} == {
            f"{n}.embedding" for n in names}
        assert all(getattr(m, n).embedding.shape == (6, 4) for n in names)
    with pytest.raises(ValueError, match="order"):
        LINE(10, 4, (0,), order=3, device="cpu")