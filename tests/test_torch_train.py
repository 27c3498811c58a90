"""The sampled GraphSAGE training step of the PyTorch port against
euler_tpu, in f32 on the CPU.

- Root draw (``sample_node``, both ``node_type`` branches), the alias
  select and the reservoir redraw (``refresh_fan_rows`` with
  ``over_rows``): the uniforms the reference derives from its key are
  handed to the port's deterministic selects, which must return the same
  ids bit for bit. Draws from a torch.Generator are tested by their
  distribution.
- ``SuperviseModel`` loss and gradients against ``jax.value_and_grad``
  with the flax parameters loaded into the port: loss within rtol = atol
  = 1e-5, gradients within 1e-4 (different summation order of the CPU
  matmuls).
- The optimizers fed the same (JAX) gradients against optax.
- Five whole training steps (sampling, forward, backward, Adam) against
  the reference: loss within 1e-4; parameters within 1e-4 wherever every
  step's gradient exceeds 1e-6 on both sides. Adam moves each element by
  about lr whatever the gradient's size, so an element whose tiny
  gradient has a different sign on the two sides differs by 2e-3 after
  one step without any fault.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.ops import alias as jax_alias
from euler_tpu.ops import sampling as jax_sampling
from euler_tpu.utils import metrics as jax_metrics
from euler_tpu_torch import bench
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import NodeEstimator, RunConfig, get_optimizer
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.graph.meta import GraphMeta
from euler_tpu_torch.graph.store import Graph
from euler_tpu_torch.models import (GNNNet, ShallowEncoder, SuperviseModel,
                                    load_flax_params)
from euler_tpu_torch.ops import alias, sampling
from euler_tpu_torch.ops.alias import FAN_ALIAS_OFF, FAN_D, FAN_KEPT_OFF
from euler_tpu_torch.utils import metrics
from tests.test_torch_graph import random_pair
from tests.test_torch_models import (FANOUTS, RecordingFlow, _jax_model,
                                     _port_model, hop_uniforms)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def u(key, shape):
    return np.array(jax.random.uniform(key, shape))


def t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------ root draw --

def test_node_alias_tables_match(toy_dir, toy_graph):
    gt = load_graph(toy_dir, device="cpu")
    nj, nt = toy_graph.tensors.node_alias, gt.tensors.node_alias
    for name in ("ids", "type_ptr", "prob", "alias", "w_sum"):
        np.testing.assert_array_equal(getattr(nt, name).numpy(),
                                      np.asarray(getattr(nj, name)),
                                      err_msg=name)
    moved = gt.tensors.to("meta").node_alias
    assert all(getattr(moved, f).device.type == "meta"
               for f in ("ids", "type_ptr", "prob", "alias", "w_sum"))


@pytest.mark.parametrize("node_type", [-1, 0, 1, "user"])
def test_sample_node_bit_exact(toy_dir, toy_graph, node_type):
    gt = load_graph(toy_dir, device="cpu")
    key = jax.random.PRNGKey(17)
    count = 4096
    want = jax_sampling.sample_node(toy_graph.tensors, key, count, node_type)
    if node_type == -1:
        kt, kd = jax.random.split(key)
        u_type = u(kt, (count,))
    else:
        kd, u_type = key, np.zeros(count, np.float32)
    k1, k2 = jax.random.split(kd)
    got = sampling.select_nodes(gt.tensors, node_type, t(u_type),
                                t(u(k1, (count,))), t(u(k2, (count,))))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_node_bit_exact_on_a_random_graph():
    gj, gt = random_pair(3000, 5, seed=2)
    key = jax.random.PRNGKey(5)
    want = jax_sampling.sample_node(gj.tensors, key, 2048, -1)
    kt, kd = jax.random.split(key)
    k1, k2 = jax.random.split(kd)
    got = sampling.select_nodes(gt.tensors, -1, t(u(kt, (2048,))),
                                t(u(k1, (2048,))), t(u(k2, (2048,))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cdf_trap(T=4, seed=0):
    """Per-type weight sums w (f32 [T]) whose running sums differ in one
    entry k < T-1 between torch.cumsum and a left-to-right sum (equal
    totals), and a u_type whose r = u_type * total is the smaller of the
    two: a root draw there picks type k on one side and k+1 on the
    other."""
    rng = np.random.default_rng(seed)
    while True:
        w = (rng.random(T) * 1e6).astype(np.float32)
        left = np.cumsum(w, dtype=np.float32)
        other = torch.cumsum(torch.from_numpy(w), 0).numpy()
        diff = np.nonzero(left != other)[0]
        if left[-1] != other[-1] or not len(diff):
            continue
        k = int(diff[0])
        r = min(left[k], other[k])
        u = np.float32(r / left[-1])
        for _ in range(8):          # step u until u * total rounds to r
            got = u * left[-1]
            if got == r:
                return w, u, k
            u = np.nextafter(u, np.float32(2 if got < r else -1),
                             dtype=np.float32)


def test_root_draw_cdf_adds_left_to_right():
    # a root draw over 4 node types (one node each, with the weight sums
    # of _cdf_trap): the port picks the node the reference's
    # jnp.cumsum(w_sum) picks, where torch.cumsum would pick another
    w, u, k = _cdf_trap()
    T = len(w)
    meta = GraphMeta(n_nodes=T, n_edges=1,
                     node_types=tuple(f"t{i}" for i in range(T)),
                     edge_types=("e",), node_features=(), edge_features=())
    arrays = dict(ext_ids=np.arange(T, dtype=np.int64),
                  node_local=np.arange(T, dtype=np.int32),
                  node_type=np.arange(T, dtype=np.int32), node_w=w,
                  src=np.zeros(1, np.int32), dst=np.ones(1, np.int32),
                  etype=np.zeros(1, np.int32), ew=np.ones(1, np.float32),
                  eid=np.zeros(1, np.int32))
    g = Graph(meta, arrays, packs=(), device="cpu").tensors
    np.testing.assert_array_equal(g.node_alias.w_sum.numpy(), w)
    cdf = jnp.cumsum(jnp.asarray(w))
    want = int(jnp.minimum(jnp.searchsorted(cdf, u * cdf[-1], side="right"),
                           T - 1))
    torch_cdf = torch.cumsum(torch.from_numpy(w), 0)
    wrong = int(torch.searchsorted(torch_cdf, t(np.float32(u)) * torch_cdf[-1],
                                   right=True))
    assert {want, wrong} == {k, k + 1}
    half = t(np.full(1, 0.5, np.float32))
    got = sampling.select_nodes(g, -1, t(np.full(1, u, np.float32)), half,
                                half)
    assert int(got[0]) == want != wrong


def test_alias_select_matches_alias_draw_with_empty_segments():
    # the last segment is empty: the reference reads prob[n], one past the
    # end, which XLA clamps; the port clamps every index and gives -1
    rng = np.random.default_rng(0)
    prob = rng.random(10).astype(np.float32)
    al = rng.integers(0, 3, 10).astype(np.int32)
    for seed, (lo, size) in enumerate([(0, 3), (3, 7), (10, 0), (4, 0),
                                       (9, 1)]):
        key = jax.random.PRNGKey(seed)
        want = jax_alias.alias_draw(key, jnp.asarray(prob), jnp.asarray(al),
                                    lo, size, (500,))
        k1, k2 = jax.random.split(key)
        got = alias.alias_select(t(prob), t(al), lo, size,
                                 t(u(k1, (500,))), t(u(k2, (500,))))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if size == 0:
            assert (got == -1).all()


def test_sample_node_distribution(toy_dir):
    # toy node weights are 1..8 (ext 100..107): P(node) = w / 36 over all
    # types, and w / 20 within type "user" (the odd ext ids)
    g = load_graph(toy_dir, device="cpu")
    gen = torch.Generator().manual_seed(0)
    n = 60_000
    w = np.arange(1, 9, dtype=np.float64)
    ids = sampling.sample_node(g.tensors, n, -1, gen).numpy()
    freq = np.bincount(ids, minlength=8) / n
    exts = g.ext_ids
    np.testing.assert_allclose(freq, w[exts - 100] / 36.0, atol=0.01)
    users = sampling.sample_node(g.tensors, n, "user", gen).numpy()
    assert set(g.ext_ids[users] % 2) == {1}
    f_user = np.bincount(g.ext_ids[users] - 100, minlength=8) / n
    np.testing.assert_allclose(f_user[1::2], w[1::2] / 20.0, atol=0.01)


# ---------------------------------------------------- reservoir redraw --

@pytest.fixture(scope="module")
def dense_pair():
    # average degree 50 > FAN_D: most groups are reservoir rows
    return random_pair(300, 50, seed=1)


def test_refresh_fan_rows_bit_exact(dense_pair):
    gj, gt = dense_pair
    tj, tt = gj.tensors, gt.tensors
    K = int(tt.fan_over_rows.shape[0])
    assert K > 100
    key = jax.random.PRNGKey(9)
    want = jax_sampling.refresh_fan_rows(
        tj.group_ptr, tj.adj_dst, tj.adj_prob, tj.adj_alias, tj.fan_pack,
        key, tj.fan_over_rows)
    k1, k2 = jax.random.split(key)
    pack = tt.fan_pack.clone()
    got = sampling.refresh_fan_rows(
        tt.group_ptr, tt.adj_dst, tt.adj_prob, tt.adj_alias, pack,
        tt.fan_over_rows, t(u(k1, (K, FAN_D))), t(u(k2, (K, FAN_D))))
    assert got is pack
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not torch.equal(got, tt.fan_pack)


def test_refresh_fan_pack_rewrites_only_reservoir_lanes(dense_pair):
    _, gt = dense_pair
    # a copy of the pack: the redraw is in place
    g = dataclasses.replace(gt.tensors, fan_pack=gt.tensors.fan_pack.clone())
    before = g.fan_pack.clone()
    sampling.refresh_fan_pack(g, torch.Generator().manual_seed(3))
    after = g.fan_pack
    over = g.fan_over_rows.long()
    keep = torch.ones(before.shape[0], dtype=torch.bool)
    keep[over] = False
    assert torch.equal(after[keep], before[keep])
    assert torch.equal(after[over, :FAN_KEPT_OFF], before[over, :FAN_KEPT_OFF])
    kept = after[over, FAN_KEPT_OFF:FAN_KEPT_OFF + FAN_D]
    assert torch.equal(kept, after[over, FAN_ALIAS_OFF:FAN_ALIAS_OFF + FAN_D])
    assert not torch.equal(kept, before[over, FAN_KEPT_OFF:
                                        FAN_KEPT_OFF + FAN_D])
    gp, dst = g.group_ptr.numpy(), g.adj_dst.numpy()
    for i, r in enumerate(over.numpy()):
        assert set(kept[i].numpy()) <= set(dst[gp[r]:gp[r + 1]])


# ------------------------------------------------- loss and gradients --

@pytest.fixture(scope="module")
def graphs():
    return random_pair(2000, 25, feat_dim=16, n_classes=4, seed=0)


@pytest.fixture(scope="module")
def roots():
    r = np.arange(5, 5 + B, dtype=np.int32)
    r[-2:] = -1
    return r


def _init(graphs, roots, seed=0):
    """(flow, jax model, variables, port model with the same weights)."""
    gj, _ = graphs
    flow = RecordingFlow(jax_flows.SageDataFlow(FANOUTS, [(0,), (0,)]))
    model = _jax_model(flow)
    variables = model.init({"params": jax.random.PRNGKey(seed),
                            "sample": jax.random.PRNGKey(1)}, gj.tensors,
                           jnp.asarray(roots))
    port = load_flax_params(_port_model(), jax.tree.map(np.asarray,
                                                        variables))
    return flow, model, variables, port


def _jax_loss_and_grads(model, gj, variables, roots, key):
    def loss_fn(p):
        return model.apply(p, gj.tensors, jnp.asarray(roots),
                           rngs={"sample": key})["loss"]
    return jax.value_and_grad(loss_fn)(variables)


def _as_port(port, tree):
    """A flax-layout tree (params or grads) in the port's layout: a dict
    of numpy arrays keyed by the port's parameter names."""
    holder = load_flax_params(copy.deepcopy(port),
                              jax.tree.map(np.asarray, tree))
    return {k: v.detach().numpy().copy()
            for k, v in holder.named_parameters()}


def test_loss_and_gradients_match_value_and_grad(graphs, roots):
    gj, gt = graphs
    flow, model, variables, port = _init(graphs, roots)
    key = jax.random.PRNGKey(7)
    loss_j, grads_j = _jax_loss_and_grads(model, gj, variables, roots, key)
    uniforms = hop_uniforms(flow.keys[-1], B, FANOUTS)
    out = port(gt.tensors, torch.from_numpy(roots), uniforms=uniforms)
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(loss_j), **LOSS_TOL)
    want = _as_port(port, grads_j)
    names = [n for n, _ in port.named_parameters()]
    assert sorted(want) == sorted(names) and len(names) == 7
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)
        assert np.abs(want[name]).max() > 0, name


def test_bf16_activations_train_close_to_f32(graphs, roots):
    # the dtype=bfloat16 activation path of the bench: parameters and
    # gradients stay f32 and near the f32 run's
    _, gt = graphs
    port = _port_model()
    gen = torch.Generator().manual_seed(0)
    uniforms, n = [], B
    for c in FANOUTS:
        uniforms.append(sampling.draw_fan_uniforms(gen, n, c, "cpu"))
        n *= 1 + c
    grads = []
    for dtype in (None, torch.bfloat16):
        port.zero_grad()
        port.embedder.dtype = dtype
        loss = port(gt.tensors, torch.from_numpy(roots),
                    uniforms=uniforms)["loss"]
        loss.backward()
        assert loss.dtype == torch.float32 and torch.isfinite(loss)
        grads.append([p.grad.clone() for p in port.parameters()])
    for a, b in zip(*grads):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0.05,
                                   atol=0.02)


# ---------------------------------------------------------- optimizers --

OPTAX = {"sgd": lambda lr: optax.sgd(lr),
         "momentum": lambda lr: optax.sgd(lr, momentum=0.9),
         "adagrad": lambda lr: optax.adagrad(lr),
         "adam": lambda lr: optax.adam(lr)}


@pytest.mark.parametrize("name,steps,lr,tol", [("adam", 5, 1e-3, 1e-6),
                                               ("adagrad", 1, 0.01, 1e-6),
                                               ("momentum", 1, 0.01, 1e-6),
                                               ("momentum", 3, 0.01, 1e-6),
                                               ("sgd", 2, 0.01, 1e-6)])
def test_optimizer_matches_optax(graphs, roots, name, steps, lr, tol):
    gj, _ = graphs
    _, model, variables, port = _init(graphs, roots)
    _, grads_j = _jax_loss_and_grads(model, gj, variables, roots,
                                     jax.random.PRNGKey(7))
    tx = OPTAX[name](lr)
    params, state = variables, tx.init(variables)
    opt = get_optimizer(name, lr, port.parameters())
    g_port = _as_port(port, grads_j)
    for k in range(steps):
        # the same gradients on both sides, scaled per step
        scale = 1.0 + 0.5 * k
        gk = jax.tree.map(lambda x: x * scale, grads_j)
        upd, state = tx.update(gk, state, params)
        params = optax.apply_updates(params, upd)
        for n, p in port.named_parameters():
            p.grad = torch.from_numpy(g_port[n] * np.float32(scale))
        opt.step()
        want = _as_port(port, params)
        for n, p in port.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                       atol=tol, err_msg=f"{n} step {k}")


def test_get_optimizer_rejects_unknown_names():
    with pytest.raises(KeyError):
        get_optimizer("lamb", 0.1, [torch.zeros(1, requires_grad=True)])


# ---------------------------------------------- whole training steps --

def test_five_training_steps_match_reference(graphs, roots):
    gj, gt = graphs
    flow, model, variables, port = _init(graphs, roots, seed=3)
    tx = optax.adam(1e-3)
    params, state = variables, tx.init(variables)
    est = NodeEstimator(port, gt, RunConfig(batch_size=B), device="cpu")
    opt = get_optimizer("adam", 1e-3, port.parameters())
    r = torch.from_numpy(roots)
    big = None                      # elements whose gradients are not tiny
    for k in range(5):
        key = jax.random.PRNGKey(100 + k)
        loss_j, grads_j = _jax_loss_and_grads(model, gj, params, roots, key)
        upd, state = tx.update(grads_j, state, params)
        params = optax.apply_updates(params, upd)
        loss_t = est.step(opt, r, uniforms=hop_uniforms(flow.keys[-1], B,
                                                        FANOUTS))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4,
                                   atol=1e-4, err_msg=f"loss step {k}")
        g_want = _as_port(port, grads_j)
        now = {n: (np.abs(g_want[n]) > 1e-6)
               & (np.abs(p.grad.numpy()) > 1e-6)
               for n, p in port.named_parameters()}
        big = now if big is None else {n: big[n] & now[n] for n in now}
        want = _as_port(port, params)
        for n, p in port.named_parameters():
            m = big[n]
            assert m.mean() > 0.5, n
            np.testing.assert_allclose(p.detach().numpy()[m], want[n][m],
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{n} step {k}")


# ------------------------------------------------------------- metrics --

@pytest.mark.parametrize("masked", [False, True])
def test_metrics_match_reference(masked):
    rng = np.random.default_rng(4)
    labels = (rng.random((64, 6)) < 0.3).astype(np.float32)
    preds = rng.random((64, 6)).astype(np.float32)
    mask = (rng.random(64) < 0.8).astype(np.float32) if masked else None
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else t(mask)
    for name in ("f1_score", "accuracy"):
        want = getattr(jax_metrics, name)(jnp.asarray(labels),
                                          jnp.asarray(preds), mask=mj)
        got = getattr(metrics, name)(t(labels), t(preds), mask=mt)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=name)
    assert metrics.get("acc") is metrics.accuracy
    with pytest.raises(NotImplementedError):
        metrics.get("ndcg")


# ------------------------------------------------------------ estimator --

def _small_setup(refresh):
    # under 32,768 edges the native CSR build is single-threaded, so two
    # builds give the same tables (ROADMAP Queue C, native CSR tie order)
    graph = random_graph(600, 50, feat_dim=16, n_classes=4, seed=4,
                         device="cpu")
    gen = torch.Generator().manual_seed(0)
    net = GNNNet("sage", SageDataFlow([5, 3], [(0,), (0,)]), (16, 16),
                 ShallowEncoder(("feature",)), in_dim=16, device="cpu",
                 generator=gen)
    model = SuperviseModel(net, "label", 4, device="cpu", generator=gen)
    cfg = RunConfig(batch_size=64, total_steps=30, learning_rate=0.01,
                    log_steps=10, reservoir_refresh=refresh, metric="f1")
    return NodeEstimator(model, graph, cfg, device="cpu")


def test_node_estimator_trains_evaluates_and_refreshes(monkeypatch):
    est = _small_setup(refresh=10)
    pack0 = est.graph.tensors.fan_pack.clone()
    calls = []
    real = sampling.refresh_fan_pack
    monkeypatch.setattr(sampling, "refresh_fan_pack",
                        lambda g, gen: calls.append(1) or real(g, gen))
    eval_ids = np.arange(600)
    before = est.evaluate(eval_ids)
    logs = []
    res = est.train(log_fn=logs.append)
    after = est.evaluate(eval_ids)
    assert res["steps"] == 30 and np.isfinite(res["loss"])
    assert len(logs) == 3 and "step 30/30" in logs[-1]
    assert len(calls) == 2                    # before steps 11 and 21
    assert not torch.equal(est.graph.tensors.fan_pack, pack0)
    assert after["loss"] < before["loss"] - 0.05, (before, after)
    assert 0.0 <= after["f1"] <= 1.0
    est.config.metric = "acc"
    assert 0.0 <= est.evaluate(eval_ids)["acc"] <= 1.0


def test_training_is_reproducible_from_the_seed():
    a, b = _small_setup(refresh=5), _small_setup(refresh=5)
    la = a.train(total_steps=12, log_fn=lambda s: None)["loss"]
    lb = b.train(total_steps=12, log_fn=lambda s: None)["loss"]
    assert la == lb
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)


def test_train_roots_come_from_sample_node():
    est = _small_setup(refresh=0)
    gen = torch.Generator().manual_seed(1)
    r = est.train_batch(est.graph.tensors, gen)
    assert r.shape == (64,) and r.dtype == torch.int32
    assert int(r.min()) >= 0 and int(r.max()) < 600


# ---------------------------------------------------------------- bench --

def test_bench_prints_bench_py_lines_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "euler_tpu_torch.bench",
                          "--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(s) for s in out.stdout.splitlines()
             if s.startswith("{")]
    assert [r["phase"] for r in lines] == ["warmup", "single_loop",
                                           "pipelined"]
    for r in lines:
        assert set(r) == {"metric", "model", "value", "unit", "vs_baseline",
                          "platform", "phase", "config"}
        assert r["metric"] == "sampled_aggregate_edges_per_sec_per_chip"
        assert r["model"] == "sage" and r["unit"] == "edges/s"
        assert r["vs_baseline"] is None and r["platform"] == "cpu"
        assert r["config"] == "b256_f25x10_n5000" and r["value"] > 0
    assert sum(s.startswith("ms_per_step") for s in
               out.stdout.splitlines()) == 3
    assert bench.edges_per_step(1024) == 308_224


def test_bench_needs_cuda_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run()
