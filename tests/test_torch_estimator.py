"""The port's estimator loop, checkpoints, run hooks and utils against
euler_tpu, on the CPU.

``steps_per_loop`` on the CPU runs its steps eagerly (the card replays a
captured step, tests/test_torch_cuda.py), so a run with loops of k steps
must equal one of single steps from the same seed where the reservoir
redraws fall on the same steps. The steps that log and save under loops
must be those that euler_tpu's loop picks on the same configuration.
``Embed``'s ``index_add_`` backward must give flax's gradient (within
1e-6: repeated ids are summed in another order). The utils must give
euler_tpu's results on the same inputs.
"""
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.estimator import estimator as jax_est
from euler_tpu.models import gnn as jax_gnn
from euler_tpu.utils import config as jax_config
from euler_tpu.utils import dense as jax_dense
from euler_tpu.utils import io as jax_io
from euler_tpu_torch.dataflow import SageDataFlow, WholeDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import (NodeEstimator, RunConfig, TrainLoop,
                                       get_optimizer)
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import (EmbedOnly, GNNNet, ShallowEncoder,
                                    SuperviseModel, UnsuperviseModel)
from euler_tpu_torch.models.encoders import Embed
from euler_tpu_torch.ops.alias import alias_select
from euler_tpu_torch.utils import config, dense, hooks
from euler_tpu_torch.utils import io as port_io

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dense_graph():
    """Degree 50 > FAN_D: the graph has reservoir rows to redraw."""
    return random_graph(300, 50, feat_dim=8, n_classes=4, seed=0,
                        device="cpu")


def sage_estimator(graph, seed=0, dims=(8, 8), **cfg):
    net = GNNNet("sage", SageDataFlow([3, 2], [(0,), (0,)]), dims,
                 ShallowEncoder(("feature",)), in_dim=8, device="cpu",
                 generator=torch.Generator().manual_seed(seed))
    model = SuperviseModel(net, "label", 4, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    return NodeEstimator(model, graph, RunConfig(**cfg), device="cpu")


@pytest.mark.parametrize("spl", [3, 5])
def test_steps_per_loop_equals_single_steps(dense_graph, spl):
    g = dense_graph.tensors
    pack = g.fan_pack.clone()
    kw = dict(batch_size=16, total_steps=11, log_steps=1,
              reservoir_refresh=spl, learning_rate=0.01)
    runs = []
    for steps_per_loop in (spl, 1):
        g.fan_pack.copy_(pack)
        est = sage_estimator(dense_graph, steps_per_loop=steps_per_loop,
                             **kw)
        logged = []
        res = est.train(log_fn=logged.append)
        runs.append((res, logged, est.model.state_dict(),
                     g.fan_pack.clone()))
    (res_k, log_k, p_k, pack_k), (res_1, log_1, p_1, pack_1) = runs
    assert not torch.equal(pack_k, pack)             # the reservoir redrew
    assert torch.equal(pack_k, pack_1)
    assert res_k == res_1
    assert all(torch.equal(p_k[k], p_1[k]) for k in p_1)

    def losses(lines):
        return {int(re.search(r"step (\d+)/", s).group(1)):
                re.search(r"loss=(\S+)", s).group(1) for s in lines}
    at_k = losses(log_k)
    assert at_k and all(losses(log_1)[i] == v for i, v in at_k.items())


def record_loop(est):
    """(steps logged, steps saved) of ``est.train``."""
    saved = []
    est._save = saved.append
    logged = []
    est.train(log_fn=logged.append)
    return ([int(re.search(r"step (\d+)/", s).group(1)) for s in logged],
            saved)


def test_log_and_save_steps_follow_the_reference(toy_dir, toy_graph,
                                                 tmp_path):
    cfg = dict(batch_size=4, total_steps=11, log_steps=4, save_steps=5,
               steps_per_loop=3, reservoir_refresh=0)
    max_id = toy_graph.meta.n_nodes - 1
    ref_model = jax_gnn.UnsuperviseModel(
        embedder=jax_gnn.EmbedOnly(max_id=max_id, dim=4),
        context_embedder=jax_gnn.EmbedOnly(max_id=max_id, dim=4),
        edge_types=(0,), num_negs=2)
    ref = jax_est.NodeEstimator(
        ref_model, toy_graph,
        jax_est.RunConfig(model_dir=str(tmp_path / "ref"), **cfg))
    port_graph = load_graph(toy_dir, device="cpu")
    model = UnsuperviseModel(EmbedOnly(max_id, 4, device="cpu"),
                             EmbedOnly(max_id, 4, device="cpu"), (0,),
                             num_negs=2, device="cpu")
    port = NodeEstimator(model, port_graph, RunConfig(**cfg), device="cpu")
    want = record_loop(ref)
    assert want == ([6, 9, 10], [6, 10, 11, 11])
    assert record_loop(port) == want


def sup_gcn_estimator(graph, model_dir, seed=0, hidden=32, **cfg):
    net = GNNNet("gcn", WholeDataFlow(1, [(0,)]), (hidden, hidden),
                 ShallowEncoder(("feature",)), in_dim=8, device="cpu",
                 generator=torch.Generator().manual_seed(seed))
    model = SuperviseModel(net, "label", 4, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    cfg = dict(dict(batch_size=32, total_steps=5, log_steps=0), **cfg)
    return NodeEstimator(model, graph, RunConfig(model_dir=model_dir, **cfg),
                         device="cpu")


@pytest.fixture(scope="module")
def ell_graph():
    return random_graph(200, 5, feat_dim=8, n_classes=4, seed=1,
                        packs=("ell",), device="cpu")


def test_checkpoint_roundtrip(ell_graph, tmp_path):
    d = str(tmp_path / "ck")
    est = sup_gcn_estimator(ell_graph, d)
    est.train()
    est2 = sup_gcn_estimator(ell_graph, d, seed=1)
    p2 = [p.clone() for p in est2.model.parameters()]
    ids = np.arange(40)
    emb = est2.infer(ids)                        # restores first
    assert not all(torch.equal(a, b) for a, b in zip(
        p2, est2.model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(est.model.parameters(),
                                                 est2.model.parameters()))
    np.testing.assert_array_equal(emb, est.infer(ids))


def test_checkpoint_retention(ell_graph, tmp_path):
    d = tmp_path / "keep"
    sup_gcn_estimator(ell_graph, str(d), save_steps=1, keep_checkpoints=2,
                      total_steps=4).train()
    assert sorted(os.listdir(d / "ckpt")) == ["3", "4", "latest"]
    assert (d / "ckpt" / "latest").read_text() == "4"


def test_a_checkpoint_that_does_not_fit_raises(ell_graph, tmp_path):
    d = str(tmp_path / "mis")
    sup_gcn_estimator(ell_graph, d).train()
    other = sup_gcn_estimator(ell_graph, d, hidden=16)
    with pytest.raises(RuntimeError, match="size mismatch"):
        other.evaluate(np.arange(8))


def test_no_model_dir_writes_nothing(ell_graph, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    est = sup_gcn_estimator(ell_graph, None, save_steps=1)
    est.train()
    est.evaluate(np.arange(8))
    assert os.listdir(tmp_path) == []


def test_an_optimizer_that_cannot_be_captured_raises_on_the_card():
    w = torch.nn.Parameter(torch.zeros(3))
    card = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="Adagrad"):
        TrainLoop(card, get_optimizer("adagrad", 0.1, [w]), None, 2, None)
    for name in ("sgd", "momentum"):
        TrainLoop(card, get_optimizer(name, 0.1, [w]), None, 2, None)
    adam = torch.optim.Adam([w], 0.1, capturable=True)
    TrainLoop(card, adam, None, 2, None)
    with pytest.raises(ValueError, match="Adam"):       # capturable=False
        TrainLoop(card, get_optimizer("adam", 0.1, [w]), None, 2, None)
    # one step a loop, or the CPU: eager, whatever the optimizer
    TrainLoop(card, get_optimizer("adagrad", 0.1, [w]), None, 1, None)
    TrainLoop(types.SimpleNamespace(device=CPU),
              get_optimizer("adagrad", 0.1, [w]), None, 4, None)


def test_embed_gradient_matches_flax():
    import flax.linen as nn
    rng = np.random.default_rng(0)
    num, feat = 7, 5
    table = rng.standard_normal((num, feat)).astype(np.float32)
    ids = np.array([[0, 3, 3, 6], [7, 3, 9, 0], [6, 6, 6, 2]], np.int32)
    cot = rng.standard_normal(ids.shape + (feat,)).astype(np.float32)
    ref = nn.Embed(num, feat)

    def loss(t):
        out = ref.apply({"params": {"embedding": t}}, jnp.asarray(ids))
        return (out * cot).sum(), out
    (_, out_j), grad_j = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(table))
    emb = Embed(num, feat)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(table))
    out_t = emb(torch.from_numpy(ids))
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    assert np.isnan(np.asarray(out_j)[1, [0, 2]]).all()   # ids past the table
    np.testing.assert_allclose(emb.weight.grad.numpy(), np.asarray(grad_j),
                               rtol=1e-6, atol=1e-6)
    assert np.isfinite(emb.weight.grad.numpy()).all()


def test_alias_select_takes_int_bounds():
    g = torch.Generator().manual_seed(0)
    prob = torch.rand(10, generator=g)
    alias = torch.randint(0, 4, (10,), generator=g, dtype=torch.int32)
    u1, u2 = torch.rand(64, generator=g), torch.rand(64, generator=g)
    want = alias_select(prob, alias, torch.tensor(3), torch.tensor(4), u1,
                        u2)
    assert torch.equal(alias_select(prob, alias, 3, 4, u1, u2), want)
    assert torch.equal(alias_select(prob, alias, 3, 0, u1, u2),
                       torch.full((64,), -1, dtype=torch.int32))


def test_profiler_hook(tmp_path):
    h = hooks.ProfilerHook(str(tmp_path / "prof"), start=1, steps=1)
    for step in range(1, 4):
        torch.zeros(4).add_(1)
        h(step)
    h.close()
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")


def test_profiler_hook_rounds_to_loop_boundaries(tmp_path):
    h = hooks.ProfilerHook(str(tmp_path / "prof"), start=10, steps=10)
    active = []
    for step in (4, 8, 12, 16, 20, 24):
        h(step)
        active.append(h._prof is not None)
    assert active == [False, False, True, True, False, False]
    assert len(os.listdir(tmp_path / "prof")) == 1


def test_sync_exit_hook_without_a_process_group():
    hooks.SyncExitHook()()


def test_logging_hook():
    lines = []
    h = hooks.LoggingHook(every=2, log_fn=lines.append)
    for step in range(1, 6):
        h(step, 0.5, 8)
    assert [s.split()[2] for s in lines] == ["2", "4"]


def test_logging_hook_under_loops():
    """Calls after each loop of 3 steps log at the first call past each
    multiple of 4, with the total, and read the loss only there."""
    lines = []
    h = hooks.LoggingHook(every=4, log_fn=lines.append, steps_per_call=3,
                          total=12)
    got = [h(step, torch.tensor(0.25), 8) for step in (3, 6, 9, 12)]
    assert got == [None, 0.25, 0.25, 0.25]
    assert [s.split()[2] for s in lines] == ["6/12", "9/12", "12/12"]
    assert hooks.LoggingHook(every=0, log_fn=lines.append)(4, 0.5, 8) is None

def test_graph_config_matches_reference():
    for conf in ("a=1; b = x ;flag=true;;f=2.5", {"k": 3, "on": "no"}, None):
        ours, ref = config.GraphConfig(conf), jax_config.GraphConfig(conf)
        assert str(ours) == str(ref)
        for key in ("a", "b", "flag", "f", "k", "on", "missing"):
            assert ours.get_string(key, "d") == ref.get_string(key, "d")
            assert ours.get_bool(key) == ref.get_bool(key)
            assert (key in ours) == (key in ref)
    assert config.GraphConfig("a=1").add("n", 4).get_int("n") == 4
    with pytest.raises(ValueError):
        config.GraphConfig("novalue")


@pytest.mark.parametrize("argv", [
    [], ["--dataset", "cora", "--fanouts", "10", "5", "--profile",
         "--optimizer", "momentum", "--total_steps", "7"]])
def test_run_flags_match_reference(argv, monkeypatch):
    # the reference's flags, and the port's own --device (default cuda)
    assert vars(config.define_run_flags().parse_args(argv)) == dict(
        vars(jax_config.define_run_flags().parse_args(argv)), device="cuda")
    assert config.define_run_flags().parse_args(
        argv + ["--device", "cpu"]).device == "cpu"
    monkeypatch.setattr(config, "_DEFAULTS", {})
    config.set_defaults(batch_size=99, nope=1)
    args = config.apply_defaults(config.define_run_flags().parse_args(argv))
    assert args.batch_size == 99 and not hasattr(args, "nope")


def test_parse_mesh_flag_counts_the_cuda_devices(monkeypatch):
    # the port counts ranks, one a card: a launcher's WORLD_SIZE of 4
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(jax, "device_count", lambda: 4)
    for spec in ("auto", "2x2", "data=1,graph=4", "data=4"):
        assert config.parse_mesh_flag(spec) == jax_config.parse_mesh_flag(
            spec)
    with pytest.raises(ValueError):
        config.parse_mesh_flag("3x1")


def test_io_matches_reference_on_local_paths(tmp_path):
    for mod, root in ((jax_io, tmp_path / "ref"), (port_io, tmp_path / "t")):
        base = str(root)
        mod.makedirs(mod.join(base, "a", "b"))
        with mod.open_file(mod.join(base, "c", "x.txt"), "w") as f:
            f.write("hi")
    for name in ("exists", "listdir"):
        for sub in ("", "c", "a"):
            args = [os.path.join(str(tmp_path / r), sub) for r in ("ref", "t")]
            assert getattr(jax_io, name)(args[0]) == getattr(
                port_io, name)(args[1])
    assert [os.path.basename(p) for p in port_io.glob(
        str(tmp_path / "t" / "*"))] == [os.path.basename(p) for p in
                                        jax_io.glob(str(tmp_path / "ref" /
                                                        "*"))]
    with port_io.open_file(str(tmp_path / "t" / "c" / "x.txt"), "r") as f:
        assert f.read() == "hi"
    assert port_io.join("gs://b/", "/x", "y") == jax_io.join("gs://b/", "/x",
                                                             "y")
    assert port_io.is_remote("s3://b/k") and not port_io.is_remote("/x")
    for fn in (port_io.exists, port_io.listdir, port_io.makedirs,
               port_io.glob, port_io.open_file):
        with pytest.raises(ImportError, match="local paths only"):
            fn("gs://bucket/key")


def dense_inputs(seed):
    rng = np.random.default_rng(seed)
    n, G, M = 40, 4, 6
    gi = rng.integers(-1, G, n).astype(np.int32)         # -1: dropped
    x = rng.standard_normal((n, 3)).astype(np.float32)
    ei = rng.integers(-1, n, (2, 120)).astype(np.int32)  # some across graphs
    w = rng.standard_normal(120).astype(np.float32)
    return x, gi, ei, w, G, M


@pytest.mark.parametrize("seed", [0, 1])
def test_to_dense_batch_matches_reference(seed):
    x, gi, _, _, G, M = dense_inputs(seed)
    want_x, want_m = jax.jit(jax_dense.to_dense_batch, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(gi), G, M)
    got_x, got_m = dense.to_dense_batch(torch.from_numpy(x),
                                        torch.from_numpy(gi), G, M)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got_m.sum() < (gi >= 0).sum()      # some graph overflowed M


@pytest.mark.parametrize("weighted", [False, True])
def test_to_dense_adj_matches_reference(weighted):
    _, gi, ei, w, G, M = dense_inputs(2)
    w_j = jnp.asarray(w) if weighted else None
    want = jax.jit(jax_dense.to_dense_adj, static_argnums=(2, 3))(
        jnp.asarray(ei), jnp.asarray(gi), G, M, w_j)
    got = dense.to_dense_adj(torch.from_numpy(ei), torch.from_numpy(gi), G,
                             M, torch.from_numpy(w) if weighted else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (got != 0).sum() > 0
