"""The port's sharded train step over a CPU mesh of gloo ranks, against
euler_tpu's ``make_sharded_train_step`` on the 8-device virtual CPU
mesh, and against the port's own one-device step.

Ranks are processes (``tests/test_torch_mesh_ranks.py``) started once
per mesh, ``data=1, graph=4`` and ``data=2, graph=2``; every case runs
in that one start.

- Train-step parity: two Adam steps of the small sage model of the
  apply cases (feat 8, fanouts [4, 3], dims [8, 6]) from the reference's
  initial weights. The batch source is a uniform id draw from the step
  key, so that the test gives each graph group its ``b * S`` ids; each
  owner's uniforms are derived from the flow key its rank folds in (the
  reference's ``_local_batch`` chain, recorded by ``RecordingFlow``).
  Each step's loss and every parameter must equal the reference's
  within 1e-5 on every rank, and the parameters must be bit-equal
  across ranks.
- The port against itself: one mesh step equals one one-device step
  over the concatenated batch, each owner given its group members' rows
  of the one-device uniforms, within 1e-5.
- The gradient scale: a graph-sharded ``ShardedEmbedding``'s synced
  gradient equals the reference's, the SUM of its graph group's
  contributions (the transpose of the lookup's all_gather), then the
  mean over the data group.
- The collectives' backward over each graph group against the
  reference's transposes under ``shard_map(check_vma=False)``, the
  all_gather's sum-scatter included; ``pmax`` refuses a tensor that
  needs a gradient.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from euler_tpu.estimator.estimator import get_optimizer as jax_optimizer
from euler_tpu.models import layers as jax_layers
from euler_tpu.parallel import comms as jax_comms
from euler_tpu.parallel import mesh as jax_mesh
from euler_tpu.parallel import sharded as jax_sharded
from euler_tpu.parallel import train as jax_train
from euler_tpu_torch.estimator import NodeEstimator, RunConfig, get_optimizer
from euler_tpu_torch.models import load_flax_params
from euler_tpu_torch.parallel import sharded
from tests import test_torch_mesh_ranks as ranks
from tests.test_torch_models import RecordingFlow
from tests.test_torch_sharded import apply_graphs, fan_u, ref_model

SAGE = dict(model="sage", feat_dim=8, label_dim=3, fanouts=[4, 3],
            dims=[8, 6], seed=5)
B = 8                      # roots a rank
LR = 0.05
STEPS = 2
TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT_S = 240
MESHES = {"g4": (1, 4), "d2g2": (2, 2)}
EMB = dict(num=23, dim=4)
K = 5                      # the collectives' vector length


def uniform_ids(n: int):
    """The tests' batch source: ``count`` ids uniform in [0, n) from the
    key (replaces the sharded root draw, so that the test knows each
    graph group's ids)."""
    def ids_fn(view, key, count):
        return jax.random.randint(key, (count,), 0, n, jnp.int32)
    return ids_fn


def rank_keys(key, graph: int, r: int):
    """(roots key, sample key) of rank r from a step key: the
    reference's ``_local_batch`` (train.py:96-107)."""
    kroots, ksample = jax.random.split(jax.random.fold_in(key, r // graph))
    return kroots, jax.random.fold_in(ksample, r % graph)


def sage_u_spec():
    return [[f"h{h}_u{i}" for i in range(2)]
            for h in range(len(SAGE["fanouts"]))]


def ref_sage_case(gj, data: int, graph: int, seed: int):
    """The reference's two sharded Adam steps: the ranks' arrays (each
    step's group ids and owner uniforms, the initial weights as the
    port's state dict) and (losses, final weights as the port's state
    dict, sorted names)."""
    W, N = data * graph, gj.meta.n_nodes
    model = ref_model()
    ids_fn = uniform_ids(N)
    variables = model.init({"params": jax.random.PRNGKey(seed),
                            "sample": jax.random.PRNGKey(seed + 1)},
                           gj.tensors, jnp.zeros((B,), jnp.int32))
    rec = RecordingFlow(model.embedder.flow)
    recording = model.clone(embedder=model.embedder.clone(flow=rec))
    keys = jax.random.split(jax.random.PRNGKey(seed + 2), STEPS)
    arrays = {}
    for t, k in enumerate(keys):
        per_rank = []
        for r in range(W):
            kroots, ksample = rank_keys(k, graph, r)
            ids = np.asarray(ids_fn(None, kroots, B * graph))
            mine = ids[(r % graph) * B:(r % graph + 1) * B]
            recording.apply(variables, gj.tensors, jnp.asarray(mine),
                            rngs={"sample": ksample})
            fk, rows, u = rec.keys[-1], B, {f"t{t}/ids": ids}
            for h, c in enumerate(SAGE["fanouts"]):
                fk, sub = jax.random.split(fk)
                for i, x in enumerate(fan_u(sub, graph * rows, c)):
                    u[f"t{t}/h{h}_u{i}"] = x
                rows *= 1 + c
            per_rank.append(u)
        for name in per_rank[0]:
            arrays[name] = np.stack([u[name] for u in per_rank])
    port = ranks.build_model(SAGE)
    load_flax_params(port, jax.tree.map(np.asarray, variables))
    arrays.update({f"p/{k}": np.stack([v.numpy()] * W)
                   for k, v in port.state_dict().items()})

    mesh = jax_mesh.make_mesh(data=data, graph=graph)
    sg = jax_sharded.build_sharded(gj, graph)
    tx = jax_optimizer("adam", LR)
    step = jax_train.make_sharded_train_step(model, sg, tx, mesh, B,
                                             ids_fn=ids_fn)
    params, opt, losses = variables, tx.init(variables), []
    with mesh:
        for k in keys:
            params, opt, loss = step(params, opt, sg, k)
            losses.append(float(loss))
    load_flax_params(port, jax.tree.map(np.asarray, params))
    state = port.state_dict()
    return arrays, (losses, [state[k].numpy() for k in sorted(state)])


def self_case(g, data: int, graph: int, seed: int):
    """One step on one device over the concatenated batch of every rank,
    and the ranks' arrays: each graph group's ids and each owner's
    uniforms, its group members' rows of the one-device draws in member
    order."""
    W = data * graph
    model = ranks.build_model(SAGE)
    flow = model.embedder.flow
    roots = np.random.default_rng(seed).integers(
        0, g.meta.n_nodes, W * B).astype(np.int32)
    gen = torch.Generator().manual_seed(seed)
    U, rows, owner = [], W * B, [np.arange(W * B) // B]
    for ets, c in zip(flow.metapath, flow.fanouts):
        U.append(flow.draw_hop(g.tensors, ets, gen, rows, c, "cpu"))
        owner.append(np.concatenate([owner[-1], np.repeat(owner[-1], c)]))
        rows *= c + 1
    arrays = {}
    for r in range(W):
        members = range(r // graph * graph, (r // graph + 1) * graph)
        arrays.setdefault("t0/ids", []).append(
            np.concatenate([roots[m * B:(m + 1) * B] for m in members]))
        for h, u in enumerate(U):
            for i, x in enumerate(u):
                arrays.setdefault(f"t0/h{h}_u{i}", []).append(np.concatenate(
                    [x.numpy()[owner[h] == m] for m in members]))
    arrays = {k: np.stack(v) for k, v in arrays.items()}
    est = NodeEstimator(model, g, RunConfig(batch_size=W * B), device="cpu")
    opt = get_optimizer("adam", LR, model.parameters())
    loss = float(est.step(opt, torch.from_numpy(roots), uniforms=U))
    state = model.state_dict()
    return arrays, (loss, [state[k].numpy() for k in sorted(state)])


def ref_emb_grad(gj, data: int, graph: int, ids: np.ndarray,
                 w: np.ndarray):
    """The reference's ShardedEmbedding over the mesh: its assembled
    table, each rank's lookup and the synced gradient, assembled."""
    mesh = jax_mesh.make_mesh(data=data, graph=graph)
    sg = jax_sharded.build_sharded(gj, graph)
    gspecs = jax_sharded.shard_specs(sg)
    mod = jax_layers.ShardedEmbedding(**EMB)
    both = P(("data", "graph"))

    def init_body(sgb, key):
        return mod.init({"params": key}, jax_sharded.to_view(sgb, "graph"),
                        jnp.zeros((ids.shape[1],), jnp.int32))

    def init_sm(out_specs):
        return jax.shard_map(init_body, mesh=mesh, in_specs=(gspecs, P()),
                             out_specs=out_specs, check_vma=False)

    def body(sgb, params, ids_b, w_b):
        view = jax_sharded.to_view(sgb, "graph")

        def lossf(p):
            out = mod.apply(p, view, ids_b[0])
            return jax_comms.pmean(jnp.sum(w_b[0] * out),
                                   ("data", "graph")), out
        (_, out), grads = jax.value_and_grad(lossf, has_aux=True)(params)
        return out[None], jax_train._sync_grads(grads)

    key = jax.random.PRNGKey(0)
    with mesh:
        pspecs = jax_train.param_specs(jax.eval_shape(init_sm(P()), sg, key))
        params = jax.jit(init_sm(pspecs))(sg, key)
        out, grads = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(gspecs, pspecs, both, both),
            out_specs=(both, pspecs), check_vma=False))(
            sg, params, jnp.asarray(ids), jnp.asarray(w))
    unbox = nn.meta.unbox
    return (np.asarray(unbox(params)["params"]["embedding"]),
            np.asarray(out), np.asarray(unbox(grads)["params"]["embedding"]))


def ref_comms_grads(x, c_ag, c):
    """Each collective's transpose on the reference: the gradient of
    sum(c * f(x)) under shard_map(check_vma=False) at graph=4."""
    mesh = jax_mesh.make_mesh(data=1, graph=x.shape[0])

    def body(xb, cagb, cb):
        xb, cagb, cb = xb[0], cagb[0], cb[0]
        fns = [(lambda v: jax.lax.all_gather(v, "graph"), cagb),
               (lambda v: jax.lax.all_to_all(v, "graph", 0, 0, tiled=True),
                cb),
               (lambda v: jax.lax.psum(v, "graph"), cb),
               (lambda v: jax.lax.pmean(v, "graph"), cb)]
        return tuple(jax.grad(lambda v, f=f, k=k: jnp.sum(k * f(v)))(xb)[None]
                     for f, k in fns)

    with mesh:
        out = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("graph"),) * 3,
            out_specs=P("graph"), check_vma=False))(x, c_ag, c)
    return [np.asarray(o) for o in out]


def launch(tmp_path_factory, name: str):
    """Every case of one mesh in one start of its ranks."""
    data, graph = MESHES[name]
    W = data * graph
    gja, ga = apply_graphs()
    arrays, cases, want = {}, [], {}

    def add(case, a, opts, verb):
        arrays.update({f"{case}/{k}": v for k, v in a.items()})
        cases.append(dict(name=case, verb=verb, graph="apply", opts=opts))

    a, want["ref"] = ref_sage_case(gja, data, graph, seed=11)
    add("ref", a, dict(SAGE, b=B, lr=LR, steps=STEPS, u_spec=sage_u_spec()),
        "train")
    a, want["self"] = self_case(ga, data, graph, seed=12)
    add("self", a, dict(SAGE, b=B, lr=LR, steps=1, u_spec=sage_u_spec()),
        "train")
    rng = np.random.default_rng(13)
    ids = rng.integers(-1, EMB["num"] + 2, (W, 6)).astype(np.int32)
    ids[:, 0] = ids[0, 0]                # one row every rank looks up
    w = rng.normal(size=(W, 6, EMB["dim"])).astype(np.float32)
    table, out, grad = ref_emb_grad(gja, data, graph, ids, w)
    want["emb"] = (out, grad)
    add("emb", dict(ids=ids, w=w, table=np.stack([table] * W)), EMB,
        "emb_grad")
    # each graph group holds the same inputs, member by member
    x = rng.normal(size=(graph, graph * K)).astype(np.float32)
    c_ag = rng.normal(size=(graph, graph, graph * K)).astype(np.float32)
    c = rng.normal(size=(graph, graph * K)).astype(np.float32)
    want["comms"] = (x, ref_comms_grads(x, c_ag, c))
    member = np.arange(W) % graph
    add("comms", dict(x=x[member], c_ag=c_ag[member], c=c[member]), {},
        "comms_grad")
    work = str(tmp_path_factory.mktemp(name))
    ranks.write_work(work, data, graph,
                     dict(apply=sharded.build_sharded(ga, graph)), arrays,
                     cases, TIMEOUT_S / 2)
    return dict(outs=ranks.launch(work, W, TIMEOUT_S), want=want, W=W,
                graph=graph)


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_run(request, tmp_path_factory):
    return launch(tmp_path_factory, request.param)


def outputs(run, case: str, rank: int):
    got = run["outs"][rank]
    n = sum(1 for k in got if k.startswith(case + "/"))
    return [got[f"{case}/{i}"] for i in range(n)]


def test_train_step_equals_reference(mesh_run):
    losses, state = mesh_run["want"]["ref"]
    for r in range(mesh_run["W"]):
        got = outputs(mesh_run, "ref", r)
        np.testing.assert_allclose([float(x) for x in got[:STEPS]], losses,
                                   err_msg=f"losses rank {r}", **TOL)
        for i, (a, b) in enumerate(zip(got[STEPS:], state)):
            np.testing.assert_allclose(a, b, err_msg=f"param {i} rank {r}",
                                       **TOL)


def test_replicated_parameters_are_bit_equal_across_ranks(mesh_run):
    for case, steps in (("ref", STEPS), ("self", 1)):
        first = outputs(mesh_run, case, 0)
        for r in range(1, mesh_run["W"]):
            for i, (a, b) in enumerate(zip(outputs(mesh_run, case, r),
                                           first)):
                np.testing.assert_array_equal(
                    a, b, err_msg=f"{case} output {i} rank {r}")


def test_mesh_step_equals_one_device_step(mesh_run):
    loss, state = mesh_run["want"]["self"]
    for r in range(mesh_run["W"]):
        got = outputs(mesh_run, "self", r)
        np.testing.assert_allclose(float(got[0]), loss, **TOL)
        for i, (a, b) in enumerate(zip(got[1:], state)):
            np.testing.assert_allclose(a, b, err_msg=f"param {i} rank {r}",
                                       **TOL)


def test_sharded_table_gradient_is_the_group_sum(mesh_run):
    """Each rank's block gradient equals the reference's rows of it: the
    sum of the graph group's contributions, averaged over data."""
    out, grad = mesh_run["want"]["emb"]
    S = mesh_run["graph"]
    n_local = -(-EMB["num"] // S)
    for r in range(mesh_run["W"]):
        got_out, got_grad = outputs(mesh_run, "emb", r)
        gi = r % S
        np.testing.assert_allclose(got_out, out[r], **TOL)
        np.testing.assert_allclose(
            got_grad, grad[gi * n_local:(gi + 1) * n_local],
            err_msg=f"rank {r}", **TOL)


def test_collectives_backward_equals_reference_transpose(mesh_run):
    x, want = mesh_run["want"]["comms"]
    for r in range(mesh_run["W"]):
        got = outputs(mesh_run, "comms", r)
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[i], w[r % mesh_run["graph"]],
                                       err_msg=f"grad {i}", **TOL)
        fwd, bwd = got[len(want)]
        assert fwd > 0 and bwd > 0
        np.testing.assert_array_equal(got[len(want) + 1], x.max(0))
        assert got[len(want) + 2][0] == 1          # pmax refused autograd
