"""The driver's entry points on the port (euler_tpu_torch/graft_entry.py)
against __graft_entry__.py, and the mesh's last API pieces
(``comms.ppermute``, the Spmd estimators' ``mesh=None, graph_shards=``),
on the CPU.

- ``entry()``: the port's loss and logit equal the reference entry's
  within 1e-5 (f32), with the reference's flax params loaded and the hop
  uniforms derived from the key its flow receives from ``PRNGKey(2)``;
  both graphs hold the same fan pack and the hops take its branch.
- ``pick_mesh(n)`` is the (data, graph) that the reference's
  ``dryrun_multichip(n)`` builds, n = 1..8.
- ``dryrun_multichip(4)`` on 4 gloo CPU ranks, once a module, against the
  reference's ``dryrun_multichip(4)`` on the conftest's 8-device virtual
  CPU mesh, also once a module (about 7 s): mesh (1, 4), finite losses,
  and the first step's forward bytes by collective equal one copy of the
  reference's on every rank, but for the root draw's sync (the reference
  all_gathers an 8-byte key, the port two f32 [b * S] uniforms).
- ``comms.ppermute`` over the world (a cycle, a partial permutation
  where one rank sends and receives nothing and one only sends, one with
  a rank that keeps its own) and over the graph group of a 2x2 mesh
  equals ``jax.lax.ppermute`` under ``shard_map``, forward and in its
  gradient, and counts n bytes forward and backward, as the reference's
  ``comms.ppermute`` counts n.
- ``SpmdNodeEstimator(mesh=None, graph_shards=2)`` on 4 gloo ranks gets
  mesh (2, 2) and the first loss of one built with ``make_mesh(2, 2)``;
  ``graph_shards=0`` takes every rank on the graph axis; 3 raises; and
  outside a process group it raises.

The ranks of the last two run ``_rank_cases`` of this module, started
once a module through ``parallel.launch``; each spawned rank imports this
module, so jax and the reference are imported inside the functions that
use them, never at the top.
"""
import contextlib
import io
import math
import re
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from euler_tpu_torch import graft_entry as ge
from euler_tpu_torch.estimator import RunConfig, SpmdNodeEstimator
from euler_tpu_torch.models import load_flax_params
from euler_tpu_torch.ops import sampling
from euler_tpu_torch.parallel import comms
from euler_tpu_torch.parallel import mesh as mesh_lib
from euler_tpu_torch.parallel.launch import launch

TOL = dict(rtol=1e-5, atol=1e-5)
WORLD, WIDTH, TIMEOUT_S = 4, 6, 240
#: (src, dst) pairs over the world's 4 ranks: rank 3 of "partial" sends
#: and receives nothing, rank 2 only receives; "fixed" keeps rank 0's own
WORLD_PERMS = {"cycle": [(i, (i + 1) % WORLD) for i in range(WORLD)],
               "partial": [(0, 2), (3, 1), (1, 0)],
               "fixed": [(0, 0), (1, 2), (2, 1)]}
#: over the graph group (2 ranks) of each data index of a 2x2 mesh
GROUP_PERM = [(0, 1), (1, 0)]


# ---------------------------------------------------------------- entry --

def reference_entry(tmp_path, monkeypatch):
    """The reference entry's params, graph, loss and logit, and the key
    its flow received (recorded while the forward is traced under jit,
    returned as an aux output)."""
    import jax
    from euler_tpu.dataflow import flows as jax_flows
    import __graft_entry__ as ref

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    fwd, (params, g, roots, key) = ref.entry()
    keys = []
    call = jax_flows.SageDataFlow.__call__

    def recording(self, g, key, roots):
        keys.append(key)
        return call(self, g, key, roots)
    monkeypatch.setattr(jax_flows.SageDataFlow, "__call__", recording)

    def run(params, g, roots, key):
        return (*fwd(params, g, roots, key), keys[-1])
    loss, logit, flow_key = jax.jit(run)(params, g, roots, key)
    assert np.asarray(roots).tolist() == list(range(ge.ROOTS))
    return (jax.tree.map(np.asarray, params), g, np.asarray(loss),
            np.asarray(logit), flow_key)


def test_entry_equals_the_reference(tmp_path, monkeypatch):
    from tests.test_torch_models import hop_uniforms
    params, g_ref, loss, logit, flow_key = reference_entry(tmp_path,
                                                           monkeypatch)
    fn, (model, g, roots, uniforms) = ge.entry("cpu")
    assert roots.tolist() == list(range(ge.ROOTS))
    # the same fan pack, and both hops draw from it
    np.testing.assert_array_equal(g.fan_pack.numpy(),
                                  np.asarray(g_ref.fan_pack))
    flow = model.embedder.flow
    assert [sampling.hop_kind(g, ets)
            for ets in flow.metapath] == ["fan", "fan"]
    U = hop_uniforms(flow_key, ge.ROOTS, ge.FANOUTS)
    assert [[u.shape for u in hop] for hop in U] == \
        [[u.shape for u in hop] for hop in uniforms]
    load_flax_params(model, params)
    with torch.no_grad():
        got_loss, got_logit = fn(model, g, roots, U)
    assert got_logit.shape == (ge.ROOTS, 4)
    np.testing.assert_allclose(got_logit.numpy(), logit, **TOL)
    np.testing.assert_allclose(float(got_loss), float(loss), **TOL)
    with torch.no_grad():
        own_loss, _ = fn(model, g, roots, uniforms)
    assert math.isfinite(float(own_loss))


def test_entry_and_dryrun_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (ge.entry, lambda: ge.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ge.dryrun_multichip(2, backend="nccl", device="cpu")


@pytest.mark.parametrize("n", range(1, 9))
def test_pick_mesh_is_the_reference_rule(n, monkeypatch):
    import __graft_entry__ as ref
    from euler_tpu.parallel import mesh as jax_mesh

    class Picked(Exception):
        pass

    def picked(data=1, graph=1, devices=None):
        raise Picked(data, graph)
    monkeypatch.setattr(jax_mesh, "make_mesh", picked)
    monkeypatch.setattr(ref, "_build_small", lambda: (None, None, None))
    with pytest.raises(Picked) as e:
        ref.dryrun_multichip(n)
    assert ge.pick_mesh(n) == e.value.args


# --------------------------------------------------------------- dryrun --

@pytest.fixture(scope="module")
def dryrun():
    return ge.dryrun_multichip(WORLD, device="cpu")


@pytest.fixture(scope="module")
def reference_dryrun(tmp_path_factory):
    """The reference's dryrun_multichip(4): its accounted events and its
    printed lines."""
    import __graft_entry__ as ref
    from euler_tpu.parallel import comms as jax_comms
    accs, account = [], jax_comms.account

    @contextlib.contextmanager
    def keep():
        with account() as acc:
            accs.append(acc)
            yield acc
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_comms, "account", keep)
        mp.setattr(tempfile, "tempdir", str(tmp_path_factory.mktemp("ref")))
        with contextlib.redirect_stdout(out):
            ref.dryrun_multichip(WORLD)
    (acc,) = accs
    return acc.events, out.getvalue().splitlines()


def kb(line: str) -> dict:
    return {k: float(v) for k, v in re.findall(r"(\w+)=([\d.]+)KB", line)}


def test_dryrun_multichip_runs_the_reference_sequence(dryrun,
                                                      reference_dryrun):
    _, lines = reference_dryrun
    assert dryrun["mesh"] == (1, 4) and "mesh=(1,4)" in lines[0]
    ranks = dryrun["ranks"]
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    for r in ranks:
        assert r["mesh"] == (1, 4)
        for k in ("first_loss", "loss", "walk_loss"):
            assert math.isfinite(r[k]), (r["rank"], k)
            # the loss is pmean'd over every rank
            assert r[k] == ranks[0][k], (r["rank"], k)
        assert r["graph_sharded"] == ["context_emb.embedding",
                                      "target_emb.embedding"]
        # the plain versions run on the CPU, which counts no launch
        for k in ("launches", "loop_launches", "walk_launches"):
            assert r[k] == {"fan_draw": 0, "gather_rows": 0, "ell_agg": 0,
                            "ell_sddmm": 0, "ell_gat": 0, "rel_mean": 0,
                            "rel_mean_tr": 0, "sigmoid_xent": 0}
    assert (dryrun["loss"], dryrun["walk_loss"]) == (ranks[0]["loss"],
                                                     ranks[0]["walk_loss"])
    report = ge.report_lines(ranks[0])
    assert report[0].startswith("[euler_tpu_torch] dryrun_multichip ok: "
                                "mesh=(1,4) loss=")


def test_dryrun_forward_bytes_equal_one_copy_of_the_reference(
        dryrun, reference_dryrun):
    from tests.test_torch_tools_mesh import one_step
    events, lines = reference_dryrun
    want = one_step(events)
    # the root draw's sync: two f32 [b * S] uniforms against an 8-byte key
    S, count = 4, ge.BATCH_PER_RANK * 4
    sync = (S - 1) * (2 * 4 * count - 8)
    want["all_gather"] += sync
    for r in dryrun["ranks"]:
        got = {k: v for k, v in r["forward"].items()
               if k not in ("total", comms.HOST_STAGED)}
        assert got == want, (r["rank"], got, want)
        assert r["forward"][comms.HOST_STAGED] == 0      # CPU tensors
    # the printed figures: the reference's within its 0.05 KB rounding
    ref_kb, got_kb = kb(lines[1]), kb(ge.report_lines(dryrun["ranks"][0])[1])
    assert set(got_kb) == set(ref_kb)
    for k, v in got_kb.items():
        v -= sync / 1e3 if k in ("all_gather", "total") else 0
        assert abs(v - ref_kb[k]) <= 0.05 + 1e-9, (k, v, ref_kb[k])


# ---------------------------------------------- ppermute and mesh=None --

def _ppermute_case(x, c, group, perm) -> dict:
    """ppermute of ``x`` over ``group``, and the gradient of sum(c * y),
    with their bytes by direction."""
    x = x.clone().requires_grad_(True)
    with comms.account() as acc:
        y = comms.ppermute(x, group, perm)
        (y * c).sum().backward()
    return dict(y=y.detach().numpy(), grad=x.grad.numpy(),
                forward=acc.totals(comms.FORWARD)["ppermute"],
                backward=acc.totals(comms.BACKWARD)["ppermute"])


def _rank_cases(root: str, x: np.ndarray, c: np.ndarray) -> dict:
    """One rank of the module's gloo ranks: the world's ppermute cases,
    then the estimators over the SBM graph under ``root``."""
    torch.set_num_threads(1)
    rank = dist.get_rank()
    xr, cr = torch.from_numpy(x[rank]), torch.from_numpy(c[rank])
    out = {name: _ppermute_case(xr, cr, dist.group.WORLD, perm)
           for name, perm in WORLD_PERMS.items()}
    ds, g, model = ge._build_small("cpu", root)
    cfg = RunConfig(batch_size=32, total_steps=1, log_steps=0,
                    reservoir_refresh=0)
    est = SpmdNodeEstimator(model, g, cfg, ds.train_node_type,
                            graph_shards=2)
    out["auto"] = dict(mesh=(est.mesh.data, est.mesh.graph),
                       loss=est.train()["loss"])
    out["group_swap"] = _ppermute_case(xr, cr, est.mesh.graph_group,
                                       GROUP_PERM)
    _, _, model = ge._build_small("cpu", root)
    est = SpmdNodeEstimator(model, g, cfg, ds.train_node_type,
                            mesh=mesh_lib.make_mesh(2, 2, device="cpu"))
    out["explicit"] = dict(mesh=(est.mesh.data, est.mesh.graph),
                           loss=est.train()["loss"])
    est = SpmdNodeEstimator(model, g, cfg, ds.train_node_type)
    out["every_rank"] = (est.mesh.data, est.mesh.graph)
    try:
        SpmdNodeEstimator(model, g, cfg, ds.train_node_type, graph_shards=3)
        out["three"] = None
    except ValueError as e:
        out["three"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("graft_ranks"))
    ge._dataset(root).load_graph(device="cpu")           # convert once
    rng = np.random.default_rng(16)
    x = rng.normal(size=(WORLD, WIDTH)).astype(np.float32)
    c = rng.normal(size=(WORLD, WIDTH)).astype(np.float32)
    return x, c, launch(_rank_cases, WORLD, "gloo", TIMEOUT_S,
                        args=(root, x, c))


def reference_ppermute(x, c, perm, data: int, graph: int):
    """jax.lax.ppermute over the "graph" axis of a (data, graph) mesh
    (the reference's comms.ppermute, accounted) and the gradient of
    sum(c * y), each rank's row in rank order; and the bytes the
    reference counts."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from euler_tpu.parallel import comms as jax_comms
    from euler_tpu.parallel import mesh as jax_mesh
    mesh = jax_mesh.make_mesh(data=data, graph=graph)
    spec = P(("data", "graph"))

    def body(xb, cb):
        y = jax_comms.ppermute(xb, "graph", perm)
        grad = jax.grad(lambda v: jnp.sum(
            cb * jax.lax.ppermute(v, "graph", perm)))(xb)
        return y, grad

    with jax_comms.account() as acc, mesh:
        y, grad = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
            check_vma=False))(x, c)
    return np.asarray(y), np.asarray(grad), acc.totals()["ppermute"]


@pytest.mark.parametrize("name", sorted(WORLD_PERMS) + ["group_swap"])
def test_ppermute_equals_the_reference(ranks_run, name):
    x, c, outs = ranks_run
    if name == "group_swap":
        perm, data, graph = GROUP_PERM, 2, 2
    else:
        perm, data, graph = WORLD_PERMS[name], 1, WORLD
    want_y, want_grad, want_bytes = reference_ppermute(x, c, perm, data,
                                                       graph)
    for rank, out in enumerate(outs):
        got = out[name]
        np.testing.assert_array_equal(got["y"], want_y[rank])
        np.testing.assert_array_equal(got["grad"], want_grad[rank])
        assert got["forward"] == got["backward"] == want_bytes == 4 * WIDTH
    if name == "partial":
        # rank 3 gets zeros, and so does its gradient: no pair reads it
        assert not outs[3][name]["y"].any()
        assert not outs[2][name]["grad"].any()


def test_ppermute_refuses_what_is_not_a_permutation(tmp_path):
    from tests.test_torch_mesh_ranks import one_rank_mesh
    with one_rank_mesh(str(tmp_path)) as mesh:
        x = torch.ones(3)
        np.testing.assert_array_equal(
            comms.ppermute(x, mesh.world_group, [(0, 0)]).numpy(), x)
        for perm in ([(0, 1)], [(0, 0), (0, 0)], [(-1, 0)]):
            with pytest.raises(ValueError, match="not a permutation"):
                comms.ppermute(x, mesh.world_group, perm)


def test_mesh_none_builds_the_reference_mesh(ranks_run):
    _, _, outs = ranks_run
    for out in outs:
        assert out["auto"]["mesh"] == out["explicit"]["mesh"] == (2, 2)
        assert out["auto"]["loss"] == out["explicit"]["loss"]
        assert math.isfinite(out["auto"]["loss"])
        assert out["every_rank"] == (1, WORLD)
        assert "graph_shards=3 does not divide the 4 ranks" in out["three"]


def test_mesh_none_outside_a_process_group_raises(tmp_path):
    assert not dist.is_initialized()
    ds, g, model = ge._build_small("cpu", str(tmp_path))
    with pytest.raises(ValueError, match="joined none"):
        SpmdNodeEstimator(model, g, RunConfig(batch_size=32),
                          ds.train_node_type)
