"""``BaseEstimator.infer`` on the CPU, where it stays eager, and the parts
of its captured path on the card (``estimator.InferGraph``) that run
without one.

On the CPU ``infer`` must give the answer of today's eager loop (each
padded batch through the model with one fresh generator seeded with
``seed + 2``) bit for bit, fire the forward hooks in the order an eager
forward fires them, count its batches in ``infer_batches`` and replay and
capture nothing. ``_fingerprint``, which decides when the card's graph is
captured again, must change where a parameter, a buffer, a module, a hook,
``graph.tensors`` or the batch's shape is rebound or replaced, and not
under in-place updates. ``_hooks_replaced`` must put every hook back. The
benchmark's ``infer_replay_share.infer`` reads None at the CPU size of
benchmark/tests/test_benchmark_spans.py, where no batch ran on a card.
The captured path itself is held to the eager one on the card
(tests/test_torch_cuda.py, ``-k infer``).
"""
import numpy as np
import pytest
import torch

from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import NodeEstimator, RunConfig
from euler_tpu_torch.estimator import estimator as est_lib
from euler_tpu_torch.models import GNNNet, ShallowEncoder, SuperviseModel


@pytest.fixture(scope="module")
def graph():
    return random_graph(400, 20, feat_dim=8, n_classes=4, seed=0,
                        device="cpu")


def sage_estimator(graph, batch=64):
    net = GNNNet("sage", SageDataFlow([3, 2], [(0,), (0,)]), (8, 8),
                 ShallowEncoder(("feature",)), in_dim=8, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    model = SuperviseModel(net, "label", 4, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    return NodeEstimator(model, graph, RunConfig(batch_size=batch, seed=3),
                         device="cpu")


def eager_loop(est, ids):
    """Today's eager ``infer``: each padded batch through the model with
    one fresh generator seeded with ``seed + 2``."""
    B = est.config.batch_size
    ids = np.asarray(ids, np.int32)
    padded = np.concatenate([ids, np.full((-len(ids)) % B, -1, np.int32)])
    gen = torch.Generator().manual_seed(est.config.seed + 2)
    est.model.eval()
    with torch.no_grad():
        outs = [est.model(est.graph.tensors, torch.from_numpy(
            padded[i:i + B]), generator=gen)["embedding"]
            for i in range(0, len(padded), B)]
    return torch.cat(outs)[:len(ids)].numpy()


def firing(model):
    """(names, remove): a pre-hook on the model and forward hooks on both
    convs and the model append their names, and the first conv's block's
    draws, as they fire."""
    names = []
    convs = model.embedder.convs
    handles = [
        model.register_forward_pre_hook(lambda m, a: names.append("pre")),
        convs[0].register_forward_hook(
            lambda m, a, o: names.append(("conv0", a[1].n_id.clone()))),
        convs[1].register_forward_hook(lambda m, a, o: names.append("conv1")),
        model.register_forward_hook(lambda m, a, o: names.append("model"))]
    return names, lambda: [h.remove() for h in handles]


def test_infer_on_the_cpu_stays_eager(graph):
    est = sage_estimator(graph)
    assert est._infer_graph is None
    ids = np.arange(150)                       # 3 batches, the last padded
    names, remove = firing(est.model)
    got = est.infer(ids)
    fired, names[:] = list(names), []
    want = eager_loop(est, ids)
    remove()
    np.testing.assert_array_equal(got, want)
    assert [n if isinstance(n, str) else n[0] for n in fired] == \
        ["pre", "conv0", "conv1", "model"] * 3
    assert len(fired) == len(names) and all(
        a == b if isinstance(a, str) else torch.equal(a[1], b[1])
        for a, b in zip(fired, names))
    np.testing.assert_array_equal(est.infer(ids), got)   # reseeded a call
    assert (est.infer_batches, est.infer_replays, est.infer_captures) == \
        (6, 0, 0)


def test_fingerprint_follows_what_a_capture_reads(graph):
    est = sage_estimator(graph)
    model, g = est.model, graph.tensors
    key = est_lib._fingerprint(model, g, (64,))
    assert est_lib._fingerprint(model, g, (64,)) == key
    with torch.no_grad():                      # in place: the same graph
        est.model.head_fc.weight.add_(1.0)
        est.model.load_state_dict(est.model.state_dict())
    assert est_lib._fingerprint(model, g, (64,)) == key
    assert est_lib._fingerprint(model, g, (32,)) != key
    assert est_lib._fingerprint(model, object(), (64,)) != key
    handle = model.embedder.convs[1].register_forward_hook(
        lambda m, a, o: None)
    assert est_lib._fingerprint(model, g, (64,)) != key
    handle.remove()
    assert est_lib._fingerprint(model, g, (64,)) == key
    fc = model.head_fc
    fc.weight = torch.nn.Parameter(fc.weight.detach().clone())
    rebound = est_lib._fingerprint(model, g, (64,))
    assert rebound != key
    fc.register_buffer("scale", torch.ones(1))
    assert est_lib._fingerprint(model, g, (64,)) != rebound
    model.head_fc = torch.nn.Linear(fc.in_features, fc.out_features,
                                    bias=False)
    assert est_lib._fingerprint(model, g, (64,)) != rebound


def test_hooks_replaced_puts_every_hook_back(graph):
    model = sage_estimator(graph).model
    names, remove = firing(model)
    before = [(dict(m._forward_pre_hooks), dict(m._forward_hooks))
              for m in model.modules()]
    seen = []

    def wrap(hook):
        def call(*a):
            seen.append(hook)
        return call
    with est_lib._hooks_replaced(model, wrap):
        with torch.no_grad():
            model(graph.tensors, torch.arange(8, dtype=torch.int32),
                  generator=torch.Generator().manual_seed(0))
    assert names == [] and len(seen) == 4      # wrapped, not called
    assert [(dict(m._forward_pre_hooks), dict(m._forward_hooks))
            for m in model.modules()] == before
    remove()
    assert not est_lib._global_hooks()
    handle = torch.nn.modules.module.register_module_forward_hook(
        lambda m, a, o: None)
    try:
        assert est_lib._global_hooks()
    finally:
        handle.remove()


def test_replay_share_reads_none_at_the_cpu_size(tmp_path):
    from benchmark.harness import drive as drive_lib
    from benchmark.harness import runner
    from benchmark.tests.conftest import write_spec
    spec = write_spec(str(tmp_path))
    w = spec.workload("sage-infer")
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    system = spec.config_module(w["config"]).build(cfg, 3, "cpu")
    drv = drive_lib.make(spec, mix, system, 3)
    drv.setup()
    ctx = runner.Context(spec=spec, workload=w, cfg=cfg, mix=mix,
                         system=system, drive=drv, window={}, trace=None,
                         device="cpu")
    assert spec.metric_reader("infer_replay_share.infer").read(ctx) is None
    # each warm request of 1,024 ids runs as 2 batches of 512, eagerly
    assert (system.est.infer_batches, system.est.infer_replays) == \
        (2 * mix["warm_requests"], 0)
