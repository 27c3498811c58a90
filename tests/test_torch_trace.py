"""The port's span recorder, ``euler_tpu_torch.utils.trace``, on the CPU.

Off, a span is the shared no-op and costs no profiler call; on, spans nest
by the thread's open span, an ``infer`` call's spans share the request id
that ``BaseEstimator.requests`` advances, each span is a host event of
``torch.profiler``, and a loop's losses, weights and embeddings equal
those of the same run with tracing off. ``ProfilerHook`` traces with the
spans on. Self time is a span's duration less its children's cover.
"""
import collections
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import (NodeEstimator, RunConfig, TrainLoop,
                                       get_optimizer)
from euler_tpu_torch.models import GNNNet, ShallowEncoder, SuperviseModel
from euler_tpu_torch.utils import hooks, trace
from euler_tpu_torch.utils.trace import Span, recording, self_times, span


@pytest.fixture(scope="module")
def graph():
    return random_graph(300, 50, feat_dim=8, n_classes=4, seed=0,
                        device="cpu")


def estimator(graph, batch_size=16):
    net = GNNNet("sage", SageDataFlow([3, 2], [(0,), (0,)]), (8, 8),
                 ShallowEncoder(("feature",)), in_dim=8, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    model = SuperviseModel(net, "label", 4, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    return NodeEstimator(model, graph, RunConfig(batch_size=batch_size),
                         device="cpu")


def loop_of(est, steps):
    opt = get_optimizer("adam", 0.01, est.model.parameters())
    gen = torch.Generator().manual_seed(5)
    g = est.graph.tensors
    return TrainLoop(est, opt, gen, steps, lambda: est.train_batch(g, gen))


def names_under(spans, parent):
    return sorted(s.name for s in spans if s.parent is parent)


def test_off_span_is_the_shared_noop_and_records_nothing():
    assert not trace.enabled()
    first = span("a")
    assert first is trace.OFF and span("b", request=3) is trace.OFF
    with first:
        with span("c"):
            pass
    with recording() as spans:
        pass
    assert spans == []


def test_off_span_makes_no_profiler_call(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called while off")
    monkeypatch.setattr(trace, "record_function", refuse)
    with span("step"):
        pass
    with pytest.raises(AssertionError):
        with recording():
            with span("step"):
                pass


def test_recording_turns_tracing_off_on_error_and_nests():
    with pytest.raises(RuntimeError):
        with recording():
            assert trace.enabled()
            raise RuntimeError("inside")
    assert not trace.enabled()
    with recording() as outer:
        with span("x"):
            pass
        with recording() as inner:
            with span("y"):
                pass
        assert trace.enabled()
        with span("z"):
            pass
    assert not trace.enabled()
    assert [s.name for s in outer] == ["x", "y", "z"]
    assert [s.name for s in inner] == ["y"]


def test_train_step_spans_nest_by_layer(graph):
    est = estimator(graph)
    loop = loop_of(est, 1)
    with recording() as spans:
        loop()
    (top,) = [s for s in spans if s.parent is None]
    assert top.name == "loop"
    (step,) = [s for s in spans if s.name == "step"]
    assert step.parent is top
    assert names_under(spans, step) == ["backward", "forward", "optimizer"]
    (fwd,) = [s for s in spans if s.name == "forward"]
    # the labels' gather, the flow's two hops, the features' gather, two
    # convs and the head
    assert names_under(spans, fwd) == ["conv", "conv", "dataflow", "gather",
                                       "gather", "head"]
    for s in spans:
        assert s.t0_ns <= s.t1_ns and s.thread == threading.get_ident()
        if s.parent is not None:
            assert s.parent.t0_ns <= s.t0_ns <= s.t1_ns <= s.parent.t1_ns
        assert s.request is None


def test_infer_spans_carry_the_request_id(graph):
    est = estimator(graph, batch_size=16)
    assert est.requests == 0
    with recording() as spans:
        est.infer(np.arange(20))               # 2 batches of 16
        est.infer(np.arange(5))
    assert est.requests == 2
    infers = [s for s in spans if s.name == "infer"]
    assert [s.request for s in infers] == [1, 2]
    assert names_under(spans, infers[0]) == [
        "forward", "forward", "infer.d2h", "infer.h2d", "infer.h2d",
        "infer.pad"]
    for s in spans:
        top = s
        while top.parent is not None:
            top = top.parent
        assert top.name == "infer" and s.request == top.request
    assert {s.name for s in spans if s.request == 2} >= {
        "infer", "forward", "dataflow", "gather", "conv", "head"}


def test_every_span_is_a_host_event_of_the_profiler(graph):
    est = estimator(graph)
    loop = loop_of(est, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording() as spans:
            loop()
            est.infer(np.arange(20))
    recorded = collections.Counter(s.name for s in spans)
    seen = collections.Counter(e.name for e in prof.events()
                               if e.name in recorded)
    assert seen == recorded


def test_tracing_changes_no_loss_weight_or_embedding(graph):
    ids = np.arange(40)
    runs = []
    for on in (False, True):
        est = estimator(graph)
        loop = loop_of(est, 3)
        if on:
            with recording() as spans:
                loss = loop()
                emb = est.infer(ids)
            assert spans
        else:
            loss = loop()
            emb = est.infer(ids)
        runs.append((loss, est.model.state_dict(), emb))
    (loss0, w0, e0), (loss1, w1, e1) = runs
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    assert np.array_equal(e0, e1)


def test_profiler_hook_turns_tracing_on_for_its_window(tmp_path):
    out = tmp_path / "prof"
    h = hooks.ProfilerHook(str(out), start=1, steps=1)
    h(0)
    assert not trace.enabled()
    h(1)
    assert trace.enabled()
    with span("hook.window"):
        torch.zeros(4).add_(1)
    h(2)
    assert not trace.enabled()
    (name,) = os.listdir(out)
    with open(out / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "hook.window" for e in events)


def test_a_span_on_another_thread_has_its_own_parents():
    got = []

    def other():
        with span("other") as s:
            got.append(s)
    with recording() as spans:
        with span("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    (o,) = got
    assert o.parent is None and o.thread != threading.get_ident()
    assert {s.name for s in spans} == {"main", "other"}


def test_self_time_is_duration_less_child_cover():
    p = Span("p", t0_ns=0, t1_ns=100)
    a = Span("a", parent=p, t0_ns=10, t1_ns=30)
    b = Span("b", parent=p, t0_ns=20, t1_ns=50)     # overlaps a
    c = Span("a", parent=p, t0_ns=90, t1_ns=120)    # past p's end
    d = Span("d", parent=a, t0_ns=12, t1_ns=18)     # a's child, not p's
    spans = [p, a, b, c, d]
    got = self_times(spans)
    assert got[p] == 100 - (40 + 10)
    assert got[a] == 20 - 6 and got[b] == 30 and got[d] == 6
    only_a = self_times(spans, cover=("a",))
    assert only_a[p] == 100 - (20 + 10)
    lone = Span("q", t0_ns=5, t1_ns=9)
    assert self_times([lone]) == {lone: 4}
