"""The span metrics: a kernel's device time goes to the spans whose
annotations hold the host call that launched it (by correlation id, then by
time, whatever the thread), and the readers run at a CPU size, where the
device metrics read None (no kernels) and the host metrics read numbers.
A program without the span recorder gives None everywhere."""
import math
from types import SimpleNamespace as NS

import pytest

from benchmark.harness import drive as drive_lib
from benchmark.harness import runner, spans
from benchmark.harness.trace import WINDOW

CUDA, CPU = "cuda", "cpu"


def ev(name, start, end, kind=CPU, id=0, thread=1, annotation=False):
    return NS(name=name, id=id, device_type=kind, thread=thread,
              is_user_annotation=annotation,
              time_range=NS(start=start, end=end))


def synthetic():
    """One eager step on the profiler's clock (us): the forward on thread
    1, the backward's kernels launched from autograd's thread 2 while
    thread 1 waits inside ``backward``, a root draw launched before the
    step, and a kernel whose launch the trace lost."""
    host = [ev(WINDOW, 0, 300),
            ev("step", 20, 200), ev("forward", 22, 100),
            ev("dataflow", 25, 40), ev("gather", 41, 50),
            ev("conv", 51, 70), ev("conv", 71, 90), ev("head", 91, 99),
            ev("backward", 101, 170), ev("optimizer", 171, 199),
            # a torch op: its id is no runtime call's, whatever its value
            ev("aten::mm", 52, 60, id=7)]
    launches = [(1, 10, 1), (2, 30, 1), (3, 45, 1), (4, 55, 1), (5, 75, 1),
                (6, 95, 1), (7, 120, 2), (8, 150, 2), (10, 180, 1),
                (11, 250, 1)]
    host += [ev("cudaLaunchKernel", t, t + 3, id=i, thread=th)
             for i, t, th in launches]
    durs = {1: 4.0, 2: 5.0, 3: 6.0, 4: 7.0, 5: 8.0, 6: 9.0, 7: 10.0,
            8: 11.0, 10: 12.0, 11: 13.0, 12: 14.0}
    dev = [ev(f"kernel{i}", 300 + 20 * i, 300 + 20 * i + d, CUDA, id=i)
           for i, d in durs.items()]
    # the card's copy of an annotation, as older profilers leave it
    dev.append(ev("forward", 22, 100, CUDA, id=0))
    return host + dev


def test_kernels_go_to_the_span_of_their_launch():
    got = spans.reduce(synthetic(), CUDA)
    kernels = got.kernels()
    assert len(kernels) == 11            # the annotation's copy is no work
    assert sum(1 for t, _ in kernels if t is None) == 1      # kernel12
    us = spans.device_us(kernels, got.marks, spans.TRAIN_SPANS + (
        "forward", "head", "step"))
    assert us == {"dataflow": 5.0, "gather": 6.0, "conv": 7.0 + 8.0,
                  "backward": 10.0 + 11.0, "optimizer": 12.0,
                  "forward": 5.0 + 6.0 + 7.0 + 8.0 + 9.0, "head": 9.0,
                  "step": 5.0 + 6.0 + 7.0 + 8.0 + 9.0 + 10.0 + 11.0 + 12.0}
    # the root draw (launched at 10) and kernel11 (at 250) are in no span
    launched = [t for t, _ in kernels if t is not None]
    step = got.marks["step"]
    outside = [t for t in launched if not spans.inside([(t, 1.0)], step)]
    assert outside == [10, 250]


def test_idle_inside_a_span():
    events = [ev(WINDOW, 0, 100), ev("forward", 10, 30),
              ev("forward", 50, 90),
              ev("k", 20, 40, CUDA, id=1), ev("k", 60, 70, CUDA, id=2)]
    got = spans.reduce(events, CUDA)
    idle, inside_fwd, busy_ms = spans.idle_inside(got, "forward")
    assert idle == pytest.approx(70.0)
    # idle and inside forward: [10, 20), [50, 60) and [70, 90)
    assert inside_fwd == pytest.approx(40.0)
    assert busy_ms == pytest.approx(0.03)
    assert spans.overlap([(0, 5), (10, 20)], [(3, 12), (15, 30)]) == 9


METRICS = {"sage-train": ["dataflow_ms.train", "gather_ms.train",
                          "conv_ms.train", "backward_ms.train",
                          "optimizer_ms.train"],
           "sage-infer": ["serve_self_ms.infer", "forward_host_ms.infer",
                          "forward_idle.infer"]}
METRICS["gcn-train"] = METRICS["sage-train"]
HOST = {"serve_self_ms.infer", "forward_host_ms.infer"}


def context(spec, workload, seed=3):
    w = spec.workload(workload)
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    system = spec.config_module(w["config"]).build(cfg, seed, "cpu")
    drv = drive_lib.make(spec, mix, system, seed)
    drv.setup()
    return runner.Context(spec=spec, workload=w, cfg=cfg, mix=mix,
                          system=system, drive=drv, window={}, trace=None,
                          device="cpu")


@pytest.mark.parametrize("workload", sorted(METRICS))
def test_readers_at_a_cpu_size(small_spec, workload):
    names = METRICS[workload]
    assert names == [m["name"] for m in small_spec.per_layer(workload)
                     if m["source"] == "program_span" and m["name"] in names]
    ctx = context(small_spec, workload)
    for name in names:
        value = small_spec.metric_reader(name).read(ctx)
        if name in HOST:
            assert value > 0 and math.isfinite(value), name
        else:
            assert value is None, name
    if workload == "sage-infer":
        # the warm requests, then the readers' two runs of the traced ones
        assert ctx.system.est.requests == ctx.mix["warm_requests"] + \
            2 * ctx.mix["trace_requests"]


@pytest.mark.parametrize("workload", ["sage-train", "sage-infer"])
def test_a_program_without_spans_reads_none(small_spec, workload,
                                            monkeypatch):
    monkeypatch.setattr(spans, "port_trace", lambda: None)
    ctx = context(small_spec, workload)
    for name in METRICS[workload]:
        assert small_spec.metric_reader(name).read(ctx) is None
