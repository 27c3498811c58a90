"""head_ms.train at a CPU size: the traced eager steps hold the head's two
spans (the program has ``head.backward``) and launch no kernel, so the
reader reads None; a program without the span recorder reads None; the
metric is the sum of the spans there are, so a program without
``head.backward`` reads ``head`` alone."""
from types import SimpleNamespace as NS

import pytest

from benchmark.harness import drive as drive_lib
from benchmark.harness import head_trace, runner, spans


def context(spec, workload, seed=3):
    w = spec.workload(workload)
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    system = spec.config_module(w["config"]).build(cfg, seed, "cpu")
    drv = drive_lib.make(spec, mix, system, seed)
    drv.setup()
    return runner.Context(spec=spec, workload=w, cfg=cfg, mix=mix,
                          system=system, drive=drv, window={}, trace=None,
                          device="cpu")


@pytest.mark.parametrize("workload", ["sage-train", "gcn-train"])
def test_head_reader_at_a_cpu_size(small_spec, workload, capsys):
    assert "head_ms.train" in [m["name"]
                               for m in small_spec.per_layer(workload)]
    ctx = context(small_spec, workload)
    assert small_spec.metric_reader("head_ms.train").read(ctx) is None
    assert set(ctx.__dict__["_head_trace"]) == {"head", "head.backward"}
    assert "2 of 2 spans present" in capsys.readouterr().err


def test_a_program_without_spans_reads_none(small_spec, monkeypatch):
    monkeypatch.setattr(spans, "port_trace", lambda: None)
    ctx = context(small_spec, "sage-train")
    assert small_spec.metric_reader("head_ms.train").read(ctx) is None


def test_the_metric_sums_the_spans_there_are():
    ctx = NS(_head_trace={"head": 9.5, "head.backward": 0.0})
    assert head_trace.head_ms(ctx) == 9.5
    ctx = NS(_head_trace={"head": 0.25, "head.backward": 1.5})
    assert head_trace.head_ms(ctx) == 1.75
