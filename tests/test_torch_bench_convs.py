"""The port's bench in the eight conv modes added to bench.py's four
(tag, sgcn, agnn, appnp, graph, arma, dna, gated), at its off-card sizes
on the CPU: each prints bench.py's three JSON lines (warmup, single_loop,
pipelined) with a finite loss, and counts no kernel launch (the CPU runs
the kernels' plain versions). The model it trains is the reference's conv
at its defaults (tests/test_torch_models_more.py holds each against
euler_tpu).
"""
import json

import pytest

from euler_tpu_torch import bench
from euler_tpu_torch.ops import fan_draw as fd
from euler_tpu_torch.ops import gather_rows as gr


@pytest.mark.parametrize("model", bench.CONV_MODES)
def test_bench_prints_bench_py_lines_on_the_cpu(model):
    lines = []
    before = (fd.fan_draw.launches, gr.gather_rows.launches)
    records = bench.run("cpu", log=lines.append, model=model)
    # the CPU runs the plain versions: no launch is counted
    assert (fd.fan_draw.launches, gr.gather_rows.launches) == before
    out = [json.loads(s) for s in lines if s.startswith("{")]
    assert [r["phase"] for r in out] == ["warmup", "single_loop",
                                         "pipelined"]
    for r in out:
        assert set(r) == {"metric", "model", "value", "unit", "vs_baseline",
                          "platform", "phase", "config"}
        assert r["model"] == model and r["platform"] == "cpu"
        assert r["metric"] == "sampled_aggregate_edges_per_sec_per_chip"
        assert r["config"] == "b256_f25x10_n5000" and r["value"] > 0
        assert r["vs_baseline"] is None
    assert len(records) == 3 and all(r["ms_per_step"] > 0 for r in records)


def test_every_registry_conv_but_gcn_is_a_sampled_mode():
    from euler_tpu_torch.models import convs
    modes = set(bench.SAMPLED) | {"gcn"}
    assert {c.__name__ for n, c in convs._CONVS.items() if n in modes} == {
        c.__name__ for c in convs._CONVS.values()}
