"""The readers of the program's spans (``layer_metrics/_spans.py`` and the
five per-layer metrics built on it) on a trace made by hand: self time
and total time per traced call, and None where the spans are missing.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from dtvbench import run
from dtvbench.layer_metrics import _spans
from dtvbench.tests.test_dtvbench_harness import TINY
from dtvbench.trace import Summary

READERS = ("sizing_ms_per_call.rx", "front_end_host_ms.rx",
           "copy_host_ms_per_call.stream", "host_tail_ms_per_call.stream",
           "graph_host_us_per_call.batched")


def _ev(name: str, ts: float, dur: float, tid: int = 1,
        cat: str = "user_annotation") -> dict:
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "tid": tid,
            "cat": cat}


def _call(t0: float) -> list[dict]:
    """One receive call of 1000 µs at ``t0``: spans nested as the program
    nests them, an aten op and a runtime call inside them (neither is a
    span), and one span on another thread that overlaps the front end."""
    return [
        _ev("dtv.rx.dvbt", t0, 1000),
        _ev("dtv.stream.copy_in", t0 + 5, 95),
        _ev("aten::copy_", t0 + 10, 80, cat="cpu_op"),
        _ev("dtv.sizing", t0 + 100, 20),
        _ev("dtv.rx.front_end", t0 + 120, 300),
        _ev("dtv.sizing", t0 + 150, 30),            # nested: 300 − 30
        _ev("cudaLaunchKernel", t0 + 200, 5, cat="cuda_runtime"),
        _ev("dtv.stream.copy_out", t0 + 200, 50, tid=2),   # other thread
        _ev("dtv.rx.viterbi", t0 + 420, 200),
        _ev("dtv.sizing", t0 + 430, 10),
        _ev("viterbi_acs", t0 + 440, 100),
        _ev("dtv.stream.wait", t0 + 620, 200),
        _ev("dtv.stream.copy_out", t0 + 820, 100),
        _ev("dtv.stream.host", t0 + 920, 80),
        _ev("dtv.graph.call", t0 + 920, 40),        # nested in the host
    ]


def _summary(host: list[dict], calls: int = 2, start: float = 0.0,
             end: float = 2000.0) -> Summary:
    acts = [{"cat": "kernel", "name": "k", "ts": 50.0, "dur": 10.0}]
    return Summary(start=start, end=end, calls=calls, acts=acts, host=host)


def _run(summary) -> SimpleNamespace:
    return SimpleNamespace(summary=summary)


def _reader(name: str):
    return run.load(run.HERE / "layer_metrics" / f"{name}.py")


@pytest.fixture
def traced():
    return _run(_summary(_call(0.0) + _call(1000.0)))


def test_total_time_per_call(traced):
    assert _spans.total_ms(traced, ("dtv.sizing",)) == pytest.approx(0.060)
    assert _spans.total_ms(traced, ("dtv.rx.dvbt",)) == pytest.approx(1.0)


def test_self_time_leaves_out_nested_spans_of_the_same_thread(traced):
    # front end 300 less its sizing 30; the aten op, the runtime call and
    # the other thread's copy do not count as children
    assert _spans.self_ms(traced, ("dtv.rx.front_end",)) == \
        pytest.approx(0.270)
    # the Viterbi's 200 less its sizing 10 (viterbi_acs is no dtv span)
    assert _spans.self_ms(traced, ("dtv.rx.viterbi",)) == pytest.approx(0.190)
    # the host tail 80 less the graph call 40 nested in it
    assert _spans.self_ms(traced, ("dtv.stream.host",)) == \
        pytest.approx(0.040)
    # copy in 95 + copy out 100 on the call's thread + 50 on the other
    assert _spans.self_ms(traced, ("dtv.stream.copy_in",
                                   "dtv.stream.copy_out")) == \
        pytest.approx(0.245)
    # the top span: 1000 less the union of its nested spans
    covered = 95 + 20 + 300 + 200 + 200 + 100 + 80
    assert _spans.self_ms(traced, ("dtv.rx.dvbt",)) == \
        pytest.approx((1000 - covered) / 1e3)


def test_spans_are_clipped_to_the_window():
    s = _summary(_call(0.0), calls=1, start=0.0, end=500.0)
    # the top span counts only its first 500 µs
    assert _spans.total_ms(_run(s), ("dtv.rx.dvbt",)) == pytest.approx(0.5)
    # past the window's end: nothing of the wait, the copy or the host
    assert _spans.total_ms(_run(s), ("dtv.stream.host",)) == 0.0


@pytest.mark.parametrize("name, want", [
    ("sizing_ms_per_call.rx", 0.060),
    ("front_end_host_ms.rx", 0.270),
    ("copy_host_ms_per_call.stream", 0.245),
    ("host_tail_ms_per_call.stream", 0.040),
    ("graph_host_us_per_call.batched", 40.0),
])
def test_reader_reads_its_spans(traced, name, want):
    assert _reader(name).value(traced) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_the_spans(name):
    # the parent's trace: aten ops, runtime calls and the decoders' ranges
    # but no dtv.* span
    host = [e for e in _call(0.0) if not e["name"].startswith("dtv.")]
    assert _reader(name).value(_run(_summary(host))) is None
    assert _reader(name).value(_run(None)) is None


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_rehearsal_reports_the_span_metrics(cell):
    """A traced run of each cell at its tiny size on the CPU reads every
    span metric that BENCHMARK.json lists for the cell."""
    line = run.execute(cell, 2**31 + 16, 0.2, True, device="cpu",
                       overrides=TINY[cell])
    want = {m["name"] for m in run.Cell.find(cell).per_layer
            if m["name"] in READERS}
    assert want
    for name in want:
        assert line["metrics"][name]["value"] >= 0, name
