"""The spans of the port's served path (``dtv_utils_torch/utils/trace.py``)
on the CPU, at small sizes.

One call each of the DVB-T and J.83B receivers, of the DVB-T modulator's
``modulate_stream`` and of a ``StaticCall`` runs under a ``torch.profiler``
session; the exported Chrome trace must hold the call's spans, every one
nested inside the call's one top span, the decoders' ``viterbi_acs`` and
``viterbi_traceback`` ranges inside ``dtv.rx.viterbi``.  With no session,
``span`` never enters ``record_function``.  The receivers get seeded
noise as IQ: the spans do not depend on what the samples hold.
"""

import json

import numpy as np
import pytest
import torch

from dtv_utils_torch.core import config as C
from dtv_utils_torch.ops import viterbi as TV
from dtv_utils_torch.rx import dvbt as RXD
from dtv_utils_torch.rx import j83b as RXJ
from dtv_utils_torch.tx import dvbt as TXD
from dtv_utils_torch.utils import graph
from dtv_utils_torch.utils import trace

CPU = torch.device("cpu")
DVBT = C.DvbtConfig(mode=C.TransmissionMode.M2K, bandwidth_mhz=8,
                    constellation=C.Constellation.QPSK,
                    code_rate=C.CodeRate.R1_2, guard=C.GuardInterval.G1_4)
J83B = C.J83bConfig()
STREAM = ("dtv.stream.copy_in", "dtv.stream.wait", "dtv.stream.copy_out",
          "dtv.stream.host")
RX = STREAM + ("dtv.sizing", "dtv.rx.front_end", "dtv.rx.viterbi",
               "dtv.rx.rs_decode", "dtv.rx.deframe", "viterbi_acs",
               "viterbi_traceback")
GRAPH = ("dtv.graph.call", "dtv.graph.copy_in", "dtv.graph.replay",
         "dtv.graph.copy_out")


def _noise(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64) * np.float32(0.01)


def _ts(n_bytes: int, seed: int) -> np.ndarray:
    ts = np.random.default_rng(seed).integers(0, 256, n_bytes,
                                              dtype=np.uint8)
    ts.reshape(-1, 188)[:, 0] = 0x47
    return ts


def _static_call():
    sc = graph.StaticCall(lambda x: (x * 2, x + 1), (torch.zeros(8),),
                          device=CPU)
    return lambda: sc(torch.arange(8, dtype=torch.float32))


CALLS = {
    "dvbt-rx": (lambda: RXD.demodulate_stream(
        DVBT, _noise(DVBT.symbols_per_superframe
                     * (DVBT.fft_size + DVBT.guard_samples), 1),
        device="cpu"), "dtv.rx.dvbt", RX),
    "j83b-rx": (lambda: RXJ.demodulate_stream(
        J83B, _noise(RXJ.SUPERBLOCK_SAMPLES, 2), device="cpu"),
        "dtv.rx.j83b", RX),
    "dvbt-tx": (lambda: TXD.modulate_stream(
        DVBT, _ts(DVBT.ts_bytes_per_superframe, 3), device="cpu"),
        "dtv.tx.stream", STREAM + GRAPH),
    "static-call": (_static_call(), "dtv.graph.call", GRAPH[1:]),
}


def _traced(fn, path) -> list[dict]:
    """The complete events of ``fn()`` run under a profiler session, as
    its exported Chrome trace holds them."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("traces")
    return {name: _traced(fn, d / f"{name}.json")
            for name, (fn, _, _) in CALLS.items()}


def _named(events, name: str) -> list[dict]:
    return [e for e in events if e["name"] == name]


def _inside(e: dict, outer: dict) -> bool:
    return (e.get("tid") == outer.get("tid") and outer["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("call", sorted(CALLS))
def test_call_records_its_spans_inside_one_top_span(traces, call):
    _, top_name, names = CALLS[call]
    events = traces[call]
    top = _named(events, top_name)
    assert len(top) == 1
    for name in names:
        assert _named(events, name), name
    ours = [e for e in events if e["name"].startswith("dtv.")
            or e["name"] in ("viterbi_acs", "viterbi_traceback")]
    for e in ours:
        assert e is top[0] or _inside(e, top[0]), e["name"]


@pytest.mark.parametrize("call, sizing", [("dvbt-rx", 3), ("j83b-rx", 1)])
def test_receivers_size_their_passes_as_documented(traces, call, sizing):
    assert len(_named(traces[call], "dtv.sizing")) == sizing


@pytest.mark.parametrize("call", ["dvbt-rx", "j83b-rx"])
def test_viterbi_ranges_nest_in_the_receivers_viterbi_span(traces, call):
    events = traces[call]
    (vit,) = _named(events, "dtv.rx.viterbi")
    for name in ("viterbi_acs", "viterbi_traceback"):
        ranges = _named(events, name)
        assert ranges and all(_inside(e, vit) for e in ranges), name


def test_static_call_steps_run_in_order(traces):
    events = traces["static-call"]
    starts = [_named(events, n)[0]["ts"] for n in GRAPH[1:]]
    assert starts == sorted(starts)


def test_wait_comes_before_the_copies_out(traces):
    for call in ("dvbt-rx", "j83b-rx", "dvbt-tx"):
        events = traces[call]
        (wait,) = _named(events, "dtv.stream.wait")
        for e in _named(events, "dtv.stream.copy_out"):
            assert wait["ts"] + wait["dur"] <= e["ts"], call


def test_traced_call_returns_what_an_untraced_one_does(tmp_path):
    ts = _ts(DVBT.ts_bytes_per_superframe, 4)
    want, _ = TXD.modulate_stream(DVBT, ts, device="cpu")
    got = {}
    _traced(lambda: got.update(iq=TXD.modulate_stream(DVBT, ts,
                                                      device="cpu")[0]),
            tmp_path / "tx.json")
    np.testing.assert_array_equal(got["iq"], want)


def test_no_record_function_without_a_session(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    assert not torch.autograd._profiler_enabled()
    with trace.span("dtv.test"):
        pass
    trace.wait(CPU)
    _static_call()()
    TV.viterbi_decode(torch.ones((64, 2)), block=32, overlap=8)
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("dtv.test"):
            pass
    assert entered == ["dtv.test"]
