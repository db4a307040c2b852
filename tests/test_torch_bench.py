"""The port's bench (dtv_utils_torch/bench.py) on the CPU.

* The fail-open loop, as ``tests/test_bench_failopen.py`` pins it for
  ``bench.py``: the metric is emitted after the warm-up and the FIRST timed
  segment, every refinement re-emits, an expired deadline never suppresses
  the first line, and ``main`` counts the metrics that printed nothing.
* Parity of shapes with ``bench.py`` (loaded by path; it imports only
  NumPy at top level, and JAX inside each bench): each bench's
  ``_deadline_segments`` call is captured in both modules, and the metric
  name, samples per round, rounds per segment, floor, unit and launch size
  must agree; the TS inputs of DVB-T, J.83B and DVB-T2 must be bench.py's
  byte for byte.
* DVB-T and DVB-T2 end to end at small configs, one launch's IQ within
  max|Δ|/rms < 1e-4 of the JAX package's (the port's FFT is pocketfft, the
  reference's a float32 matmul DFT: 4.5e-6 measured for DVB-T), and PAPR at
  4096 complex.
* No fallback: the default device is the card, and without one a bench
  prints no metric and runs nothing on the CPU.
"""

import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dtv_utils_tpu.core import config as jconfig
from dtv_utils_tpu.parallel import stream as JS
from dtv_utils_tpu.tx import dvbt as jtxd
from dtv_utils_torch import bench
from dtv_utils_torch.core.config import (CodeRate, Constellation,
                                         Dvbt2Config, DvbtConfig,
                                         GuardInterval, TransmissionMode)
from dtv_utils_torch.parallel import stream as S
from dtv_utils_torch.tx import dvbt as txd

ROOT = Path(__file__).resolve().parents[1]
IQ_REL = 1e-4                       # max|Δ|/rms, port vs reference IQ
ROUNDS_COMPARED = 3                 # TS rounds held to bench.py's

DVBT_SMALL = DvbtConfig(mode=TransmissionMode.M2K, bandwidth_mhz=8,
                        constellation=Constellation.QPSK,
                        code_rate=CodeRate.R1_2, guard=GuardInterval.G1_32)
T2_SMALL = Dvbt2Config(fec_blocks=3, ti_blocks=2)


def _load_reference_bench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _CollectMetrics:
    def __init__(self):
        self.records = []

    def emit(self, metric, value, unit="", **extra):
        self.records.append({"metric": metric, "value": value,
                             "unit": unit, **extra})


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max()
                 / np.sqrt(np.mean(np.abs(want) ** 2)))


# ---------------------------------------------------------------------------
# The fail-open loop
# ---------------------------------------------------------------------------

def _run(deadline_offset, monkeypatch, max_segments=None):
    if max_segments is not None:
        monkeypatch.setattr(bench, "MAX_SEGMENTS", max_segments)
    m = _CollectMetrics()

    def fn(x, st):
        return x * 2.0, st

    def make_round(r):
        return [torch.full((4,), float(r))]

    bench._deadline_segments(
        m, "fake_metric", fn, make_round, [None],
        samples_per_round=1_000_000, rounds_per_segment=1, floor=1.0,
        deadline=time.perf_counter() + deadline_offset, device="cpu")
    return m.records


def test_emits_after_first_segment_even_with_expired_deadline(monkeypatch):
    recs = _run(-100.0, monkeypatch)
    assert len(recs) == 1
    assert recs[0]["segments_completed"] == 1
    assert recs[0]["quality"] == "provisional"
    assert recs[0]["value"] > 0
    assert recs[0]["device"] == "cpu" and recs[0]["tf32"] is False


def test_refines_and_reemits_with_time_available(monkeypatch):
    recs = _run(300.0, monkeypatch, max_segments=3)
    assert [r["segments_completed"] for r in recs] == [1, 2, 3]
    assert recs[0]["quality"] == "provisional"
    assert recs[-1]["quality"] == "final"
    assert len(recs[-1]["runs"]) == 3


def test_stress_mode_counts_missing_metrics():
    # every child either dies at resolve_device("cuda") (no card here) or
    # is killed at its 3 s budget: all 4 missing, and main does not raise
    missing = bench.main({name: 3.0 for name in bench.ORDER})
    assert missing == len(bench.ORDER)


# ---------------------------------------------------------------------------
# Parity of shapes and inputs with bench.py
# ---------------------------------------------------------------------------

def _capture(monkeypatch, module) -> dict:
    got = {}

    def fake(metrics, name, fn, make_round_inputs, states, samples_per_round,
             rounds_per_segment, floor, deadline, **kw):
        got.update(name=name, make=make_round_inputs, streams=len(states),
                   samples=samples_per_round, rounds=rounds_per_segment,
                   floor=floor, unit=kw.get("unit", "Msamples/s/chip"),
                   scale=kw.get("scale", 1e6),
                   blocks=kw.get("blocks_per_dispatch"))
    monkeypatch.setattr(module, "_deadline_segments", fake)
    return got


@pytest.mark.parametrize("name", ["dvbt", "papr", "j83b", "dvbt2"])
def test_shapes_and_inputs_match_reference_bench(name, monkeypatch):
    monkeypatch.delenv("DTV_BENCH_BLOCKS", raising=False)
    ref = _load_reference_bench()
    want = _capture(monkeypatch, ref)
    getattr(ref, "bench_" + name)(None, 0.0)
    got = _capture(monkeypatch, bench)
    bench.BENCHES[name](None, 0.0, device="cpu")
    assert got["name"] == want["name"] == bench.METRIC_OF[name] \
        == ref.METRIC_OF[name]
    for key in ("streams", "samples", "rounds", "floor", "unit", "scale",
                "blocks"):
        assert got[key] == want[key], key
    if name == "j83b":
        assert got["samples"] == 4 * 3_612_420
    if name == "papr":       # chunks come from seeded generators, not TS
        return
    for r in range(ROUNDS_COMPARED):
        mine, theirs = got["make"](r), want["make"](r)
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert a.dtype == torch.uint8 and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_papr_chunks_are_distinct_and_seeded(monkeypatch):
    got = _capture(monkeypatch, bench)
    bench.bench_papr(None, 0.0, device="cpu", n_complex=4096)
    a, b, a2 = got["make"](0)[0], got["make"](1)[0], got["make"](0)[0]
    assert a.shape == (2 * 4096,) and a.dtype == torch.float32
    assert not torch.equal(a, b)
    assert torch.equal(a, a2)


# ---------------------------------------------------------------------------
# End to end on the CPU
# ---------------------------------------------------------------------------

def _spy(monkeypatch, module, attr, calls):
    real = getattr(module, attr)

    def spy(*args):
        out = real(*args)
        calls.append((args, out))
        return out
    monkeypatch.setattr(module, attr, spy)


def test_bench_dvbt_cpu_matches_jax(monkeypatch):
    calls, m = [], _CollectMetrics()
    _spy(monkeypatch, txd, "modulate_superframe", calls)
    bench.bench_dvbt(m, time.perf_counter() - 1, device="cpu",
                     cfg=DVBT_SMALL)
    assert len(calls) == bench.N_STREAMS * (1 + 4)   # warm-up + 1 segment
    (rec,) = m.records
    assert rec["metric"] == "dvbt_8k_qam64_r78_iq_throughput"
    assert rec["unit"] == "Msamples/s/chip" and rec["value"] > 0
    assert rec["blocks_per_dispatch"] == 1 and rec["streams"] == 4
    assert rec["device"] == "cpu" and rec["segments_completed"] == 1
    (_, ts, state), (iq, _) = calls[0]
    assert txd.state_to_numpy(state)["packet_phase"] == 0
    jcfg = jconfig.DvbtConfig(
        mode=jconfig.TransmissionMode.M2K, bandwidth_mhz=8,
        constellation=jconfig.Constellation.QPSK,
        code_rate=jconfig.CodeRate.R1_2, guard=jconfig.GuardInterval.G1_32)
    want, _ = jax.jit(lambda t, s: jtxd.modulate_superframe(jcfg, t, s))(
        ts.numpy(), jtxd.init_state(jcfg))
    want = np.asarray(want)                             # rails [2, n]
    assert _rel(iq.numpy(), want[0] + 1j * want[1]) < IQ_REL


def test_bench_dvbt2_cpu_matches_jax(monkeypatch):
    calls, m = [], _CollectMetrics()
    real = S._batched_dvbt2_modulator

    def factory(cfg, *, device):
        run = real(cfg, device=device)

        def spy(blocks, prev_tail, start_idx):
            out = run(blocks, prev_tail, start_idx)
            calls.append((blocks, prev_tail, start_idx, out))
            return out
        return spy
    monkeypatch.setattr(S, "_batched_dvbt2_modulator", factory)
    bench.bench_dvbt2(m, time.perf_counter() - 1, device="cpu",
                      cfg=T2_SMALL, n_blocks=2)
    assert len(calls) == 2                          # warm-up + 1 segment
    (rec,) = m.records
    assert rec["metric"] == "dvbt2_32k_bbc_iq_throughput"
    assert rec["unit"] == "Msamples/s/chip" and rec["value"] > 0
    assert rec["blocks_per_dispatch"] == 2 and rec["streams"] == 1
    blocks, prev_tail, start_idx, iq = calls[1]
    assert prev_tail is None and start_idx == 0 and blocks.shape[0] == 2
    run, sharding = JS.sharded_dvbt2_modulator(
        jconfig.Dvbt2Config(fec_blocks=3, ti_blocks=2),
        JS.make_mesh(jax.devices()[:1]))
    want = np.asarray(run(jax.device_put(blocks.numpy(), sharding)))
    assert _rel(iq.numpy(), want[:, 0] + 1j * want[:, 1]) < IQ_REL  # [L, 2, n]


def test_bench_papr_cpu():
    m = _CollectMetrics()
    bench.bench_papr(m, time.perf_counter() - 1, device="cpu",
                     n_complex=4096)
    (rec,) = m.records
    assert rec["metric"] == "papr_scan_throughput"
    assert rec["unit"] == "GSa/s/chip" and rec["value"] > 0
    assert rec["vs_baseline"] == rec["value"]      # floor 1 GSa/s
    assert rec["device"] == "cpu"


# ---------------------------------------------------------------------------
# No fallback to the CPU
# ---------------------------------------------------------------------------

def test_cuda_without_card_prints_no_metric():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    m = _CollectMetrics()
    with pytest.raises(RuntimeError, match="is_available"):
        bench.bench_dvbt(m, time.perf_counter() + 60, cfg=DVBT_SMALL)
    assert m.records == []
    res = subprocess.run(
        [sys.executable, "-m", "dtv_utils_torch.bench", "--inproc", "dvbt",
         "60"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert not [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert "is_available" in res.stderr
    assert "warm" not in res.stderr
