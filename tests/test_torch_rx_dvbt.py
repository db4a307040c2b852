"""The port's DVB-T receiver (dtv_utils_torch.rx.dvbt, dvbt-rx) against the
JAX reference (dtv_utils_tpu.rx.dvbt), on the CPU.

Each case modulates a seeded TS with the JAX modulator, adds seeded AWGN
where the case says, and gives the same IQ to both receivers:

* QPSK 1/2 GI 1/4 (2K, 6 MHz), clean and at 2.5 dB — tests/test_rx_dvbt.py;
* 64-QAM 7/8 GI 1/32 (2K, 8 MHz), clean and at 20.0 dB, the README's
  operating point for that mode — tests/test_rx_scale.py.

Tolerances: carriers and cells within max|Δ|/rms < 1e-4 (cuFFT/pocketfft
against the reference's matmul DFT; the measured figure is printed), LLRs
within 1e-4 of their largest magnitude.  Exactly equal: pilot phases, the
TPS dict, and on clean input the Viterbi output, TS, ``rs_errors`` and
``rs_ok``.  Under noise both packages must deliver the exact TS with every
``rs_ok`` true; ``rs_errors`` is compared where the bytes into RS are
identical (a sub-ulp FFT difference may flip a near-tie LLR).  The card
is held to the port's CPU in ``tests/test_torch_rx_gpu.py``.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtv_utils_tpu.core import config as JC
from dtv_utils_tpu.models import dvbt_rx as jcli
from dtv_utils_tpu.rx import dvbt as JRX
from dtv_utils_tpu.tx import dvbt as JTX
from dtv_utils_torch.cli import main as tmain
from dtv_utils_torch.core import config as TC
from dtv_utils_torch.models import dvbt_rx as tcli
from dtv_utils_torch.ops import rs_decode as TRS
from dtv_utils_torch.ops import viterbi as TV
from dtv_utils_torch.rx import dvbt as TRX
from dtv_utils_torch.utils import device as tdevice

REL_TOL = 1e-4          # carriers / cells: max|Δ|/rms
LLR_TOL = 1e-4          # LLRs: max|Δ| / max|LLR|

# name -> (mode, MHz, constellation, rate, guard, SNR dB or None)
CASES = {
    "qpsk12_clean": ("M2K", 6, "QPSK", "R1_2", "G1_4", None),
    "qpsk12_2.5dB": ("M2K", 6, "QPSK", "R1_2", "G1_4", 2.5),
    "qam64_78_clean": ("M2K", 8, "QAM64", "R7_8", "G1_32", None),
    "qam64_78_20dB": ("M2K", 8, "QAM64", "R7_8", "G1_32", 20.0),
}
PLAN_CONFIGS = {
    "2k_qpsk12_g4": ("M2K", 6, "QPSK", "R1_2", "G1_4"),
    "2k_qam16_34_g8": ("M2K", 7, "QAM16", "R3_4", "G1_8"),
    "2k_qam64_78_g32": ("M2K", 8, "QAM64", "R7_8", "G1_32"),
    "8k_qam64_78_g32": ("M8K", 8, "QAM64", "R7_8", "G1_32"),
}


def _cfg(C, mode, mhz, cons, rate, guard):
    return C.DvbtConfig(mode=C.TransmissionMode[mode], bandwidth_mhz=mhz,
                        constellation=C.Constellation[cons],
                        code_rate=C.CodeRate[rate],
                        guard=C.GuardInterval[guard])


def _ts(cfg, n_superframes, seed=7):
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, cfg.ts_bytes_per_superframe * n_superframes
                      ).astype(np.uint8)
    ts.reshape(-1, 188)[:, 0] = 0x47
    return ts


def _awgn(iq, snr_db, seed=11):
    rng = np.random.default_rng(seed)
    noise_p = np.mean(np.abs(iq) ** 2) / 10 ** (snr_db / 10)
    noise = (rng.normal(0, np.sqrt(noise_p / 2), len(iq))
             + 1j * rng.normal(0, np.sqrt(noise_p / 2), len(iq))
             ).astype(np.complex64)
    return iq + noise


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.sqrt(np.mean(np.abs(want)
                                                            ** 2)))


@functools.cache
def _iq(name):
    *key, snr = CASES[name]
    jcfg = _cfg(JC, *key)
    ts = _ts(jcfg, 2)
    iq, _ = JTX.modulate_stream(jcfg, ts)
    return ts, (iq if snr is None else _awgn(iq, snr))


@functools.cache
def _run(name):
    """Both receivers on the case's IQ: whole-chain results and the
    intermediate stages (host arrays)."""
    *key, _ = CASES[name]
    jcfg, tcfg = _cfg(JC, *key), _cfg(TC, *key)
    ts, iq = _iq(name)
    pairs = jnp.asarray(np.stack([iq.real, iq.imag], axis=-1))
    j_car, j_cells, j_ph = JRX._jit_front(jcfg)(pairs)
    x = torch.from_numpy(iq)
    t_car = TRX.iq_to_carriers(tcfg, x)
    t_cells = TRX._extract_cells(tcfg, t_car)
    return dict(
        ts=ts,
        jax=JRX.demodulate_stream(jcfg, iq),
        port=TRX.demodulate_stream(tcfg, iq, device="cpu"),
        j_carriers=np.asarray(j_car), t_carriers=t_car.numpy(),
        j_cells=np.asarray(j_cells), t_cells=t_cells.numpy(),
        j_llrs=np.asarray(JRX._cell_bit_llrs(jcfg, j_cells)),
        t_llrs=TRX._cell_bit_llrs(tcfg, t_cells).numpy(),
        j_phases=np.asarray(j_ph),
        t_phases=TRX.detect_symbol_phase(tcfg, t_car).numpy(),
        j_outer=np.asarray(JRX._jit_llrs_to_coded(jcfg)(j_cells)),
        t_outer=TRX.llrs_to_outer_bytes(tcfg, t_cells).numpy())


@pytest.mark.parametrize("name", sorted(PLAN_CONFIGS))
def test_rx_plan_tables_equal(name):
    key = PLAN_CONFIGS[name]
    got = TRX._rx_plan(_cfg(TC, *key))
    want = JRX._rx_plan(_cfg(JC, *key))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("name", sorted(CASES))
def test_carriers_and_cells_close(name):
    r = _run(name)
    car = _rel(r["t_carriers"], r["j_carriers"][..., 0]
               + 1j * r["j_carriers"][..., 1])
    cells = _rel(r["t_cells"], r["j_cells"][:, 0] + 1j * r["j_cells"][:, 1])
    print(f"{name}: carriers max|d|/rms {car:.3e}, cells {cells:.3e}")
    assert car < REL_TOL and cells < REL_TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_llrs_close(name):
    r = _run(name)
    assert r["t_llrs"].shape == r["j_llrs"].shape
    err = np.abs(r["t_llrs"] - r["j_llrs"]).max() / np.abs(r["j_llrs"]).max()
    print(f"{name}: LLR max|d|/max|LLR| {err:.3e}")
    assert err < LLR_TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_phases_and_tps_equal(name):
    r = _run(name)
    np.testing.assert_array_equal(r["t_phases"], r["j_phases"])
    assert r["port"].phase_ok and r["jax"].phase_ok
    assert r["port"].tps == r["jax"].tps
    assert r["port"].tps["all_bch_ok"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ts_and_rs_flags(name):
    """The exact TS in both packages, every packet decodable; the flags
    equal the reference's where the bytes into RS are identical."""
    r = _run(name)
    port, ref = r["port"], r["jax"]
    n = len(port.ts)
    assert n > 0 and n % 188 == 0 and n == len(ref.ts)
    np.testing.assert_array_equal(port.ts, r["ts"][:n])
    np.testing.assert_array_equal(ref.ts, r["ts"][:n])
    assert port.rs_ok.all() and ref.rs_ok.all()
    np.testing.assert_array_equal(port.rs_ok, ref.rs_ok)
    assert port.rs_errors.dtype == np.int32
    if CASES[name][-1] is None:
        np.testing.assert_array_equal(r["t_outer"], r["j_outer"])
        assert port.rs_errors.sum() == 0
    if np.array_equal(r["t_outer"], r["j_outer"]):
        np.testing.assert_array_equal(port.rs_errors, ref.rs_errors)


def _counted(monkeypatch, owner, name):
    fn, n = getattr(owner, name), [0]

    def counting(*args, **kwargs):
        n[0] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(owner, name, counting)
    return n


def test_grouped_front_end_and_passes_equal_one_call(monkeypatch):
    """With 64 MiB of working memory the receiver runs its front end one
    superframe at a time, the Viterbi in several passes and RS in several
    chunks: the TS and every flag equal the one-group call's."""
    want = _run("qam64_78_20dB")["port"]
    cfg = _cfg(TC, *CASES["qam64_78_20dB"][:-1])
    monkeypatch.setattr(tdevice, "CPU_WORKING_BYTES", 64 << 20)
    groups = _counted(monkeypatch, TRX, "_front_end")
    passes = _counted(monkeypatch, TV, "_acs")
    chunks = _counted(monkeypatch, TRS.RsDecoder, "decode_bytes")
    got = TRX.demodulate_stream(cfg, _iq("qam64_78_20dB")[1], device="cpu")
    assert (groups[0], passes[0] >= 2, chunks[0] >= 2) == (2, True, True)
    np.testing.assert_array_equal(got.ts, want.ts)
    np.testing.assert_array_equal(got.rs_errors, want.rs_errors)
    np.testing.assert_array_equal(got.rs_ok, want.rs_ok)
    assert got.phase_ok and got.tps == want.tps


@pytest.mark.parametrize("name", ["qpsk12_2.5dB", "qam64_78_clean"])
def test_decode_tps_equals_jax(name):
    """The public TPS decode on each package's own carriers."""
    r = _run(name)
    key = CASES[name][:-1]
    got = TRX.decode_tps(_cfg(TC, *key), torch.from_numpy(r["t_carriers"]))
    assert got == JRX.decode_tps(_cfg(JC, *key),
                                 jnp.asarray(r["j_carriers"]))
    assert got["all_bch_ok"]


def test_tensor_input_equals_numpy():
    ts, iq = _iq("qpsk12_clean")
    cfg = _cfg(TC, *CASES["qpsk12_clean"][:-1])
    res = TRX.demodulate_stream(cfg, torch.from_numpy(iq), device="cpu")
    np.testing.assert_array_equal(res.ts, _run("qpsk12_clean")["port"].ts)


def test_demodulate_rejects():
    ts, iq = _iq("qpsk12_clean")
    cfg = _cfg(TC, *CASES["qpsk12_clean"][:-1])
    with pytest.raises(ValueError, match="whole superframes"):
        TRX.demodulate_stream(cfg, iq[:-1], device="cpu")
    with pytest.raises(TypeError, match="complex64"):
        TRX.demodulate_stream(cfg, iq.astype(np.complex128), device="cpu")


def _cli_status(out: str) -> dict:
    lines = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    return {rec["metric"]: rec for rec in lines}


CLI_ARGS = ["-m", "t2k", "-c", "6", "-C", "qpsk", "-r", "1/2", "-g", "1/4"]


def test_dvbt_rx_cli_equals_jax_cli(tmp_path, capsys):
    """Same .cfile through both CLIs: the TS bytes and every status field
    equal (throughput excluded)."""
    _, iq = _iq("qpsk12_2.5dB")
    src = tmp_path / "in.cfile"
    iq.tofile(src)
    assert jcli.cli([*CLI_ARGS, "-o", str(tmp_path / "jax.ts"),
                     str(src)]) == 0
    want = _cli_status(capsys.readouterr().out)
    assert tmain.main(["dvbt-rx", *CLI_ARGS, "-o", str(tmp_path / "port.ts"),
                       str(src), "--device", "cpu"]) == 0
    got = _cli_status(capsys.readouterr().out)
    assert (tmp_path / "port.ts").read_bytes() == \
        (tmp_path / "jax.ts").read_bytes()
    assert got["dvbt_rx_status"] == want["dvbt_rx_status"]
    assert got["dvbt_rx_status"]["value"] == 1
    assert got["dvbt_rx_throughput"]["device"] == "cpu"


def test_dvbt_rx_cli_refuses(tmp_path, capsys):
    """A file shorter than one superframe, and CUDA where there is none,
    are errors (exit 255), never a fall-back."""
    src = tmp_path / "short.cfile"
    np.zeros(100, np.complex64).tofile(src)
    assert tcli.cli([*CLI_ARGS, str(src), "--device", "cpu"]) == 255
    if not torch.cuda.is_available():
        assert tcli.cli([*CLI_ARGS, str(src)]) == 255
        assert "is_available" in capsys.readouterr().err


def test_dispatcher_lists_receivers(capsys):
    assert tmain.main(["--help"]) == 0
    tools = capsys.readouterr().err
    assert "dvbt-rx" in tools and "qam-rx" in tools
