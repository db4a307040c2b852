"""The port's DVB-T2 receiver (dtv_utils_torch.rx.dvbt2, dvbt2-rx) against
the JAX reference (dtv_utils_tpu.rx.dvbt2), on the CPU.

Each case modulates a seeded TS with the JAX modulator, adds seeded AWGN
where the case says, and gives the same IQ to both receivers: the
reference's own round trips (tests/test_rx_dvbt2_j83b.py: 3 FEC blocks
over 2 frames, tone reservation, short FEC frames, and the soft path at
14.5 dB).  Both packages must recover the exact TS, with every flag, the
L1 dicts and S1/S2 equal.  The host plan is pinned key for key; the
carrier grid after the FFT is held within max|Δ|/rms < 1e-4 (cuFFT or
pocketfft against the reference's matmul DFT).  The card is held to the
port's CPU in ``tests/test_torch_rx_gpu.py``.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtv_utils_tpu.core import config as JC
from dtv_utils_tpu.models import rx_cli as jcli
from dtv_utils_tpu.rx import dvbt2 as JRX
from dtv_utils_tpu.tx import dvbt2 as JTX
from dtv_utils_tpu.tx import t2_p1 as jp1
from dtv_utils_torch.cli import main as tmain
from dtv_utils_torch.core import config as TC
from dtv_utils_torch.models import rx_cli as tcli
from dtv_utils_torch.models.dvbt2 import PROFILES
from dtv_utils_torch.rx import dvbt2 as TRX
from dtv_utils_torch.tx import dvbt2 as TTX

GRID_TOL = 1e-4          # carrier grid: max|Δ|/rms

CONFIGS = {
    "blocks3": dict(fec_blocks=3, ti_blocks=2),
    "blocks3_tr": dict(fec_blocks=3, ti_blocks=2, papr_tr=True),
    "short": dict(frame_size="SHORT", fec_blocks=2, ti_blocks=1),
}
# name -> (config, frames, TS seed, SNR dB or None); tests/test_rx_dvbt2_j83b
CASES = {
    "hard_2frames": ("blocks3", 2, 3, None),
    "hard_tr": ("blocks3_tr", 1, 4, None),
    "hard_short": ("short", 1, 5, None),
    "soft_14.5dB": ("blocks3", 1, 6, 14.5),
}


def _cfg(C, name):
    kw = dict(CONFIGS[name])
    if "frame_size" in kw:
        kw["frame_size"] = C.T2FrameSize[kw["frame_size"]]
    return C.Dvbt2Config(**kw)


def _ts(cfg, n_frames, seed):
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, cfg.payload_bytes_per_frame * n_frames
                      ).astype(np.uint8)
    ts[0::188] = 0x47
    return ts


def _awgn(iq, snr_db, seed=7):
    rng = np.random.default_rng(seed)
    npow = np.mean(np.abs(iq) ** 2) / 10 ** (snr_db / 10)
    return iq + (rng.normal(0, np.sqrt(npow / 2), len(iq))
                 + 1j * rng.normal(0, np.sqrt(npow / 2), len(iq))
                 ).astype(np.complex64)


@functools.cache
def _iq(case):
    name, frames, seed, snr = CASES[case]
    jcfg = _cfg(JC, name)
    ts = _ts(jcfg, frames, seed)
    iq, _ = JTX.modulate_stream(jcfg, ts)
    return ts, (iq if snr is None else _awgn(iq, snr))


@functools.cache
def _run(case):
    name, _, _, snr = CASES[case]
    ts, iq = _iq(case)
    soft = snr is not None
    return (ts, JRX.demodulate_stream(_cfg(JC, name), iq, soft=soft),
            TRX.demodulate_stream(_cfg(TC, name), iq, soft=soft,
                                  device="cpu"))


def _assert_equal_results(port, ref, ts):
    assert len(port.ts) > 0 and len(port.ts) == len(ref.ts)
    np.testing.assert_array_equal(port.ts, ts[:len(port.ts)])
    np.testing.assert_array_equal(ref.ts, ts[:len(ref.ts)])
    for f in ("ldpc_ok", "bch_ok", "bb_crc_ok"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)
        assert getattr(port, f).dtype == bool and getattr(port, f).all(), f
    assert (port.s1, port.s2) == (ref.s1, ref.s2)
    assert port.l1_pre == ref.l1_pre and port.l1_post == ref.l1_post
    assert port.p1_detected == ref.p1_detected
    assert port.sync_crc_ok and ref.sync_crc_ok


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rx_plan_equal(name):
    got = TRX._rx_plan(_cfg(TC, name))
    want = JRX._rx_plan(_cfg(JC, name))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_frame_to_grid_close():
    ts, iq = _iq("hard_2frames")
    jcfg, tcfg = _cfg(JC, "blocks3"), _cfg(TC, "blocks3")
    body = iq[2048:TTX.samples_per_frame(tcfg)]
    want = np.asarray(JRX._frame_to_grid(
        jcfg, jnp.asarray(np.stack([body.real, body.imag], -1))))
    want = want[..., 0] + 1j * want[..., 1]
    got = TRX._frame_to_grid(tcfg, torch.from_numpy(body)).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    rel = np.abs(got - want).max() / np.sqrt(np.mean(np.abs(want) ** 2))
    print(f"grid max|d|/rms {rel:.3e}")
    assert rel < GRID_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_roundtrip_equals_jax(case):
    ts, port, ref = _run(case)
    _assert_equal_results(port, ref, ts)
    assert port.ldpc_ok.shape == (CASES[case][1],
                                  _cfg(TC, CASES[case][0]).fec_blocks)


def test_roundtrip_l1_fields():
    """The L1 parse matches the transmit config (64-QAM rate 2/3 rotated,
    S2 = 4K)."""
    _, port, _ = _run("hard_2frames")
    cfg = _cfg(TC, "blocks3")
    assert port.p1_detected and (port.s1, port.s2) == (0, 2 << 1)
    assert port.l1_pre["crc_ok"] and port.l1_post["crc_ok"]
    assert port.l1_pre["pilot_pattern"] == cfg.pilot_pattern.number
    assert port.l1_pre["num_data_symbols"] == cfg.data_symbols
    assert (port.l1_post["plp_mod"], port.l1_post["plp_cod"],
            port.l1_post["plp_rotation"]) == (2, 2, 1)
    assert port.l1_post["plp_num_blocks_max"] == cfg.fec_blocks


def test_demap_stages():
    """On the 14.5 dB input: the soft path's LLRs are finite float32 per
    FEC-frame bit, the hard path's words int32 in the constellation."""
    ts, iq = _iq("soft_14.5dB")
    tcfg = _cfg(TC, "blocks3")
    body = torch.from_numpy(iq[2048:TTX.samples_per_frame(tcfg)])
    _, cells = TRX._cells(tcfg, body)
    llr = TRX.soft_llrs(tcfg, cells)
    assert llr.shape == (tcfg.fec_blocks, tcfg.nldpc)
    assert llr.dtype == torch.float32 and torch.isfinite(llr).all()
    words = TRX.hard_words(tcfg, cells)
    assert words.dtype == torch.int32
    assert int(words.min()) >= 0 and int(words.max()) < 64


def test_decode_s1_s2_equal():
    for s1, s2 in [(0, 0), (0, 2), (0, 10), (1, 5), (7, 15)]:
        p1 = jp1.p1_time(s1, s2)
        assert TRX.decode_s1_s2(p1) == JRX.decode_s1_s2(p1) == (s1, s2)


def test_acquire_equals_jax():
    """A capture that starts 777 samples before the stream: both find the
    P1 and decode the frame exactly."""
    ts, iq = _iq("hard_2frames")
    lead = (np.random.default_rng(8).normal(0, 0.01, (777, 2))
            .astype(np.float32).view(np.complex64)[:, 0])
    cap = np.concatenate([lead, iq])
    jcfg, tcfg = _cfg(JC, "blocks3"), _cfg(TC, "blocks3")
    ref = JRX.demodulate_stream(jcfg, cap, acquire=True)
    port = TRX.demodulate_stream(tcfg, cap, acquire=True, device="cpu")
    _assert_equal_results(port, ref, ts)
    port_t = TRX.demodulate_stream(tcfg, torch.from_numpy(cap),
                                   acquire=True, device="cpu")
    np.testing.assert_array_equal(port_t.ts, port.ts)


def test_mode_adaptation_undo_flags_a_bad_crc():
    """A changed sync byte breaks the chain (and is restored to 0x47)."""
    cfg = _cfg(TC, "short")
    ts = _ts(cfg, 1, seed=5)
    ok_ts, ok = TRX.undo_mode_adaptation(cfg, _adapted(cfg, ts))
    assert ok and np.array_equal(ok_ts, ts)
    bad = _adapted(cfg, ts)
    bad[188 * 3] ^= 1
    bad_ts, ok = TRX.undo_mode_adaptation(cfg, bad)
    assert not ok and np.array_equal(bad_ts, ts)


def _adapted(cfg, ts):
    """The transmitter's data field: each sync byte replaced by the CRC-8
    of the 187 bytes before it (tx/dvbt2.mode_adapt)."""
    bb, _ = TTX.mode_adapt(cfg, torch.from_numpy(ts),
                           TTX.init_state(cfg, device="cpu"))
    data = bb[:, 80:].reshape(-1)
    return data.reshape(-1, 8).numpy().dot(1 << np.arange(7, -1, -1)
                                           ).astype(np.uint8)


def test_demodulate_rejects():
    ts, iq = _iq("hard_short")
    cfg = _cfg(TC, "short")
    with pytest.raises(ValueError, match="at least one frame"):
        TRX.demodulate_stream(cfg, iq[:1000], device="cpu")
    with pytest.raises(TypeError, match="complex64"):
        TRX.demodulate_stream(cfg, iq.astype(np.complex128), device="cpu")


def _cli_status(out: str) -> dict:
    lines = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    return {rec["metric"]: rec for rec in lines}


def test_dvbt2_rx_cli_equals_jax_cli(tmp_path, capsys):
    """One blade frame through both CLIs: the TS bytes and every status
    field equal (throughput excluded)."""
    cfg = PROFILES["blade"]
    ts = _ts(cfg, 1, seed=9)
    iq, _ = TTX.modulate_stream(cfg, ts, device="cpu")
    src = tmp_path / "in.cfile"
    iq.tofile(src)
    assert jcli.dvbt2_rx_cli(["-o", str(tmp_path / "jax.ts"),
                              str(src)]) == 0
    want = _cli_status(capsys.readouterr().out)
    assert tmain.main(["dvbt2-rx", "-o", str(tmp_path / "port.ts"), str(src),
                       "--device", "cpu"]) == 0
    got = _cli_status(capsys.readouterr().out)
    assert (tmp_path / "port.ts").read_bytes() == \
        (tmp_path / "jax.ts").read_bytes() == ts.tobytes()
    assert got["dvbt2_rx_status"] == want["dvbt2_rx_status"]
    assert got["dvbt2_rx_status"]["value"] == 1
    assert got["dvbt2_rx_throughput"]["device"] == "cpu"
    assert got["dvbt2_rx_throughput"]["includes_setup"] is True


def test_dvbt2_rx_cli_refuses(tmp_path, capsys):
    """A file shorter than one frame, and CUDA where there is none, are
    errors (exit 255), never a fall-back."""
    src = tmp_path / "short.cfile"
    np.zeros(100, np.complex64).tofile(src)
    assert tcli.dvbt2_rx_cli([str(src), "--device", "cpu"]) == 255
    if not torch.cuda.is_available():
        assert tcli.dvbt2_rx_cli([str(src)]) == 255
        assert "is_available" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tcli.dvbt2_rx_cli(["--profile", "nope", str(src)])
