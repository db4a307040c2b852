"""The port's J.83B receiver (dtv_utils_torch.rx.j83b, qam-rx) against the
JAX reference (dtv_utils_tpu.rx.j83b), on the CPU, at one full superblock.

One seeded superblock is modulated by the JAX modulator (as
tests/test_rx_dvbt2_j83b.py does) and given, clean and at 27 dB, to both
receivers.  Exactly equal: the matched-filter plan, the demapped words on
clean input, the trellis decode on identical words, and the TS and every
flag (clean and at 27 dB); the TS must also equal the input.  The card is
held to the port's CPU in ``tests/test_torch_rx_gpu.py``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtv_utils_tpu.core.config import J83bConfig as JConfig
from dtv_utils_tpu.models import rx_cli as jcli
from dtv_utils_tpu.rx import j83b as JRX
from dtv_utils_tpu.tx import j83b as JTX
from dtv_utils_torch.cli import main as tmain
from dtv_utils_torch.core.config import J83bConfig
from dtv_utils_torch.rx import j83b as TRX

FLAGS = ("rs_ok", "rs_errors", "ext_ok", "checksum_ok")


@pytest.fixture(scope="module")
def loop():
    """One superblock of seeded TS, its JAX IQ, that IQ at 27 dB, and both
    receivers' results on each."""
    rng = np.random.default_rng(5)
    ts = rng.integers(0, 256, JTX.PACKETS_PER_SUPERBLOCK * 188
                      ).astype(np.uint8)
    ts.reshape(-1, 188)[:, 0] = 0x47
    iq, _ = JTX.modulate_stream(JConfig(), ts)
    noise_rng = np.random.default_rng(9)
    npow = np.mean(np.abs(iq) ** 2) / 10 ** (27.0 / 10)
    noisy = iq + (noise_rng.normal(0, np.sqrt(npow / 2), len(iq))
                  + 1j * noise_rng.normal(0, np.sqrt(npow / 2), len(iq))
                  ).astype(np.complex64)
    out = dict(ts=ts, iq=iq)
    for key, x in (("clean", iq), ("awgn", noisy)):
        out[key] = (JRX.demodulate_stream(JConfig(), x),
                    TRX.demodulate_stream(J83bConfig(), x, device="cpu"))
    return out


def test_mf_plan_equal():
    got, want = TRX._mf_plan(J83bConfig()), JRX._mf_plan(JConfig())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["off"] == 0 and got["isi"] < 0.02
    assert got["taps"].dtype == np.float32


def test_words_equal_on_clean_iq(loop):
    iq = loop["iq"]
    want = np.asarray(JRX._jit_front(JConfig(), len(iq))(
        jnp.asarray(np.stack([iq.real, iq.imag], axis=-1))))
    got = TRX.front(J83bConfig(), torch.from_numpy(iq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_trellis_decode_equal(loop):
    """Identical words (with symbol errors injected, so the two Viterbi
    decoders have work to do) give identical frame bits."""
    iq = loop["iq"]
    words = np.asarray(JRX._jit_front(JConfig(), len(iq))(
        jnp.asarray(np.stack([iq.real, iq.imag], axis=-1))))
    rng = np.random.default_rng(12)
    hit = rng.choice(len(words), 2000, replace=False)
    words = words.copy()
    words[hit] ^= rng.integers(1, 64, 2000).astype(words.dtype)
    want = np.asarray(JRX._jit_trellis_decode(len(words))(jnp.asarray(words)))
    got = TRX.trellis_decode(torch.from_numpy(words)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["clean", "awgn"])
def test_ts_and_flags_equal(loop, case):
    ref, port = loop[case]
    n = len(port.ts)
    assert n > 0 and n % 188 == 0 and n == len(ref.ts)
    np.testing.assert_array_equal(port.ts, loop["ts"][:n])
    np.testing.assert_array_equal(port.ts, ref.ts)
    assert port.fsync_ok == ref.fsync_ok
    assert port.control_word == ref.control_word == 6
    for f in FLAGS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)
    assert port.rs_ok.all() and port.checksum_ok.all()
    if case == "clean":
        assert port.fsync_ok and port.ext_ok.all()
        assert port.rs_errors.sum() == 0


def test_demodulate_rejects(loop):
    with pytest.raises(ValueError, match="whole superblocks"):
        TRX.demodulate_stream(J83bConfig(), loop["iq"][:-2], device="cpu")


def _status(out: str) -> dict:
    return {r["metric"]: r for r in map(json.loads, (
        s for s in out.splitlines() if s.startswith("{")))}


def test_qam_rx_cli_equals_jax_cli(loop, tmp_path, capsys):
    """Same .cfile through both CLIs: TS bytes and status fields equal
    (throughput excluded)."""
    src = tmp_path / "in.cfile"
    loop["iq"].tofile(src)
    assert jcli.qam_rx_cli(["-o", str(tmp_path / "jax.ts"), str(src)]) == 0
    want = _status(capsys.readouterr().out)
    assert tmain.main(["qam-rx", "-o", str(tmp_path / "port.ts"), str(src),
                       "--device", "cpu"]) == 0
    got = _status(capsys.readouterr().out)
    assert (tmp_path / "port.ts").read_bytes() == \
        (tmp_path / "jax.ts").read_bytes()
    assert got["j83b_rx_status"] == want["j83b_rx_status"]
    assert got["j83b_rx_status"]["value"] == 1


def test_qam_rx_cli_refuses_short_input(tmp_path):
    src = tmp_path / "short.cfile"
    np.zeros(1000, np.complex64).tofile(src)
    assert tmain.main(["qam-rx", str(src), "--device", "cpu"]) == 255
