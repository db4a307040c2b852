"""The port's receivers and decoders on the card, held to the port's own CPU
run on the same inputs.  Every test here needs a CUDA device and skips
without one.  The module imports no JAX (the GPU machine has none): on that
machine run ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_rx_gpu.py -m gpu``.  The JAX comparisons are in
``tests/test_torch_rx_{decoders,dvbt,j83b}.py``.

The Viterbi and RS decoders do exact arithmetic, so their outputs must be
equal; the receivers' FFT and matched filter round differently on the card,
so there the TS and every flag must be equal, and the input TS recovered.
"""

import numpy as np
import pytest
import torch

from dtv_utils_torch.core.config import (CodeRate, Constellation, DvbtConfig,
                                         GuardInterval, J83bConfig,
                                         TransmissionMode)
from dtv_utils_torch.core.galois import GF128
from dtv_utils_torch.ops import convcode
from dtv_utils_torch.ops import rs_decode as TR
from dtv_utils_torch.ops import viterbi as TV
from dtv_utils_torch.rx import dvbt as RXD
from dtv_utils_torch.rx import j83b as RXQ
from dtv_utils_torch.tx import dvbt as TXD
from dtv_utils_torch.tx import j83b as TXQ


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _seeded_ts(n_bytes, seed):
    ts = np.random.default_rng(seed).integers(0, 256, n_bytes).astype(
        np.uint8)
    ts[::188] = 0x47
    return ts


def _awgn(iq, snr_db, seed):
    rng = np.random.default_rng(seed)
    p = np.mean(np.abs(iq) ** 2) / 10 ** (snr_db / 10)
    return iq + (rng.normal(0, np.sqrt(p / 2), len(iq)) + 1j * rng.normal(
        0, np.sqrt(p / 2), len(iq))).astype(np.complex64)


@pytest.mark.gpu
def test_viterbi_cuda_equals_cpu():
    _need_cuda()
    rate, n = (7, 8), 7 * 6000
    rng = np.random.default_rng(7)
    bits = torch.from_numpy(rng.integers(0, 2, n).astype(np.uint8))
    enc = convcode.conv_encode(bits, torch.zeros(6, dtype=torch.uint8))
    kept = enc.reshape(-1)[convcode.puncture_indices(rate, n)]
    llr = 1.0 - 2.0 * kept.to(torch.float32)
    llr += torch.from_numpy(rng.normal(0, 0.45, n * 8 // 7).astype(
        np.float32))
    got = TV.viterbi_decode_punctured(llr.cuda(), rate, 1024).cpu()
    assert torch.equal(got, TV.viterbi_decode_punctured(llr, rate, 1024))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["dvbt", "j83b"])
def test_rs_cuda_equals_cpu(which):
    _need_cuda()
    dec = (TR.DVBT_RS_DEC() if which == "dvbt"
           else TR.RsDecoder(GF128, 122, 5, first_root=1))
    rng = np.random.default_rng(3)
    cw = torch.from_numpy(rng.integers(0, dec.gf.q, (256, dec.n)))
    for g, w in zip(dec.decode_words(cw.cuda()), dec.decode_words(cw)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_decoders_make_no_host_sync():
    _need_cuda()
    llr = torch.randn(7 * 8 * 512, device="cuda")
    cw = torch.randint(0, 256, (64, 204), device="cuda", dtype=torch.uint8)
    TV.viterbi_decode_punctured(llr, (7, 8))      # warm: tables uploaded
    TR.DVBT_RS_DEC().decode_bytes(cw)
    torch.cuda.set_sync_debug_mode("error")
    try:
        TV.viterbi_decode_punctured(llr, (7, 8))
        TR.DVBT_RS_DEC().decode_bytes(cw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_dvbt_rx_cuda_equals_cpu():
    _need_cuda()
    cfg = DvbtConfig(mode=TransmissionMode.M2K, bandwidth_mhz=8,
                     constellation=Constellation.QAM64,
                     code_rate=CodeRate.R7_8, guard=GuardInterval.G1_32)
    ts = _seeded_ts(2 * cfg.ts_bytes_per_superframe, 7)
    iq, _ = TXD.modulate_stream(cfg, ts, device="cpu")
    iq = _awgn(iq, 20.0, 11)
    got = RXD.demodulate_stream(cfg, iq, device="cuda")
    want = RXD.demodulate_stream(cfg, iq, device="cpu")
    np.testing.assert_array_equal(got.ts, ts[:len(got.ts)])
    np.testing.assert_array_equal(got.ts, want.ts)
    np.testing.assert_array_equal(got.rs_ok, want.rs_ok)
    assert got.rs_ok.all() and got.phase_ok and got.tps == want.tps


@pytest.mark.gpu
@pytest.mark.parametrize("snr", [None, 27.0])
def test_j83b_rx_cuda_equals_cpu(snr):
    _need_cuda()
    cfg = J83bConfig()
    ts = _seeded_ts(TXQ.SUPERBLOCK_BYTES, 5)
    iq, _ = TXQ.modulate_stream(cfg, ts, device="cuda")
    if snr is not None:
        iq = _awgn(iq, snr, 9)
    got = RXQ.demodulate_stream(cfg, iq, device="cuda")
    want = RXQ.demodulate_stream(cfg, iq, device="cpu")
    np.testing.assert_array_equal(got.ts, ts[:len(got.ts)])
    np.testing.assert_array_equal(got.ts, want.ts)
    assert got.fsync_ok == want.fsync_ok and got.control_word == 6
    for f in ("rs_ok", "rs_errors", "ext_ok", "checksum_ok"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
