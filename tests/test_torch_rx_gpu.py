"""The port's receivers and decoders on the card, held to the port's own CPU
run on the same inputs.  Every test here needs a CUDA device and skips
without one.  The module imports no JAX (the GPU machine has none): on that
machine run ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_rx_gpu.py -m gpu``.  The JAX comparisons are in
``tests/test_torch_rx_{decoders,dvbt,dvbt2,j83b}.py`` and
``tests/test_torch_ldpc.py``.

The Viterbi, RS and min-sum LDPC decoders do exact or fixed-order
arithmetic, so their outputs must be equal; the receivers' FFT and matched
filter round differently on the card, so there the TS and every flag must
be equal, and the input TS recovered.  The Viterbi, min-sum and RS kernels
(``csrc/viterbi.cu``, ``csrc/ldpc_minsum.cu``, ``csrc/rs_decode.cu``) are
also held to their plain versions on the same tensors, bit for bit.  Host
IQ staged through the pinned ring (``utils/staging.py``) must land equal to
``torch.from_numpy(x).cuda()``, bit for bit, one pinned copy per chunk.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dtv_utils_torch.core import cplx
from dtv_utils_torch.core.config import (CodeRate, Constellation, DvbtConfig,
                                         Dvbt2Config, GuardInterval,
                                         J83bConfig, TransmissionMode)
from dtv_utils_torch.core.galois import GF128
from dtv_utils_torch.ops import _build, convcode
from dtv_utils_torch.ops import ldpc_decode as LD
from dtv_utils_torch.ops import rs as TRS
from dtv_utils_torch.ops import rs_decode as TR
from dtv_utils_torch.ops import viterbi as TV
from dtv_utils_torch.rx import dvbt as RXD
from dtv_utils_torch.rx import dvbt2 as RX2
from dtv_utils_torch.rx import j83b as RXQ
from dtv_utils_torch.tx import dvbt as TXD
from dtv_utils_torch.tx import dvbt2 as TX2
from dtv_utils_torch.tx import j83b as TXQ
from dtv_utils_torch.utils import staging


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


def _acs_inputs(monkeypatch, decode):
    """The (pairs, k, g1, g2) that ``decode()`` hands the ACS wrapper."""
    seen, acs = [], TV._acs

    def keep(pairs, *code):
        seen.append((pairs, *code))
        return acs(pairs, *code)

    monkeypatch.setattr(TV, "_acs", keep)
    decode()
    monkeypatch.setattr(TV, "_acs", acs)
    return seen


def _viterbi_kernels_equal_plain(pairs, k, g1, g2):
    before = dict(_build.LAUNCHES)
    packed, final = TV._acs(pairs, k, g1, g2)
    bits = TV._traceback(packed, final, k)
    assert _build.LAUNCHES == before | {
        key: before[key] + 1 for key in ("viterbi_acs", "viterbi_traceback")}
    decs, want_final = TV.acs_reference(pairs, k, g1, g2)
    assert torch.equal(packed, TV.pack_decisions(decs))
    assert torch.equal(final, want_final)
    assert torch.equal(bits, TV.traceback_reference(packed, final, k))
    return packed, bits


@pytest.mark.gpu
def test_viterbi_k7_kernels_equal_plain(monkeypatch):
    """K=7 at rate 7/8 with noise, blocks of 1024 steps: the seams' head
    pad and tail erasures included."""
    _need_cuda()
    rate, n = (7, 8), 7 * 3000
    rng = np.random.default_rng(17)
    bits = torch.from_numpy(rng.integers(0, 2, n).astype(np.uint8))
    enc = convcode.conv_encode(bits, torch.zeros(6, dtype=torch.uint8))
    kept = enc.reshape(-1)[convcode.puncture_indices(rate, n)]
    llr = (1.0 - 2.0 * kept.to(torch.float32) + torch.from_numpy(
        rng.normal(0, 0.5, n * 8 // 7).astype(np.float32))).cuda()
    (args,) = _acs_inputs(monkeypatch, lambda: TV.viterbi_decode_punctured(
        llr, rate, 1024))
    assert args[1:] == (TV.DVBT_K, TV.DVBT_G1, TV.DVBT_G2)
    _viterbi_kernels_equal_plain(*args)


@pytest.mark.gpu
def test_viterbi_k5_kernels_equal_plain(monkeypatch):
    """K=5 on J.83B's hard ±1 substreams of noisy trellis words."""
    _need_cuda()
    words = torch.from_numpy(np.random.default_rng(18).integers(
        0, 64, 5 * 2000).astype(np.int32)).cuda()
    (args,) = _acs_inputs(monkeypatch, lambda: RXQ.trellis_decode(words))
    assert args[1:] == (TV.J83B_K, TV.J83B_G1, TV.J83B_G2)
    _viterbi_kernels_equal_plain(*args)


def _code(k):
    return ((TV.DVBT_K, TV.DVBT_G1, TV.DVBT_G2) if k == 7
            else (TV.J83B_K, TV.J83B_G1, TV.J83B_G2))


def _blocks_per_warp(k):
    """32 / the lanes per block ``csrc/viterbi.cu`` ships for K: the ACS's
    blocks per warp."""
    src = (Path(TV.__file__).resolve().parent.parent / "csrc"
           / "viterbi.cu").read_text()
    return 32 // int(re.search(rf"\bACS_LANES_K{k} = (\d+)", src).group(1))


def _edge_shapes(k):
    """(L, B): one step of one block, fewer steps than a traceback batch
    or a prefetch, one block, and a ragged last warp (B one past and one
    short of whole warps of blocks)."""
    g = _blocks_per_warp(k)
    return [(1, 1), (5, 1), (7, g + 1), (40, 1), (301, 2 * g - 1),
            (33, 3 * g + 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [7, 5])
def test_viterbi_kernels_tied_metrics(k):
    """All erasures tie every candidate and every final metric: no
    decision set, and the traceback starts at state 0; at 301 × 37 and at
    each edge shape."""
    _need_cuda()
    for L, B in [(301, 37)] + _edge_shapes(k):
        packed, bits = _viterbi_kernels_equal_plain(
            torch.zeros(L, B, 2, device="cuda"), *_code(k))
        assert not packed.any() and not bits.any()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [7, 5])
def test_viterbi_kernels_edge_shapes(k):
    """Noisy pairs with erasures and hard ±1 pairs (exact ties) at each
    edge shape: the kernels equal the plain versions."""
    _need_cuda()
    rng = np.random.default_rng(20 + k)
    for L, B in _edge_shapes(k):
        soft = rng.normal(0, 1, (L, B, 2)).astype(np.float32)
        soft[rng.random((L, B, 2)) < 0.2] = 0.0
        hard = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32),
                          (L, B, 2))
        for pairs in (soft, hard):
            _viterbi_kernels_equal_plain(torch.from_numpy(pairs).cuda(),
                                         *_code(k))


@pytest.mark.gpu
def test_viterbi_traceback_views():
    """The traceback takes any decisions aligned to their word: at K=5
    ``packed[1:]`` of an odd B (which starts at 2 mod 4) and a copy 2
    bytes into a buffer equal the plain version; a K=5 view at an odd
    byte and a K=7 view 4 bytes past 8-byte alignment raise."""
    _need_cuda()
    rng = np.random.default_rng(24)
    for k, B in ((5, 37), (5, 1), (7, 37)):
        L, nb = 70, 1 << (k - 4)
        pairs = torch.from_numpy(
            rng.normal(0, 1, (L, B, 2)).astype(np.float32)).cuda()
        packed, final = TV._acs(pairs, *_code(k))
        buf = torch.zeros(L * B * nb + 8, dtype=torch.uint8, device="cuda")
        views = [packed[1:]]
        for at in (2, 1, 4):
            v = buf[at:at + L * B * nb].view(L, B, nb)
            v.copy_(packed)
            views.append(v)
        for v in views:
            aligned = v.data_ptr() % nb == 0
            if aligned:
                assert torch.equal(TV._traceback(v, final, k),
                                   TV.traceback_reference(v, final, k))
            else:
                with pytest.raises(RuntimeError, match="CUDA error"):
                    TV._traceback(v, final, k)
        assert k == 7 or packed[1:].data_ptr() % 4 == 2 * (B % 2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["awgn", "noise", "ragged"])
def test_ldpc_kernels_equal_plain(case):
    """Three iterations step by step: the variable kernel's totals and the
    check kernel's state (m1, m2, meta) and the messages it rebuilds equal
    the plain versions' on the card; "ragged" decodes 31 blocks (a slice
    of 31 codewords, blade's count)."""
    _need_cuda()
    rng = np.random.default_rng(19)
    if case == "noise":
        llr = torch.from_numpy(rng.normal(0, 1, (3, T2_CFG.nldpc)).astype(
            np.float32))
    else:
        llr = _t2_awgn_llrs(rng, 31 if case == "ragged" else 3)[0]
    dg, llr_s, totals, state = LD._start(T2_CFG, llr.cuda())
    plain_totals = totals.clone()
    plain_state = tuple(x.clone() for x in state)
    before = dict(_build.LAUNCHES)
    for _ in range(3):
        LD._variable_totals(dg, llr_s, state, totals)
        LD.variable_totals_reference(dg, llr_s, plain_state, plain_totals)
        assert torch.equal(totals, plain_totals)
        state = LD._check_update(dg, totals, state)
        plain_state = LD.check_update_reference(dg, plain_totals,
                                                plain_state)
        for a, b in zip(state, plain_state):
            assert torch.equal(a, b)
        assert torch.equal(LD.expand_c2v(dg, state),
                           LD.expand_c2v(dg, plain_state))
    LD._variable_totals(dg, llr_s, state, totals)
    assert _build.LAUNCHES == before | {
        "ldpc_check": before["ldpc_check"] + 3,
        "ldpc_variable": before["ldpc_variable"] + 4}
    hard, ok = LD._finish(dg, totals)
    want = LD.decode(T2_CFG, llr, iterations=3)
    assert torch.equal(hard.cpu(), want[0]) and torch.equal(ok.cpu(), want[1])


def _rs_dec(which):
    return (TR.DVBT_RS_DEC() if which == "dvbt"
            else TR.RsDecoder(GF128, 122, 5, first_root=1))


def _rs_words(dec, case, batch, seed=3):
    """int64 codewords [batch, n] of ``dec``'s code: valid words with the
    errors ``case`` names (none, t, t+1 or 2t each; "mixed": 1..2t+4 in
    turn), or uniformly random words."""
    rng = np.random.default_rng(seed)
    if case == "random":
        return rng.integers(0, dec.gf.q, (batch, dec.n))
    enc = (TRS.DVBT_RS() if dec.gf.m == 8
           else TRS.RsBitEncoder(GF128, 122, 5, first_root=1))
    msgs = rng.integers(0, dec.gf.q, (batch, dec.k_sym))
    cw = np.concatenate([msgs, enc.gf.rs_encode_ref(msgs, enc.genpoly)],
                        axis=1)
    n_errs = ((np.arange(batch) + 1) % (2 * dec.t + 5) if case == "mixed"
              else [{"clean": 0, "t": dec.t, "t+1": dec.t + 1,
                     "2t": 2 * dec.t}[case]] * batch)
    for p, ne in enumerate(n_errs):
        pos = rng.choice(dec.n, ne, replace=False)
        cw[p, pos] ^= rng.integers(1, dec.gf.q, ne)
    return cw


def _one_rs_launch(decode, *args):
    """``decode(*args)``, asserting that it launched the RS kernel once
    and no other kernel."""
    before = dict(_build.LAUNCHES)
    out = decode(*args)
    assert _build.LAUNCHES == before | {"rs_decode":
                                        before["rs_decode"] + 1}
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case, batch", [
    ("clean", 203), ("t", 203), ("t+1", 203), ("2t", 203), ("random", 203),
    ("mixed", 1), ("mixed", 7), ("mixed", 1001)])
@pytest.mark.parametrize("which", ["dvbt", "j83b"])
def test_rs_cuda_equals_cpu(which, case, batch):
    """The kernel's corrected words, n_err and ok equal the plain
    version's on the CPU bit for bit: clean words, exactly t, t+1 and 2t
    errors, random words, and batches of 1, 7 and others not a multiple of
    the kernel's 8 warps per CTA."""
    _need_cuda()
    dec = _rs_dec(which)
    cw = torch.from_numpy(_rs_words(dec, case, batch))
    got = _one_rs_launch(dec.decode_words, cw.cuda())
    want = dec.decode_words(cw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    if case in ("clean", "t"):
        assert want[2].all()


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 7, 1001])
def test_rs_cuda_bytes_equal_cpu(batch):
    """uint8 codewords through decode_bytes: the kernel reads and writes
    bytes, equal to the plain version's."""
    _need_cuda()
    dec = TR.DVBT_RS_DEC()
    cw = torch.from_numpy(_rs_words(dec, "mixed", batch, seed=5)).to(
        torch.uint8)
    got = _one_rs_launch(dec.decode_bytes, cw.cuda())
    want = dec.decode_bytes(cw)
    assert got[0].dtype == torch.uint8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_rs_cuda_takes_strided_rows():
    """J.83B's layout: int32 words read in place from the [:, :127] view
    of [n_cw, 128] rows, equal to the plain version run on the card."""
    _need_cuda()
    dec = _rs_dec("j83b")
    wide = torch.from_numpy(_rs_words(dec, "mixed", 999, seed=6)).to(
        torch.int32)
    wide = torch.cat([wide, wide[:, :1]], 1).cuda()
    got = _one_rs_launch(dec.decode_words, wide[:, :127])
    want = dec.decode_reference(wide[:, :127])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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


T2_CFG = Dvbt2Config(fec_blocks=3, ti_blocks=2)


def _t2_iq(snr_db):
    ts = _seeded_ts(T2_CFG.payload_bytes_per_frame, 6)
    iq, _ = TX2.modulate_stream(T2_CFG, ts, device="cpu")
    return ts, (iq if snr_db is None else _awgn(iq, snr_db, 7))


def _t2_awgn_llrs(rng, n=3):
    """n T2_CFG codewords through BPSK at 2.5 dB Es/N0: (llr, codewords)."""
    bb = torch.from_numpy(rng.integers(0, 2, (n, T2_CFG.kbch)).astype(
        np.uint8))
    fec = TX2.fec_encode(T2_CFG, bb)
    sigma = np.sqrt(1 / (2 * 10 ** (2.5 / 10)))
    llr = (2 * (1.0 - 2.0 * fec.float()) / sigma ** 2
           + torch.from_numpy(rng.normal(0, 2 / sigma, fec.shape).astype(
               np.float32)))
    return llr, fec


@pytest.mark.gpu
def test_ldpc_cuda_equals_cpu():
    """Hard bits and ok of a channel the decoder corrects and of one it
    cannot (10 iterations on noise), and the syndrome, bit for bit."""
    _need_cuda()
    rng = np.random.default_rng(2)
    llr, fec = _t2_awgn_llrs(rng)
    noise = torch.from_numpy(rng.normal(0, 1, fec.shape).astype(np.float32))
    for x, it in ((llr, 30), (noise, 10)):
        got = LD.decode(T2_CFG, x.cuda(), iterations=it)
        want = LD.decode(T2_CFG, x, iterations=it)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert want[0].numel() and not want[1].any()
    flipped = fec.clone()
    flipped[1, 777] ^= 1
    assert torch.equal(LD.syndrome(T2_CFG, flipped.cuda()).cpu(),
                       LD.syndrome(T2_CFG, flipped))


@pytest.mark.gpu
@pytest.mark.parametrize("snr", [None, 14.5])
def test_dvbt2_rx_cuda_equals_cpu(snr):
    _need_cuda()
    ts, iq = _t2_iq(snr)
    got = RX2.demodulate_stream(T2_CFG, iq, soft=snr is not None,
                                device="cuda")
    want = RX2.demodulate_stream(T2_CFG, iq, soft=snr is not None,
                                 device="cpu")
    np.testing.assert_array_equal(got.ts, ts[:len(got.ts)])
    np.testing.assert_array_equal(got.ts, want.ts)
    for f in ("ldpc_ok", "bch_ok", "bb_crc_ok"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).all()
    assert got.l1_pre == want.l1_pre and got.l1_post == want.l1_post
    assert (got.s1, got.s2, got.sync_crc_ok) == (want.s1, want.s2, True)


@pytest.mark.gpu
def test_dvbt2_decode_makes_no_host_sync():
    _need_cuda()
    _, iq = _t2_iq(14.5)
    body = torch.from_numpy(iq[2048:TX2.samples_per_frame(T2_CFG)]).cuda()
    llr = torch.randn(3, T2_CFG.nldpc, device="cuda")
    for soft in (False, True):                      # warm: tables uploaded
        RX2._decode_frame(T2_CFG, body, soft, 30)
    torch.cuda.set_sync_debug_mode("error")
    try:
        LD.decode(T2_CFG, llr)
        for soft in (False, True):
            RX2._decode_frame(T2_CFG, body, soft, 30)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


STAGE_CHUNK = staging.CHUNK_BYTES // 8
STAGE_SIZES = [0, 1, STAGE_CHUNK - 1, STAGE_CHUNK, STAGE_CHUNK + 1,
               3 * STAGE_CHUNK + 7]


def _host_iq(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(2 * n, dtype=np.float32).view(np.complex64)


def _bits(x):
    return torch.view_as_real(x.reshape(-1)).view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", STAGE_SIZES)
def test_staged_copy_equals_a_plain_one(n):
    _need_cuda()
    x = _host_iq(3 * n + 3, seed=n)
    for src in (x[:n], x[1::3][:n], x[::-1][:n], torch.from_numpy(x)[2:n + 2],
                torch.from_numpy(x)[::3][:n]):
        got = cplx.iq_to_device(src, device="cuda")
        want = (src if isinstance(src, torch.Tensor)
                else torch.from_numpy(np.array(src))).cuda()
        assert got.is_cuda and got.shape == (n,)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.gpu
def test_staged_source_may_be_overwritten_at_once():
    _need_cuda()
    x = _host_iq(staging.SLOTS * STAGE_CHUNK + 7, seed=1)
    keep = x.copy()
    got = cplx.iq_to_device(x, device="cuda")
    x[:] = 0
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(torch.from_numpy(keep).cuda()))


@pytest.mark.gpu
def test_back_to_back_staged_calls_share_the_ring():
    _need_cuda()
    # each capture takes more chunks than the ring has slots
    xs = [_host_iq(staging.SLOTS * STAGE_CHUNK + 11 * k, seed=k)
          for k in (1, 2, 3)]
    got = [cplx.iq_to_device(x, device="cuda") for x in xs]
    torch.cuda.synchronize()
    for g, x in zip(got, xs):
        assert torch.equal(_bits(g), _bits(torch.from_numpy(x).cuda()))


@pytest.mark.gpu
def test_traced_copy_in_is_one_pinned_copy_per_chunk(tmp_path):
    _need_cuda()
    x = _host_iq(3 * STAGE_CHUNK + 7, seed=5)
    cplx.iq_to_device(x, device="cuda")                     # ring made
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cplx.iq_to_device(x, device="cuda")
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    span, = [e for e in events if e.get("name") == "dtv.stream.copy_in"
             and e.get("ph") == "X"]
    corr = {e["args"].get("correlation") for e in events
            if e.get("cat") == "cuda_runtime" and e.get("tid") == span["tid"]
            and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]}
    copies = [e["name"] for e in events if e.get("cat") == "gpu_memcpy"]
    inside = [e["name"] for e in events if e.get("cat") == "gpu_memcpy"
              and e["args"].get("correlation") in corr]
    assert inside == ["Memcpy HtoD (Pinned -> Device)"] * len(
        staging.chunk_plan(x.shape[0], STAGE_CHUNK))
    assert not any("Pageable" in c for c in copies)
