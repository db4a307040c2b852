"""The plain versions of the port's decoder kernels (``csrc/viterbi.cu``,
``csrc/ldpc_minsum.cu``) against the JAX reference, on the CPU.

The kernels run only on the card (``tests/test_torch_rx_gpu.py`` and
``chip_smoke.py`` hold them to these plain versions bit for bit).  Here
the same seeded inputs go through the reference's scans and through the
plain versions, which compute what the kernels compute: the ACS with its
decisions bit-packed as the reference packs them (the word layout the
kernel writes), the traceback from packed words, and the min-sum iteration
on the 16-byte check state and the sliced layout the kernels read.  Every
comparison is exact: the arithmetic rounds once per operation in the
reference's order.  The wrappers take the plain versions on CPU tensors,
count no launch, and raise on what the kernels do not take.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtv_utils_tpu.core import config as JC
from dtv_utils_tpu.ops import ldpc_decode as JLD
from dtv_utils_tpu.ops import viterbi as JV
from dtv_utils_tpu.tx import dvbt2 as JTX
from dtv_utils_torch.core import config as TC
from dtv_utils_torch.ops import convcode as tconv
from dtv_utils_torch.ops import ldpc_decode as TLD
from dtv_utils_torch.ops import viterbi as TV
from dtv_utils_torch.tx import j83b as TXQ

CODES = {7: (TV.DVBT_K, TV.DVBT_G1, TV.DVBT_G2),
         5: (TV.J83B_K, TV.J83B_G1, TV.J83B_G2)}


def _blocked_pairs(k, L, B, sigma, seed):
    """Depunctured (x, y) pairs [L, B, 2] float32 of B independent blocks:
    K=7 coded at rate 7/8 (DVB-T), K=5 at 4/5 (J.83B's punctures, hard ±1
    decisions as its receiver makes, with flipped bits), plus N(0, sigma)
    noise; erasures where punctured."""
    rng = np.random.default_rng(seed)
    n = L * B
    if k == 7:
        n -= n % 7
        bits = torch.from_numpy(rng.integers(0, 2, n).astype(np.uint8))
        enc = tconv.conv_encode(bits, torch.zeros(6, dtype=torch.uint8))
        kept = enc.reshape(-1)[tconv.puncture_indices((7, 8), n)].numpy()
        llr = 1.0 - 2.0 * kept.astype(np.float32)
        pairs = TV.depuncture(torch.from_numpy(llr), (7, 8)).numpy()
    else:
        n -= n % 4
        hard = rng.integers(0, 2, n // 4 * 5)
        hard ^= rng.random(hard.shape) < 0.05
        llr = (1.0 - 2.0 * hard).astype(np.float32)
        pairs = TV.depuncture_xy(torch.from_numpy(llr), TXQ.PUNCT_X,
                                 TXQ.PUNCT_Y).numpy()
    pairs = np.concatenate([pairs, np.zeros((L * B - len(pairs), 2),
                                            np.float32)])
    pairs += rng.normal(0, sigma, pairs.shape).astype(np.float32)
    return np.ascontiguousarray(pairs.reshape(B, L, 2).transpose(1, 0, 2))


@pytest.mark.parametrize("k,sigma", [(7, 0.0), (7, 0.5), (5, 0.0),
                                     (5, 0.6)])
def test_packed_acs_equals_jax(k, sigma):
    """pack_decisions(acs_reference) is the reference's bit-packed
    decisions and final metrics, byte for byte."""
    pairs = _blocked_pairs(k, 333, 6, sigma, seed=k)
    jdecs, jfinal = JV._acs_scan(jnp.asarray(pairs), *CODES[k])
    decs, final = TV.acs_reference(torch.from_numpy(pairs), *CODES[k])
    packed = TV.pack_decisions(decs)
    assert packed.dtype == torch.uint8
    assert packed.shape == (333, 6, (1 << (k - 1)) // 8)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jdecs))
    np.testing.assert_array_equal(final.numpy(), np.asarray(jfinal))


@pytest.mark.parametrize("k", [7, 5])
def test_traceback_on_packed_words_equals_jax(k):
    """traceback_reference reads the reference's packed words as the
    reference's own traceback does."""
    pairs = _blocked_pairs(k, 300, 5, 0.7, seed=10 + k)
    jdecs, jfinal = JV._acs_scan(jnp.asarray(pairs), *CODES[k])
    want = np.asarray(JV._traceback(jdecs, jfinal, k))
    got = TV.traceback_reference(torch.from_numpy(np.array(jdecs)),
                                 torch.from_numpy(np.array(jfinal)), k)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [7, 5])
def test_traceback_tied_final_metric_takes_first_state(k):
    """Final metrics tied at several states start the traceback at the
    first of them, as jnp.argmax does; all-erasure pairs tie every
    metric and every decision."""
    S = 1 << (k - 1)
    rng = np.random.default_rng(k)
    packed = rng.integers(0, 256, (50, 4, S // 8)).astype(np.uint8)
    final = rng.normal(size=(4, S)).astype(np.float32) - 10.0
    final[0, [3, 9]] = 0.0                   # tie between states 3 and 9
    final[1, [S - 2, 1]] = 0.0               # tie, the later state first
    final[2] = 0.0                           # every state tied
    final[3, S - 1] = 0.0                    # one maximum, the last state
    want = np.asarray(JV._traceback(jnp.asarray(packed), jnp.asarray(final),
                                    k))
    got = TV.traceback_reference(torch.from_numpy(packed),
                                 torch.from_numpy(final), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[-1].tolist() == [3 >> (k - 2), 1 >> (k - 2), 0, 1]
    zeros = np.zeros((40, 3, 2), np.float32)
    jdecs, jfinal = JV._acs_scan(jnp.asarray(zeros), *CODES[k])
    packed, final = TV._acs(torch.from_numpy(zeros), *CODES[k])
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jdecs))
    assert not packed.any() and not final.any()
    np.testing.assert_array_equal(
        TV._traceback(packed, final, k).numpy(),
        np.asarray(JV._traceback(jdecs, jfinal, k)))


@pytest.mark.parametrize("k", [7, 5])
def test_wrappers_take_plain_version_on_cpu(k):
    """On CPU tensors _acs and _traceback are the plain versions, equal to
    the reference's scans, and launch nothing."""
    pairs = _blocked_pairs(k, 257, 3, 0.5, seed=20 + k)
    before = dict(TV.LAUNCHES)
    packed, final = TV._acs(torch.from_numpy(pairs), *CODES[k])
    bits = TV._traceback(packed, final, k)
    assert TV.LAUNCHES == before
    jdecs, jfinal = JV._acs_scan(jnp.asarray(pairs), *CODES[k])
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jdecs))
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(JV._traceback(jdecs, jfinal, k)))


def test_viterbi_wrappers_reject():
    pairs = torch.zeros(10, 3, 2)
    g = CODES[7]
    with pytest.raises(TypeError, match="float32"):
        TV._acs(pairs.double(), *g)
    with pytest.raises(ValueError, match=r"\[L, B, 2\]"):
        TV._acs(torch.zeros(10, 3, 3), *g)
    with pytest.raises(ValueError, match="contiguous"):
        TV._acs(torch.zeros(3, 10, 2).transpose(0, 1), *g)
    with pytest.raises(ValueError, match="unsupported device"):
        TV._acs(pairs.to("meta"), *g)
    packed, final = TV._acs(pairs, *g)
    with pytest.raises(TypeError, match="uint8"):
        TV._traceback(packed.int(), final, 7)
    with pytest.raises(ValueError, match=r"\[L, B, 8\]"):
        TV._traceback(packed[..., :2], final, 7)
    with pytest.raises(ValueError, match="metrics on"):
        TV._traceback(packed, final.to("meta"), 7)
    with pytest.raises(ValueError, match="unsupported device"):
        TV._traceback(packed.to("meta"), final.to("meta"), 7)


# ---------------------------------------------------------------------------
# The Viterbi kernels' schedule (csrc/viterbi.cu), modelled in NumPy
# ---------------------------------------------------------------------------

def _code(k, ns, a):
    """branch_code of csrc/viterbi.cu: 2·(x output bit) + (y output bit) of
    branch (ns, a), for arrays of states."""
    _, g1, g2 = CODES[k]
    ns = np.asarray(ns)
    w = ((ns >> (k - 2)) << (k - 1)) | ((ns & ((1 << (k - 2)) - 1)) << 1) | a
    par = lambda v: np.vectorize(lambda u: bin(int(u)).count("1") & 1)(v)
    return 2 * par(w & g1) + par(w & g2)


def _shipped_lanes(k):
    """The lanes per block ``csrc/viterbi.cu`` ships for K."""
    src = (Path(TV.__file__).resolve().parent.parent / "csrc"
           / "viterbi.cu").read_text()
    return int(re.search(rf"\bACS_LANES_K{k} = (\d+)", src).group(1))


def _model_acs(pairs, k, lanes):
    """The ACS kernel's schedule at ``lanes`` lanes per block: 32 / lanes
    blocks per warp (a ragged last warp's spare lanes read block B - 1 and
    store nothing), lane l holding the metrics of states [SPL·l,
    SPL·l + SPL) before their normalisation and the block's max mx; each
    step the lane takes its P = min(2·SPL, S) predecessor metrics from
    lanes 2l and 2l + 1 (mod lanes), subtracts mx from them, adds ±A or
    ±B (A, B picked once per lane from the linearity of the code),
    compares strictly, keeps the larger, takes the block's max, and
    stores its SPL decision bits: as
    SPL / 8 little-endian bytes at byte SPL / 8 · l of the step's word, or
    merged over 8 / SPL lanes into byte l·SPL / 8.  float32 throughout,
    one rounding per operation."""
    L, B, _ = pairs.shape
    S = 1 << (k - 1)
    spl, G = S // lanes, 32 // lanes
    P = min(2 * spl, S)
    nw = -(-B // G)
    blk = np.minimum(np.arange(nw * G), B - 1).reshape(nw, G)
    active = (np.arange(nw * G) < B).reshape(nw, G)
    l = np.arange(lanes)
    src0, src1 = (2 * l) % lanes, (2 * l + 1) % lanes
    lane_code = _code(k, spl * l, 0)
    swap = ((lane_code ^ (lane_code >> 1)) & 1).astype(bool)
    sign = np.where(lane_code & 2, -1.0, 1.0).astype(np.float32)
    codes = np.stack([_code(k, np.arange(spl), a) for a in (0, 1)])
    m = np.zeros((nw, G, lanes, spl), np.float32)
    mx = np.zeros((nw, G, 1, 1), np.float32)
    decs = np.zeros((L, B, S // 8), np.uint8)
    f32 = np.float32
    for t in range(L):
        xy = pairs[t][blk]                                  # [nw, G, 2]
        x, y = xy[..., 0:1], xy[..., 1:2]
        s, d = (x + y).astype(f32), (x - y).astype(f32)
        A = (np.where(swap, d, s) * sign).astype(f32)       # [nw, G, lanes]
        Bm = (np.where(swap, s, d) * sign).astype(f32)
        pick = np.stack([A, Bm, -Bm, -A])                   # [4, nw, G, lanes]
        p = np.concatenate([m[:, :, src0], m[:, :, src1]],
                           axis=-1)[..., :P]                # raw metrics
        p = (p - mx).astype(f32)
        idx = np.arange(spl)
        c0 = (p[..., (2 * idx) % P] + np.moveaxis(
            pick[codes[0]], 0, -1)).astype(f32)
        c1 = (p[..., (2 * idx + 1) % P] + np.moveaxis(
            pick[codes[1]], 0, -1)).astype(f32)
        dec = c1 > c0
        m = np.where(dec, c1, c0)
        mx = m.max(axis=(2, 3), keepdims=True)
        chunk = (dec.astype(np.uint64) << np.arange(spl, dtype=np.uint64)
                 ).sum(-1)                                  # [nw, G, lanes]
        for w in range(nw):
            for g in range(G):
                if not active[w, g]:
                    continue
                row = decs[t, blk[w, g]]
                for lane in range(lanes):
                    if spl >= 8:
                        row[spl // 8 * lane:spl // 8 * (lane + 1)] = (
                            np.array([chunk[w, g, lane]], "<u8").view(
                                np.uint8)[:spl // 8])
                    elif lane % (8 // spl) == 0:
                        row[lane * spl // 8] = sum(
                            int(chunk[w, g, lane + r]) << (spl * r)
                            for r in range(8 // spl))
    final = (m - mx).astype(f32).reshape(nw * G, S)[:B]
    return decs, final


def _model_traceback(packed, final, k, batch=32, base=0):
    """The traceback kernel's reads, of decisions at address ``base`` (a
    multiple of the word's bytes): batches of ``batch`` steps from step
    L - 1 down (whole batches read their words first, the last batch one
    at a time); a K=7 word is 8 bytes at base + (t·B + b)·8, and its bit
    st is taken from the high or the low half by bit 5 of st; a K=5 word
    at a = base + (t·B + b)·2 is the high or low half, by bit 1 of a, of
    the 4 aligned bytes at a & ~3 (2 bytes before or past the tensor
    where it starts or ends at 2 mod 4, padded)."""
    L, B, nb = packed.shape
    S, H = 1 << (k - 1), 1 << (k - 2)
    assert base % nb == 0
    flat = np.concatenate([np.zeros(base, np.uint8), packed.reshape(-1),
                           np.zeros(2, np.uint8)])
    bits = np.zeros((L, B), np.uint8)
    for b in range(B):
        st = 0
        for s in range(1, S):
            if final[b, s] > final[b, st]:
                st = s

        def slot(t):
            at = base + (t * B + b) * nb
            if k == 7:
                return int(flat[at:at + 8].view("<u8")[0])
            al = at & ~3
            return int(flat[al:al + 4].view("<u4")[0]) >> (8 * (at & 2))

        for n in range(-(-L // batch)):
            t_hi = L - 1 - n * batch
            ts = range(t_hi, max(t_hi - batch, -1), -1)
            words = [slot(t) for t in ts] if t_hi >= batch - 1 else None
            for i, t in enumerate(ts):
                w = words[i] if words is not None else slot(t)
                bits[t, b] = st >> (k - 2)
                if k == 7:
                    half = (w >> 32) if st & 32 else w & 0xFFFFFFFF
                    a = (half >> (st & 31)) & 1
                else:
                    a = (w >> st) & 1
                st = ((st & (H - 1)) << 1) | a
    return bits


@functools.cache
def _schedule_case(k, case):
    """(pairs [L, B, 2], the JAX scans' decisions, final metrics, bits) of
    a small case: L = 45 (not a multiple of the 16-step prefetch or the
    32-step traceback batch), B = 7 (a ragged last warp at every lanes
    per block below 32); "noise" the punctured blocked pairs (erasures
    where punctured), "hard" ±1 LLRs with erasures (many exact ties),
    "zeros" all erasures (every candidate tied)."""
    L, B = 45, 7
    if case == "noise":
        pairs = _blocked_pairs(k, L, B, 0.7, seed=30 + k)
    else:
        pairs = np.zeros((L, B, 2), np.float32)
        if case == "hard":
            rng = np.random.default_rng(31 + k)
            pairs = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32),
                               (L, B, 2), p=[0.4, 0.2, 0.4])
    jdecs, jfinal = JV._acs_scan(jnp.asarray(pairs), *CODES[k])
    jbits = JV._traceback(jdecs, jfinal, k)
    return pairs, np.asarray(jdecs), np.asarray(jfinal), np.asarray(jbits)


@pytest.mark.parametrize("case", ["noise", "hard", "zeros"])
@pytest.mark.parametrize("k,lanes", [(7, 32), (7, 16), (7, 8), (7, 4),
                                     (5, 16), (5, 8), (5, 4), (5, 2),
                                     (5, 1)])
def test_kernel_schedule_equals_reference(k, lanes, case):
    """The kernels' schedule, modelled in NumPy at every lanes per block
    the tuning tool sweeps, writes the packed decisions, final metrics and
    bits of
    ``acs_reference``/``pack_decisions``/``traceback_reference`` and of
    the reference's scans, byte for byte."""
    pairs, jdecs, jfinal, jbits = _schedule_case(k, case)
    decs, final = _model_acs(pairs, k, lanes)
    want, want_final = TV.acs_reference(torch.from_numpy(pairs), *CODES[k])
    np.testing.assert_array_equal(decs, TV.pack_decisions(want).numpy())
    np.testing.assert_array_equal(decs, jdecs)
    np.testing.assert_array_equal(final, want_final.numpy())
    np.testing.assert_array_equal(final, jfinal)
    bits = _model_traceback(decs, final, k)
    np.testing.assert_array_equal(bits, TV.traceback_reference(
        torch.from_numpy(decs), torch.from_numpy(final), k).numpy())
    np.testing.assert_array_equal(bits, jbits)
    if case == "zeros":
        assert not decs.any() and not bits.any()


@pytest.mark.parametrize("k", [7, 5])
@pytest.mark.parametrize("L,B", [(1, 1), (31, 1), (33, 3)])
def test_kernel_schedule_edges(k, L, B):
    """One step, fewer steps than a traceback batch, one block, and a
    batch past a whole one: the kernels modelled at the lanes per block
    they ship equal the plain versions."""
    pairs = _blocked_pairs(k, L, B, 0.6, seed=40 + k + L)
    decs, final = _model_acs(pairs, k, _shipped_lanes(k))
    want, want_final = TV.acs_reference(torch.from_numpy(pairs), *CODES[k])
    np.testing.assert_array_equal(decs, TV.pack_decisions(want).numpy())
    np.testing.assert_array_equal(final, want_final.numpy())
    np.testing.assert_array_equal(
        _model_traceback(decs, final, k),
        TV.traceback_reference(torch.from_numpy(decs),
                               torch.from_numpy(final), k).numpy())


@pytest.mark.parametrize("k,B,base", [(5, 7, 0), (5, 7, 2), (5, 8, 2),
                                      (7, 7, 8)])
def test_kernel_traceback_views(k, B, base):
    """The traceback reads a K=5 word's half by its address, so decisions
    that start at 2 mod 4 (``packed[1:]`` of an odd B) walk as they do
    from an aligned start: the modelled reads equal
    ``traceback_reference``."""
    pairs = _blocked_pairs(k, 33, B, 0.6, seed=50 + k + B)
    decs, final = _model_acs(pairs, k, _shipped_lanes(k))
    view = decs[1:]
    np.testing.assert_array_equal(
        _model_traceback(view, final, k, base=base),
        TV.traceback_reference(torch.from_numpy(view),
                               torch.from_numpy(final), k).numpy())


def test_kernel_codes_are_linear():
    """The ACS picks a lane's branch metrics from two values because each
    code's output bits are linear over GF(2) in (state, a): code(ns | i,
    a) = code(ns, 0) ^ code(i, a) for disjoint bits, and both generators
    of each code tap the register's ends, so code(ns, 1) = code(ns, 0) ^ 3
    (the two branches into a state carry opposite metrics)."""
    for k in (7, 5):
        S = 1 << (k - 1)
        for spl in (1, 2, 4, 8, 16):
            for hi in range(0, S, spl):
                for i in range(spl):
                    for a in (0, 1):
                        assert (_code(k, hi | i, a)
                                == _code(k, hi, 0) ^ _code(k, i, a))
        assert all(_code(k, ns, 1) == _code(k, ns, 0) ^ 3 for ns in range(S))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_viterbi_acs_bound_counts_instructions():
    """``chip_smoke.viterbi_bounds`` counts the ACS's 6S + 1 fp32
    operations per step and block (none an FMA) at the rate it is given:
    at the fp32 instruction rate, 128 per SM and clock, on 132 SMs at
    1980 MHz, the flagship's shape (K=7, L = 4656, B = 4218) reads
    ~0.226 ms, twice the 0.113 ms of the 67 TFLOP/s default (the earlier
    yardstick).  J.83B's K=5 shape and every traceback stay bound by their
    bytes."""
    smoke = _chip_smoke()
    rate = smoke.FP32_LANES_PER_SM * 132 * 1980e6
    assert rate == pytest.approx(33.45e12, rel=1e-3)
    L, B, S = 4656, 4218, 64
    ms, by = smoke.viterbi_bounds(L, B, S, rate)["viterbi_acs"]
    assert by == "operations"
    assert ms == pytest.approx(L * B * 385 / rate * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.2261, abs=1e-4)
    old, old_by = smoke.viterbi_bounds(L, B, S)["viterbi_acs"]
    assert old_by == "operations"
    assert old == pytest.approx(L * B * 385 / 67e12 * 1e3, rel=1e-12)
    assert old == pytest.approx(0.11285, abs=1e-5)
    tb, tb_by = smoke.viterbi_bounds(L, B, S, rate)["viterbi_traceback"]
    assert tb_by == "bytes"
    assert tb == pytest.approx((L * B * 9 + B * S * 4)
                               / smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    L, B, S = 4346, 1412, 16
    for name, (ms, by) in smoke.viterbi_bounds(L, B, S, rate).items():
        assert by == "bytes"
        assert ms == pytest.approx(smoke.viterbi_bounds(L, B, S)[name][0],
                                   rel=1e-12)
    assert smoke.viterbi_bounds(L, B, S, rate)["viterbi_acs"][0] == (
        pytest.approx((L * B * 10 + B * S * 4) / smoke.HBM_BYTES_PER_S * 1e3,
                      rel=1e-12))


# ---------------------------------------------------------------------------
# Min-sum LDPC
# ---------------------------------------------------------------------------

def _cfg(C, fec_blocks=2):
    """The short rate-2/3 frame: 16200 bits, D = 26 slots per check."""
    return C.Dvbt2Config(frame_size=C.T2FrameSize.SHORT, fec_blocks=fec_blocks,
                         ti_blocks=1)


def _plain_decode(cfg, llr, iterations):
    """minsum_iteration_reference iterated, the final variable sum, the
    hard decision: (hard, ok, the messages after the first iteration)."""
    dg, llr_s, totals, state = TLD._start(cfg, torch.from_numpy(llr))
    first = None
    for _ in range(iterations):
        state = TLD.minsum_iteration_reference(dg, llr_s, state, totals)
        first = TLD.expand_c2v(dg, state) if first is None else first
    TLD.variable_totals_reference(dg, llr_s, state, totals)
    hard, ok = TLD._finish(dg, totals)
    return hard.numpy(), ok.numpy(), first


def _awgn_llrs(seed, n):
    """Codewords through BPSK at 2.5 dB Es/N0: (llr, codewords)."""
    jcfg = _cfg(JC, n)
    rng = np.random.default_rng(seed)
    bb = rng.integers(0, 2, (n, jcfg.kbch)).astype(np.uint8)
    fec = np.asarray(JTX.fec_encode(jcfg, jnp.asarray(bb)))
    sigma = np.sqrt(1 / (2 * 10 ** (2.5 / 10)))
    y = 1.0 - 2.0 * fec.astype(np.float32) + rng.normal(
        0, sigma, fec.shape).astype(np.float32)
    return (2 * y / sigma ** 2).astype(np.float32), fec


def _case_llrs(case):
    """(llr [n, nldpc], iterations) of the short 2/3 code: 3 codewords the
    decoder corrects, or 2 blocks of pure noise it cannot."""
    if case == "awgn":
        return _awgn_llrs(4, 3)[0], 30
    return np.random.default_rng(5).normal(
        0, 1, (2, _cfg(TC).nldpc)).astype(np.float32), 10


@pytest.mark.parametrize("case", ["awgn", "noise"])
def test_minsum_iteration_equals_jax_decode(case):
    """The plain iteration, iterated, gives the reference decode's hard
    bits and ok: every block corrected through AWGN, none on pure noise
    (unconverged bits equal all the same)."""
    llr, its = _case_llrs(case)
    n = llr.shape[0]
    jh, jok = JLD.jit_decode(_cfg(JC, n), its)(jnp.asarray(llr))
    hard, ok, _ = _plain_decode(_cfg(TC, n), llr, its)
    np.testing.assert_array_equal(hard, np.asarray(jh))
    np.testing.assert_array_equal(ok, np.asarray(jok))
    if case == "awgn":
        assert ok.all()
        fec = _awgn_llrs(4, 3)[1]
        np.testing.assert_array_equal(hard, fec)
    else:
        assert not ok.any()


def _jax_one_iter(g, nldpc, llr, c2v):
    """A jax.numpy transcription of the reference's ``one_iter``
    (dtv_utils_tpu/ops/ldpc_decode.py:90-110) on its ``_graph``: c2v
    [b, E] → the next c2v."""
    var, chk = jnp.asarray(g["var"]), jnp.asarray(g["chk"])
    n_par = g["n_parity"]

    def seg_min(x):
        return jax.ops.segment_min(x.T, chk, num_segments=n_par).T

    def seg_sum(x, idx, num):
        return jax.ops.segment_sum(x.T, idx, num_segments=num).T

    totals = llr + seg_sum(c2v, var, nldpc)
    v2c = jnp.take(totals, var, axis=1) - c2v
    mag = jnp.abs(v2c)
    neg = (v2c < 0).astype(jnp.int32)
    m1 = seg_min(mag)
    m1e = jnp.take(m1, chk, axis=1)
    is_min = mag <= m1e
    n_min = seg_sum(is_min.astype(jnp.int32), chk, n_par)
    m2 = seg_min(jnp.where(is_min, jnp.float32(1e30), mag))
    sign_par = seg_sum(neg, chk, n_par) % 2
    other = jnp.where(is_min & (jnp.take(n_min, chk, axis=1) == 1),
                      jnp.take(m2, chk, axis=1), m1e)
    s = 1.0 - 2.0 * ((jnp.take(sign_par, chk, axis=1) ^ neg)
                     .astype(jnp.float32))
    return JLD.MINSUM_SCALE * s * other


@pytest.mark.parametrize("case", ["awgn", "noise"])
def test_expand_c2v_equals_jax_one_iter(case):
    """After iterations 1 and 2 the messages the check state rebuilds are
    the reference iteration's, in edge order, bit for bit."""
    llr, _ = _case_llrs(case)
    n = llr.shape[0]
    jcfg, tcfg = _cfg(JC, n), _cfg(TC, n)
    g = JLD._graph(jcfg)
    c2v = jnp.zeros((n, g["n_edges"]), jnp.float32)
    dg, llr_s, totals, state = TLD._start(tcfg, torch.from_numpy(llr))
    for _ in range(2):
        c2v = _jax_one_iter(g, jcfg.nldpc, jnp.asarray(llr), c2v)
        TLD._variable_totals(dg, llr_s, state, totals)
        state = TLD._check_update(dg, totals, state)
        got = TLD.expand_c2v(dg, state)
        assert got.shape == (g["n_edges"], n)
        np.testing.assert_array_equal(got.T.numpy().view(np.uint32),
                                      np.asarray(c2v).view(np.uint32))


def _check_rule(v2c):
    """The reference's check rule on one check's v2c (float32 numpy)."""
    mag = np.abs(v2c)
    neg = v2c < 0
    m1 = mag.min()
    is_min = mag <= m1
    m2 = np.where(is_min, np.float32(1e30), mag).min()
    other = np.where(is_min & (is_min.sum() == 1), m2, m1)
    s = 1.0 - 2.0 * (neg.sum() % 2 ^ neg)
    return (np.float32(TLD.MINSUM_SCALE) * s.astype(np.float32)
            * other).astype(np.float32)


TIE_CASES = {
    "two_equal_minima": [3.0, -1.0, 2.0, 1.0, -5.0],
    "all_equal": [-2.0, 2.0, 2.0, -2.0, 2.0],
    "zero_magnitudes": [0.0, 4.0, -3.0, 0.0, 1.0],
    "one_zero": [-4.0, 0.0, 3.0, -1.5, 2.5],
    "negative_zero": [-0.0, 1.0, -2.0, 3.0, -0.0],
    "unique_minimum": [7.0, -6.0, 0.25, 5.0, -9.0],
    "unique_minimum_last": [7.0, -6.0, 5.0, 9.0, -0.5],
}


def _tie_values(name, deg):
    """The case's v2c over a check of degree ``deg``: "all_equal" repeated
    over every slot, the others followed by larger magnitudes."""
    v = np.asarray(TIE_CASES[name], np.float32)
    if name == "all_equal":
        return np.resize(v, deg)
    return np.concatenate([v, 50.0 + np.arange(deg - len(v),
                                               dtype=np.float32)])


@pytest.mark.parametrize("name", sorted(TIE_CASES))
def test_state_rebuilds_ties_exactly(name):
    """One check's v2c set through its variables' totals (the first
    messages are +0.0, so v2c = totals): the state rebuilds the
    reference's messages bit for bit, ties, zeros and -0.0 included, with
    the slots rotated in each codeword of the batch; the all-zero state
    rebuilds +0.0."""
    cfg = _cfg(TC, 3)
    dg, llr_s, totals, state = TLD._start(cfg, torch.zeros(3, cfg.nldpc))
    assert not TLD.expand_c2v(dg, state).numpy().view(np.uint32).any()
    t = TLD._tables(cfg)
    p = int(np.argmin(np.diff(t["chk_start"])))
    edges = np.arange(t["chk_start"][p], t["chk_start"][p + 1])
    vals = _tie_values(name, len(edges))
    tot = np.random.default_rng(0).normal(0, 3, (cfg.nldpc, 3)).astype(
        np.float32)
    for b in range(3):
        tot[t["edge_var"][edges], b] = np.roll(vals, b)
    state = TLD._check_update(dg, TLD._to_slices(torch.from_numpy(tot), 32),
                              state)
    got = TLD.expand_c2v(dg, state).numpy()[edges]
    for b in range(3):
        np.testing.assert_array_equal(got[:, b].view(np.uint32),
                                      _check_rule(np.roll(vals, b))
                                      .view(np.uint32))


@pytest.mark.parametrize("batch,cols", [(1, 32), (31, 32), (32, 32),
                                        (33, 32), (202, 32), (202, 64)])
def test_slices_layout_round_trip(batch, cols):
    """_to_slices puts row r, codeword b at slice b // cols, offset
    r·w + b % cols (w the slice's width, the last one ragged), and
    _from_slices inverts it."""
    rows = 5
    x = torch.arange(rows * batch, dtype=torch.int64).view(rows, batch)
    flat = TLD._to_slices(x, cols)
    assert flat.shape == (rows * batch,) and flat.is_contiguous()
    for r, b in ((0, 0), (rows - 1, batch - 1), (2, batch // 2)):
        s = b // cols
        w = min(cols, batch - s * cols)
        assert flat[s * rows * cols + r * w + b % cols] == x[r, b]
    assert torch.equal(TLD._from_slices(flat, rows, batch, cols), x)


def test_var_slots_cover_each_edge_once_in_order():
    """The kernel's variable table ``var_pairs``: every edge once as
    (check, slot), each variable's edges rising (ascending edge order),
    -1 only past a variable's degree, and the same edges as the plain
    version's columns."""
    cfg = _cfg(TC)
    g, t = TLD._graph(cfg), TLD._tables(cfg)
    vp = t["var_pairs"]
    assert vp.dtype == np.int32 and vp.shape[1] == cfg.nldpc
    on = vp >= 0
    edge = np.where(on, t["chk_start"][vp >> TLD.PAIR_SHIFT]
                    + (vp & ((1 << TLD.PAIR_SHIFT) - 1)), -1)
    real = edge[on]
    assert len(real) == g["n_edges"] and len(np.unique(real)) == len(real)
    np.testing.assert_array_equal(on.sum(0), np.bincount(g["var"]))
    for d in range(1, len(vp)):
        assert (on[d - 1][on[d]]).all() and (edge[d][on[d]]
                                             > edge[d - 1][on[d]]).all()
    for d, (n_d, e) in enumerate(t["columns"]):
        np.testing.assert_array_equal(edge[d, :n_d], e)
        np.testing.assert_array_equal(t["edge_var"][e], np.arange(n_d))
        assert not on[d, n_d:].any()


def test_ldpc_check_bound_counts_real_edges():
    """``chip_smoke.ldpc_bounds`` at BBC counts, by bytes, what the kernels
    carry: check — totals read, 16 bytes of state read and written per
    check and codeword, the CSR list of the real edges; variable — the
    state read, llr read, totals written, the [Dv, nldpc] table.  The
    message yardstick (one float message per real edge) stays beside
    it."""
    smoke = _chip_smoke()
    cfg = smoke.dvbt2_bbc()
    g, t, batch = TLD._graph(cfg), TLD._tables(cfg), 202
    edges, n_par, dv = g["n_edges"], g["n_parity"], t["var_pairs"].shape[0]
    assert (edges, n_par, dv) == (215_999, 21_600, 13)
    bounds = smoke.ldpc_bounds(batch, cfg.nldpc, n_par, edges, dv)
    want = {"ldpc_check": 4 * cfg.nldpc * batch + 32 * n_par * batch
            + 4 * (n_par + 1) + 4 * edges,
            "ldpc_variable": 16 * n_par * batch + 8 * cfg.nldpc * batch
            + 4 * dv * cfg.nldpc}
    assert want == {"ldpc_check": 192_931_200, "ldpc_variable": 177_897_600}
    for name, nbytes in want.items():
        ms, by = bounds[name]
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / smoke.HBM_BYTES_PER_S * 1e3,
                                   rel=1e-12)
    old = smoke.ldpc_message_bounds(batch, cfg.nldpc, edges)
    assert old["ldpc_check"] == pytest.approx(
        (4 * (cfg.nldpc + 1) * batch + 8 * edges * batch + 8 * edges)
        / smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    assert old["ldpc_check"] > 2 * bounds["ldpc_check"][0]


def test_ldpc_wrappers_take_plain_version_on_cpu():
    """decode on the CPU is the plain iteration: same hard bits, ok and
    first-iteration messages, no launch; the check wrapper returns the
    plain version's new tensors."""
    llr, _ = _awgn_llrs(6, 2)
    cfg = _cfg(TC)
    before = dict(TLD.LAUNCHES)
    hard, ok = TLD.decode(cfg, torch.from_numpy(llr), iterations=5)
    want_h, want_ok, first = _plain_decode(cfg, llr, 5)
    assert TLD.LAUNCHES == before
    np.testing.assert_array_equal(hard.numpy(), want_h)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    dg, llr_s, totals, state = TLD._start(cfg, torch.from_numpy(llr))
    TLD._variable_totals(dg, llr_s, state, totals)
    out = TLD._check_update(dg, totals, state)
    assert all(o is not s for o, s in zip(out, state))
    assert torch.equal(TLD.expand_c2v(dg, out), first)
    assert TLD.LAUNCHES == before


def test_ldpc_wrappers_reject():
    cfg = _cfg(TC)
    dg, llr_s, totals, state = TLD._start(cfg, torch.zeros(2, cfg.nldpc))
    m1, m2, meta = state
    with pytest.raises(TypeError, match="float32"):
        TLD._variable_totals(dg, llr_s.double(), state, totals)
    with pytest.raises(TypeError, match="int64"):
        TLD._check_update(dg, totals, (m1, m2, meta.int()))
    with pytest.raises(ValueError, match="do not fit|does not fit"):
        TLD._variable_totals(dg, llr_s, state, totals[:-1])
    with pytest.raises(ValueError, match="does not fit"):
        TLD._check_update(dg, totals, (m1[:-2], m2, meta))
    with pytest.raises(ValueError, match="contiguous"):
        TLD._check_update(dg, totals.view(-1, 2).T.reshape(2, -1)[0],
                          state)
    with pytest.raises(ValueError, match="tables on"):
        TLD._check_update(dg, totals.to("meta"), state)
    meta_dg = {**dg, "var_pairs": dg["var_pairs"].to("meta")}
    with pytest.raises(ValueError, match="unsupported device"):
        TLD._check_update(meta_dg, totals.to("meta"),
                          tuple(x.to("meta") for x in state))
    with pytest.raises(ValueError, match="sign bits"):
        TLD._check_update({**dg, "D": TLD.MAX_CHECK_DEGREE + 1}, totals,
                          state)
