"""The port's receiver decoders (dtv_utils_torch.ops.viterbi, ops.rs_decode)
against the JAX reference, on the CPU.

The same seeded inputs go through both packages.  Decoded bits, corrected
words, error counts and ``ok`` flags must be equal: both decoders do exact
arithmetic (integer GF math; Viterbi metrics that round once per add, the
same way in both), so no tolerance applies.  The host tables each package
builds (trellis, syndrome matrix, Chien and Forney tables) are pinned array
for array.  The card is held to the port's CPU in
``tests/test_torch_rx_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtv_utils_tpu.core import galois as jgalois
from dtv_utils_tpu.ops import rs as jrs
from dtv_utils_tpu.ops import rs_decode as JR
from dtv_utils_tpu.ops import viterbi as JV
from dtv_utils_torch.core import galois as tgalois
from dtv_utils_torch.ops import convcode as tconv
from dtv_utils_torch.ops import rs as trs
from dtv_utils_torch.ops import rs_decode as TR
from dtv_utils_torch.ops import viterbi as TV

ALL_RATES = [(1, 2), (2, 3), (3, 4), (5, 6), (7, 8)]
CODES = {"dvbt": (TV.DVBT_K, TV.DVBT_G1, TV.DVBT_G2),
         "j83b": (TV.J83B_K, TV.J83B_G1, TV.J83B_G2)}


def _coded_llrs(rate, n, sigma, seed):
    """n random bits, K=7 encoded and punctured by the port's encoder,
    as ±1 LLRs plus N(0, sigma) noise: (bits, float32 LLRs)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    enc = tconv.conv_encode(torch.from_numpy(bits),
                            torch.zeros(6, dtype=torch.uint8)).numpy()
    kept = enc.reshape(-1)[tconv.puncture_indices(rate, n)]
    llr = 1.0 - 2.0 * kept.astype(np.float32)
    if sigma:
        llr += rng.normal(0, sigma, llr.shape).astype(np.float32)
    return bits, llr


def _jax_punctured(llr, rate, block):
    return np.asarray(JV.viterbi_decode_punctured(jnp.asarray(llr), rate,
                                                  block=block))


def _port_punctured(llr, rate, block):
    out = TV.viterbi_decode_punctured(torch.from_numpy(llr), rate,
                                      block=block)
    assert out.dtype == torch.uint8
    return out.numpy()


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", sorted(CODES))
def test_trellis_tables_equal(code):
    got, want = TV._trellis(*CODES[code]), JV._trellis(*CODES[code])
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype


@pytest.mark.parametrize("k", [5, 7])
@pytest.mark.parametrize("rate", ALL_RATES + [(4, 5)])
def test_seam_overlap_equal(k, rate):
    assert TV.seam_overlap(k, *rate) == JV.seam_overlap(k, *rate)
    assert TV.OVERLAP == JV.OVERLAP


def _decoders(which):
    if which == "dvbt":
        return TR.DVBT_RS_DEC(), JR.DVBT_RS_DEC()
    return (TR.RsDecoder(tgalois.GF128, 122, 5, first_root=1),
            JR.RsDecoder(jgalois.GF128, 122, 5, first_root=1))


@pytest.mark.parametrize("which", ["dvbt", "j83b"])
def test_rs_decoder_tables_equal(which):
    port, ref = _decoders(which)
    for key in ("synd_M", "chien", "xfact"):
        got, want = getattr(port, key), np.asarray(getattr(ref, key))
        np.testing.assert_array_equal(got, want, err_msg=key)
        assert got.dtype == want.dtype, key
    assert (port.n, port.t, port.first_root) == (ref.n, ref.t, ref.first_root)


# ---------------------------------------------------------------------------
# Viterbi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", ALL_RATES)
def test_depuncture_equal(rate):
    llr = np.random.default_rng(9).normal(
        size=sum(map(sum, tconv.PUNCTURE_PATTERNS[rate])) * 7
    ).astype(np.float32)
    want = np.asarray(JV.depuncture(jnp.asarray(llr), rate))
    got = TV.depuncture(torch.from_numpy(llr), rate).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", ALL_RATES)
def test_viterbi_clean_roundtrip(rate):
    bits, llr = _coded_llrs(rate, rate[0] * 2000, 0.0, seed=0)
    np.testing.assert_array_equal(_port_punctured(llr, rate, 512), bits)


def test_viterbi_noisy_equals_jax():
    """Rate 1/2 at sigma 0.5: bit for bit the reference's decisions."""
    bits, llr = _coded_llrs((1, 2), 6000, 0.5, seed=1)
    got = _port_punctured(llr, (1, 2), 512)
    np.testing.assert_array_equal(got, _jax_punctured(llr, (1, 2), 512))
    np.testing.assert_array_equal(got, bits)


def test_viterbi_block_sizes_invisible():
    """Blocks of 256, 1024 and 4096 steps decode the same bits, and the
    same as the reference."""
    rate = (3, 4)
    _, llr = _coded_llrs(rate, 3 * 4000, 0.4, seed=2)
    outs = [_port_punctured(llr, rate, b) for b in (256, 1024, 4096)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[1], outs[2])
    np.testing.assert_array_equal(outs[1], _jax_punctured(llr, rate, 1024))


@pytest.mark.parametrize("seed", range(4))
def test_viterbi_rate78_seam_stress(seed):
    """Rate 7/8 at sigma 0.50, past the QEF point: the blocked decode
    equals the whole-stream (one block) decode, and the reference's."""
    rate = (7, 8)
    n = 7 * 6000
    _, llr = _coded_llrs(rate, n, 0.50, seed=100 + seed)
    blocked = _port_punctured(llr, rate, 1024)
    np.testing.assert_array_equal(blocked, _port_punctured(llr, rate, n))
    np.testing.assert_array_equal(blocked, _jax_punctured(llr, rate, 1024))


def _k5_pairs(n, sigma, seed):
    """n bits through the J.83B K=5 (25,37) code, unpunctured, as (x, y)
    LLR pairs with N(0, sigma) noise."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    d = np.concatenate([np.zeros(4, np.uint8), bits])
    x = d[4:] ^ d[2:-2] ^ d[:-4]                       # 25 octal
    y = d[4:] ^ d[3:-1] ^ d[2:-2] ^ d[1:-3] ^ d[:-4]   # 37 octal
    pairs = 1.0 - 2.0 * np.stack([x, y], -1).astype(np.float32)
    pairs += rng.normal(0, sigma, pairs.shape).astype(np.float32)
    return bits, pairs


def test_viterbi_k5_equals_jax():
    """The J.83B component code: clean round trip, and noisy decisions
    bit for bit the reference's."""
    kw = dict(block=1024, k=TV.J83B_K, g1=TV.J83B_G1, g2=TV.J83B_G2,
              overlap=TV.seam_overlap(TV.J83B_K, 4, 5))
    bits, clean = _k5_pairs(5000, 0.0, seed=3)
    np.testing.assert_array_equal(
        TV.viterbi_decode(torch.from_numpy(clean), **kw).numpy(), bits)
    _, noisy = _k5_pairs(5000, 0.7, seed=4)
    np.testing.assert_array_equal(
        TV.viterbi_decode(torch.from_numpy(noisy), **kw).numpy(),
        np.asarray(JV.viterbi_decode(jnp.asarray(noisy), **kw)))


def test_viterbi_streams_batched_equal_alone():
    """Leading dimensions are independent streams: two streams in one ACS
    pass decode exactly as each does alone."""
    kw = dict(block=512, k=TV.J83B_K, g1=TV.J83B_G1, g2=TV.J83B_G2)
    pairs = np.stack([_k5_pairs(3001, 0.8, seed=s)[1] for s in (5, 6)])
    both = TV.viterbi_decode(torch.from_numpy(pairs), **kw).numpy()
    assert both.shape == (2, 3001)
    for s in range(2):
        np.testing.assert_array_equal(
            both[s], TV.viterbi_decode(torch.from_numpy(pairs[s]),
                                       **kw).numpy())


def test_viterbi_tied_start_takes_first_state():
    """All-erasure input ties every final metric: the traceback starts at
    state 0 (the first maximal index, as jnp.argmax), so every bit is 0."""
    pairs = torch.zeros(300, 2)
    out = TV.viterbi_decode(pairs, block=100)
    want = np.asarray(JV.viterbi_decode(jnp.zeros((300, 2)), block=100))
    np.testing.assert_array_equal(out.numpy(), want)


def test_viterbi_rejects_bad_shapes():
    with pytest.raises(ValueError, match="pairs"):
        TV.viterbi_decode(torch.zeros(10, 3))
    with pytest.raises(ValueError, match="puncture"):
        TV.depuncture(torch.zeros(5), (7, 8))
    assert TV.viterbi_decode(torch.zeros(0, 2)).shape == (0,)


# ---------------------------------------------------------------------------
# Reed-Solomon
# ---------------------------------------------------------------------------

def _corrupt(cw, n_errs, q, rng):
    out = cw.copy()
    for p, ne in enumerate(n_errs):
        pos = rng.choice(cw.shape[1], size=ne, replace=False)
        out[p, pos] ^= rng.integers(1, q, ne).astype(out.dtype)
    return out


def _rs_case(which, seed=3):
    """Codewords of the code with 0..t errors and beyond t (up to 2t+3)."""
    rng = np.random.default_rng(seed)
    if which == "dvbt":
        msgs = rng.integers(0, 256, (96, 188)).astype(np.uint8)
        cw = trs.DVBT_RS().encode_bytes(torch.from_numpy(msgs)).numpy()
        q, t = 256, 8
    else:
        enc = trs.RsBitEncoder(tgalois.GF128, 122, 5, first_root=1)
        msgs = rng.integers(0, 128, (96, 122)).astype(np.int64)
        cw = np.concatenate(
            [msgs, enc.gf.rs_encode_ref(msgs, enc.genpoly)], axis=-1)
        q, t = 128, 2
    n_errs = np.arange(96) % (2 * t + 4)
    return cw, _corrupt(cw, n_errs, q, rng), n_errs, t


@pytest.mark.parametrize("which", ["dvbt", "j83b"])
def test_rs_decode_words_equals_jax(which):
    """Corrected words, n_err and ok equal the reference's for 0..t errors
    and beyond t; up to t the packets are repaired."""
    cw, bad, n_errs, t = _rs_case(which)
    port, ref = _decoders(which)
    got = [a.numpy() for a in port.decode_words(torch.from_numpy(bad))]
    want = [np.asarray(a) for a in ref.decode_words(jnp.asarray(bad))]
    for g, w, name in zip(got, want, ("corrected", "n_err", "ok")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    le_t = n_errs <= t
    np.testing.assert_array_equal(got[0][le_t], cw[le_t])
    np.testing.assert_array_equal(got[1][le_t], n_errs[le_t])
    assert got[2][le_t].all()


def test_rs_decode_bytes_equals_jax():
    cw, bad, n_errs, _ = _rs_case("dvbt", seed=4)
    got = [a.numpy() for a in TR.DVBT_RS_DEC().decode_bytes(
        torch.from_numpy(bad))]
    want = [np.asarray(a) for a in JR.DVBT_RS_DEC().decode_bytes(
        jnp.asarray(bad))]
    assert got[0].dtype == np.uint8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not got[2][n_errs > 10].any()


def test_rs_syndromes_equal():
    _, bad, _, _ = _rs_case("dvbt", seed=5)
    np.testing.assert_array_equal(
        TR.DVBT_RS_DEC().syndromes(torch.from_numpy(bad)).numpy(),
        np.asarray(JR.DVBT_RS_DEC().syndromes(jnp.asarray(bad))))


def test_rs_encoder_pair_round_trip():
    """The port's decoder repairs what the reference's encoder wrote."""
    rng = np.random.default_rng(6)
    msgs = rng.integers(0, 256, (8, 188)).astype(np.uint8)
    cw = np.asarray(jrs.DVBT_RS().encode_bytes(jnp.asarray(msgs)))
    bad = _corrupt(cw, [8] * 8, 256, rng)
    out, n, ok = TR.DVBT_RS_DEC().decode_bytes(torch.from_numpy(bad))
    np.testing.assert_array_equal(out.numpy(), cw)
    assert (n.numpy() == 8).all() and ok.numpy().all()


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 16, 17])
def test_xor_reduce(m):
    x = np.random.default_rng(m).integers(0, 256, (6, 4, m)).astype(np.int32)
    np.testing.assert_array_equal(TR.xor_reduce(torch.from_numpy(x)).numpy(),
                                  np.bitwise_xor.reduce(x, axis=-1))


def test_rs_decoder_rejects():
    with pytest.raises(ValueError, match="GF"):
        TR.RsDecoder(tgalois.GF128, 122, 5).decode_bytes(
            torch.zeros(1, 127, dtype=torch.uint8))
    with pytest.raises(ValueError, match="root_step"):
        TR.RsDecoder(tgalois.GF256, 188, 16, root_step=2)
