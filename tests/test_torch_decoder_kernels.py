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

import importlib.util
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
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
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
