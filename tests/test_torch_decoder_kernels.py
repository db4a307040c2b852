"""The plain versions of the port's decoder kernels (``csrc/viterbi.cu``,
``csrc/ldpc_minsum.cu``) against the JAX reference, on the CPU.

The kernels run only on the card (``tests/test_torch_rx_gpu.py`` and
``chip_smoke.py`` hold them to these plain versions bit for bit).  Here
the same seeded inputs go through the reference's scans and through the
plain versions, which compute what the kernels compute: the ACS with its
decisions bit-packed as the reference packs them (the word layout the
kernel writes), the traceback from packed words, and the min-sum iteration
on the padded check-major layout the kernels read.  Every comparison is
exact: the arithmetic rounds once per operation in the reference's order.
The wrappers take the plain versions on CPU tensors, count no launch, and
raise on what the kernels do not take.
"""

import importlib.util
from pathlib import Path

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
    hard decision: (hard, ok, c2v after the first iteration)."""
    dg, llr_t, totals, c2v = TLD._start(cfg, torch.from_numpy(llr))
    first = None
    for _ in range(iterations):
        c2v = TLD.minsum_iteration_reference(dg, llr_t, c2v, totals)
        first = c2v if first is None else first
    TLD.variable_totals_reference(dg, llr_t, c2v, totals)
    hard, ok = TLD._finish(cfg, totals)
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


@pytest.mark.parametrize("case", ["awgn", "noise"])
def test_minsum_iteration_equals_jax_decode(case):
    """The plain iteration, iterated, gives the reference decode's hard
    bits and ok: every block corrected through AWGN, none on pure noise
    (unconverged bits equal all the same)."""
    if case == "awgn":
        llr, fec = _awgn_llrs(4, 3)
        its = 30
    else:
        llr = np.random.default_rng(5).normal(
            0, 1, (2, _cfg(TC).nldpc)).astype(np.float32)
        its = 10
    n = llr.shape[0]
    jh, jok = JLD.jit_decode(_cfg(JC, n), its)(jnp.asarray(llr))
    hard, ok, _ = _plain_decode(_cfg(TC, n), llr, its)
    np.testing.assert_array_equal(hard, np.asarray(jh))
    np.testing.assert_array_equal(ok, np.asarray(jok))
    if case == "awgn":
        assert ok.all()
        np.testing.assert_array_equal(hard, fec)
    else:
        assert not ok.any()


def test_var_slots_cover_each_edge_once_in_order():
    """The kernel's per-variable table: every real slot once, each
    variable's slots rising (ascending edge order), -1 only past a
    variable's degree, and the same slots as the plain version's
    columns."""
    cfg = _cfg(TC)
    g, p = TLD._graph(cfg), TLD._padded(cfg)
    vs = p["var_slots"]
    assert vs.dtype == np.int32 and vs.shape[1] == cfg.nldpc
    real = vs[vs >= 0]
    assert len(real) == g["n_edges"] and len(np.unique(real)) == len(real)
    deg = (vs >= 0).sum(0)
    np.testing.assert_array_equal(deg, np.bincount(g["var"]))
    for d in range(1, len(vs)):
        on = vs[d] >= 0
        assert (vs[d - 1][on] >= 0).all() and (vs[d][on] > vs[d - 1][on]).all()
    for d, row in enumerate(vs):
        on = row >= 0
        np.testing.assert_array_equal(p["slot_var"][row[on]],
                                      np.nonzero(on)[0])
    np.testing.assert_array_equal(
        np.sort(real), np.sort(np.concatenate([s for _, s in p["columns"]])))


def test_ldpc_check_bound_counts_real_edges():
    """``chip_smoke.ldpc_bounds``'s check-kernel bound at BBC is the work
    min-sum needs: totals read once, each real edge's message read and
    written and its slot read, by bytes; the padding of each check to D
    slots (the kernel's layout) is not counted."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = smoke.dvbt2_bbc()
    g, D, batch = TLD._graph(cfg), TLD._padded(cfg)["D"], 202
    edges = g["n_edges"]
    ms, by = smoke.ldpc_bounds(batch, cfg.nldpc, edges)["ldpc_check"]
    nbytes = 4 * (cfg.nldpc + 1) * batch + 8 * edges * batch + 8 * edges
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / smoke.HBM_BYTES_PER_S * 1e3,
                               rel=1e-12)
    assert edges < g["n_parity"] * D


def test_ldpc_wrappers_take_plain_version_on_cpu():
    """decode on the CPU is the plain iteration: same hard bits, ok and
    first-iteration messages, no launch; the check wrapper returns the
    plain version's new tensor."""
    llr, _ = _awgn_llrs(6, 2)
    cfg = _cfg(TC)
    before = dict(TLD.LAUNCHES)
    hard, ok = TLD.decode(cfg, torch.from_numpy(llr), iterations=5)
    want_h, want_ok, first = _plain_decode(cfg, llr, 5)
    assert TLD.LAUNCHES == before
    np.testing.assert_array_equal(hard.numpy(), want_h)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    dg, llr_t, totals, c2v = TLD._start(cfg, torch.from_numpy(llr))
    TLD._variable_totals(dg, llr_t, c2v, totals)
    out = TLD._check_update(dg, totals, c2v)
    assert out is not c2v and torch.equal(out, first)
    assert TLD.LAUNCHES == before


def test_ldpc_wrappers_reject():
    cfg = _cfg(TC)
    dg, llr_t, totals, c2v = TLD._start(cfg, torch.zeros(2, cfg.nldpc))
    with pytest.raises(TypeError, match="float32"):
        TLD._variable_totals(dg, llr_t.double(), c2v, totals)
    with pytest.raises(ValueError, match="do not fit"):
        TLD._variable_totals(dg, llr_t, c2v, totals[:-1])
    with pytest.raises(ValueError, match="do not fit"):
        TLD._check_update(dg, totals, c2v[:, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        TLD._check_update(dg, totals, c2v.transpose(0, 2))
    with pytest.raises(ValueError, match="tables on"):
        TLD._check_update(dg, totals.to("meta"), c2v.to("meta"))
    meta = {**dg, "slot_var": dg["slot_var"].to("meta")}
    with pytest.raises(ValueError, match="unsupported device"):
        TLD._check_update(meta, totals.to("meta"), c2v.to("meta"))
