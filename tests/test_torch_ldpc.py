"""The port's min-sum LDPC decoder (dtv_utils_torch.ops.ldpc_decode) against
the JAX reference (dtv_utils_tpu.ops.ldpc_decode), on the CPU.

The same seeded codewords and LLRs go to both packages.  The Tanner graph
is pinned array for array; syndromes are integer sums, so they are equal;
the decoder's hard bits and ``ok`` flags must be equal bit for bit, on a
channel it corrects and on pure noise it cannot, because its one
order-sensitive float sum (each variable's incoming messages) adds in the
reference's order.  The card is held to the port's CPU in
``tests/test_torch_rx_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtv_utils_tpu.core import config as JC
from dtv_utils_tpu.ops import ldpc_decode as JLD
from dtv_utils_tpu.tx import dvbt2 as JTX
from dtv_utils_torch.core import config as TC
from dtv_utils_torch.ops import ldpc_decode as TLD

CONFIGS = {
    "normal_2_3": dict(),
    "normal_3_4": dict(code_rate="R3_4"),
    "short_2_3": dict(frame_size="SHORT"),
}


def _cfg(C, name, fec_blocks=2):
    kw = dict(CONFIGS[name])
    if "code_rate" in kw:
        kw["code_rate"] = C.T2CodeRate[kw["code_rate"]]
    if "frame_size" in kw:
        kw["frame_size"] = C.T2FrameSize[kw["frame_size"]]
    return C.Dvbt2Config(fec_blocks=fec_blocks, ti_blocks=1, **kw)


def _codewords(cfg, n, seed):
    rng = np.random.default_rng(seed)
    bb = rng.integers(0, 2, (n, cfg.kbch)).astype(np.uint8)
    return np.asarray(JTX.fec_encode(cfg, jnp.asarray(bb)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graph_equal(name):
    got, want = TLD._graph(_cfg(TC, name)), JLD._graph(_cfg(JC, name))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert TLD.MINSUM_SCALE == JLD.MINSUM_SCALE


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_variable_table_reads_each_edge_once(name):
    """The prefix columns of the variable-side table hold every edge
    exactly once, each variable's in ascending edge order, and the
    kernel's ``var_pairs`` names the same edges as (check, slot)."""
    cfg = _cfg(TC, name)
    g, t = TLD._graph(cfg), TLD._tables(cfg)
    edges = np.concatenate([e for _, e in t["columns"]])
    assert len(edges) == g["n_edges"] and len(np.unique(edges)) == len(edges)
    assert len(t["columns"][0][1]) == cfg.nldpc
    for n_d, e in t["columns"]:          # column d: variables 0 .. n_d - 1
        np.testing.assert_array_equal(g["var"][e], np.arange(n_d))
    for (_, a), (_, b) in zip(t["columns"], t["columns"][1:]):
        assert (b > a[:len(b)]).all()    # edges rise with the column
    vp = t["var_pairs"]
    for d, (n_d, e) in enumerate(t["columns"]):
        np.testing.assert_array_equal(vp[d, :n_d] >> TLD.PAIR_SHIFT,
                                      g["chk"][e])
        np.testing.assert_array_equal(
            vp[d, :n_d] & ((1 << TLD.PAIR_SHIFT) - 1),
            e - t["chk_start"][g["chk"][e]])
        assert (vp[d, n_d:] == -1).all()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_csr_tables_cover_each_edge_once(name):
    """The check side: ``chk_start`` cuts the check-sorted edges into each
    check's slots, ``edge_var`` is the reference's variable list, every
    edge once; the syndrome's padded ``slot_var`` holds the same edges."""
    cfg = _cfg(TC, name)
    g, t = TLD._graph(cfg), TLD._tables(cfg)
    start = t["chk_start"]
    assert start[0] == 0 and start[-1] == g["n_edges"]
    deg = np.diff(start)
    assert (deg >= 1).all() and deg.max() == t["D"]
    np.testing.assert_array_equal(np.repeat(np.arange(g["n_parity"]), deg),
                                  g["chk"])
    np.testing.assert_array_equal(t["edge_var"], g["var"])
    np.testing.assert_array_equal(t["edge_slot"],
                                  np.arange(g["n_edges"]) - start[g["chk"]])
    sv = t["slot_var"].reshape(g["n_parity"], t["D"])
    for p in (0, 1, g["n_parity"] // 2, g["n_parity"] - 1):
        np.testing.assert_array_equal(sv[p, :deg[p]],
                                      g["var"][start[p]:start[p + 1]])
        assert (sv[p, deg[p]:] == cfg.nldpc).all()


T2_CODES = [(f, r) for f in ("NORMAL", "SHORT")
            for r in ("R1_2", "R3_5", "R2_3", "R3_4", "R4_5", "R5_6")]


@pytest.mark.parametrize("frame,rate", T2_CODES)
def test_check_degree_fits_meta(frame, rate):
    """Every one of the twelve T2 codes has checks of at most
    MAX_CHECK_DEGREE slots, the sign bits the check state's meta holds
    below its unique-slot field (which must also name NO_UNIQUE)."""
    cfg = TC.Dvbt2Config(frame_size=TC.T2FrameSize[frame],
                         code_rate=TC.T2CodeRate[rate], fec_blocks=1,
                         ti_blocks=1)
    t = TLD._tables(cfg)
    assert 14 <= t["D"] <= 42 <= TLD.MAX_CHECK_DEGREE
    assert TLD.NO_UNIQUE >= TLD.MAX_CHECK_DEGREE
    assert TLD.NO_UNIQUE < 1 << (63 - TLD.SLOT_SHIFT)
    assert t["var_pairs"].shape[0] <= 13


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_syndrome_equal(name):
    """Zero on codewords in both packages; one flipped bit flags the same
    checks."""
    jcfg, tcfg = _cfg(JC, name), _cfg(TC, name)
    fec = _codewords(jcfg, 2, seed=0).copy()
    got = TLD.syndrome(tcfg, torch.from_numpy(fec)).numpy()
    assert got.dtype == np.int32 and not got.any()
    fec[1, 1234] ^= 1
    got = TLD.syndrome(tcfg, torch.from_numpy(fec)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JLD.syndrome(jcfg, jnp.asarray(fec))))
    assert got[1].sum() > 0 and not got[0].any()


def _decode_both(name, llr, iterations, fec_blocks):
    jh, jok = JLD.jit_decode(_cfg(JC, name, fec_blocks), iterations)(
        jnp.asarray(llr))
    th, tok = TLD.decode(_cfg(TC, name, fec_blocks), torch.from_numpy(llr),
                         iterations=iterations)
    assert th.dtype == torch.uint8 and tok.dtype == torch.bool
    return np.asarray(jh), np.asarray(jok), th.numpy(), tok.numpy()


def test_minsum_awgn_equals_jax():
    """Rate 2/3 64800 at 2.5 dB Es/N0 (tests/test_ldpc_decode.py): both
    decode every block to the codeword, with equal hard bits."""
    cfg = _cfg(JC, "normal_2_3", 4)
    fec = _codewords(cfg, 4, seed=1)
    rng = np.random.default_rng(2)
    x = 1.0 - 2.0 * fec.astype(np.float32)
    sigma = np.sqrt(1 / (2 * 10 ** (2.5 / 10)))
    y = x + rng.normal(0, sigma, x.shape).astype(np.float32)
    assert ((y < 0) != (fec == 1)).mean() > 0.02     # channel genuinely bad
    llr = (2 * y / sigma ** 2).astype(np.float32)
    jh, jok, th, tok = _decode_both("normal_2_3", llr, 30, 4)
    assert jok.all() and tok.all()
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(th, fec)


def test_minsum_noise_equals_jax():
    """Pure noise, 10 iterations: no block converges in either package,
    and the unconverged hard bits are still equal bit for bit."""
    rng = np.random.default_rng(3)
    cfg = _cfg(JC, "normal_2_3")
    llr = rng.normal(0, 1, (2, cfg.nldpc)).astype(np.float32)
    jh, jok, th, tok = _decode_both("normal_2_3", llr, 10, 2)
    assert not jok.any() and not tok.any()
    np.testing.assert_array_equal(th, jh)
