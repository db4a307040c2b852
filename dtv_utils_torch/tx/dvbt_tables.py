"""Host-side (NumPy) constant tables for the DVB-T modulator (EN 300 744).

A copy of ``dtv_utils_tpu/tx/dvbt_tables.py``, pinned to it array for array
by ``tests/test_torch_core.py``: interleaver permutations, pilot/TPS carrier
index sets, the per-symbol carrier-assembly gather plan, TPS bits with their
DBPSK signs, and constellation LUTs.  ``tx/dvbt._plan`` composes them and
uploads the result once per device.

Structural self-checks (asserted at build time):
  * bit/symbol interleaver permutations are bijections;
  * for every scattered-pilot phase, exactly 1512 (2k) / 6048 (8k) data
    cells remain after pilots+TPS — this cross-validates the continual-pilot
    and TPS carrier lists against the spec's frame budget.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from dtv_utils_torch.core.config import Constellation, DvbtConfig, TransmissionMode
from dtv_utils_torch.core.galois import gf2_poly_mod_matrix
from dtv_utils_torch.core.prbs import dvbt_pilot_signs

# ---------------------------------------------------------------------------
# Inner bit interleaver (EN 300 744 §4.3.4.1)
# ---------------------------------------------------------------------------

# Demultiplexer (non-hierarchical): input bit x_{i}, j = i mod v, goes to
# substream DEMUX[v][j].
DEMUX = {
    2: (0, 1),
    4: (0, 2, 1, 3),
    6: (0, 2, 4, 1, 3, 5),
}

# H_e(w) = (w + OFFSET[e]) mod 126 per substream e.
BIT_ILV_OFFSETS = (0, 63, 105, 42, 21, 84)
BIT_ILV_BLOCK = 126


def bit_interleaver_indices(v: int, n_cells: int) -> np.ndarray:
    """Gather map [n_cells, v] into the flat punctured bit stream:
    cell_bits[c, e] = stream[ idx[c, e] ]."""
    assert n_cells % BIT_ILV_BLOCK == 0
    demux = DEMUX[v]
    # position of substream e in the serial pattern
    demux_pos = np.argsort(np.asarray(demux))
    c = np.arange(n_cells, dtype=np.int64)
    blk = c // BIT_ILV_BLOCK
    w = c % BIT_ILV_BLOCK
    idx = np.empty((n_cells, v), dtype=np.int64)
    for e in range(v):
        he = (w + BIT_ILV_OFFSETS[e]) % BIT_ILV_BLOCK
        idx[:, e] = (blk * BIT_ILV_BLOCK + he) * v + demux_pos[e]
    assert len(np.unique(idx)) == n_cells * v  # bijection
    return idx


# ---------------------------------------------------------------------------
# Symbol interleaver (EN 300 744 §4.3.4.2)
# ---------------------------------------------------------------------------

# R' -> R wire permutations (EN 300 744 table 7): R bit i = R' bit PERM[i]?
# Convention here: R_bit[BIT_PERM[j]] = R'_bit[j].
SYM_ILV_BIT_PERM = {
    TransmissionMode.M2K: (4, 3, 9, 6, 2, 8, 1, 5, 7, 0),
    TransmissionMode.M8K: (7, 1, 4, 2, 9, 6, 8, 10, 0, 3, 11, 5),
}
# feedback taps of R' (new MSB = XOR of these old bit positions)
SYM_ILV_FEEDBACK = {
    TransmissionMode.M2K: (0, 3),
    TransmissionMode.M8K: (0, 1, 4, 6),
}


def symbol_interleaver_perm(mode: TransmissionMode) -> np.ndarray:
    """H(q) for q = 0..Nmax-1 (a permutation of [0, Nmax))."""
    nmax = mode.data_carriers
    mmax = mode.fft_size
    nr = mmax.bit_length() - 1          # log2(Mmax)
    nbits = nr - 1
    perm = SYM_ILV_BIT_PERM[mode]
    fb = SYM_ILV_FEEDBACK[mode]
    h = np.empty(nmax, dtype=np.int64)
    q = 0
    rp = 0  # R' register as an int, bit j = (rp >> j) & 1
    for i in range(mmax):
        if i == 0 or i == 1:
            rp = 0
        elif i == 2:
            rp = 1
        else:
            newbit = 0
            for t in fb:
                newbit ^= (rp >> t) & 1
            rp = (rp >> 1) | (newbit << (nbits - 1))
        r = 0
        for j in range(nbits):
            r |= ((rp >> j) & 1) << perm[j]
        hi = ((i % 2) << (nr - 1)) | r
        if hi < nmax:
            h[q] = hi
            q += 1
    assert q == nmax
    assert len(np.unique(h)) == nmax
    return h


def symbol_interleaver_gather(mode: TransmissionMode) -> tuple[np.ndarray, np.ndarray]:
    """(even_idx, odd_idx): out[q'] = in[idx[q']] for even / odd symbols.

    Even symbols (l mod 2 == 0): y[H(q)] = y'(q)  → gather with H^{-1}.
    Odd symbols:                 y[q] = y'(H(q))  → gather with H.
    """
    h = symbol_interleaver_perm(mode)
    hinv = np.empty_like(h)
    hinv[h] = np.arange(len(h))
    return hinv, h


# ---------------------------------------------------------------------------
# Constellations (EN 300 744 §4.3.5, non-hierarchical, Gray-mapped)
# ---------------------------------------------------------------------------

def constellation_lut(c: Constellation) -> np.ndarray:
    """LUT [2^v] complex64 indexed by the cell word (y0 = MSB).

    Axis rule: y_even bits → Re, y_odd bits → Im; within an axis the first
    bit is the sign (0 → +) and the remaining bits Gray-code the magnitude
    from outermost (00..) inward.  Normalization to unit average power:
    1/√2, 1/√10, 1/√42 (matches gr-dtv dvbt_map).
    """
    v = c.bits_per_symbol
    half = v // 2
    # magnitude sequence for (half-1) Gray bits, outermost first
    if half == 1:
        mags = np.array([1.0])
        gray_order = [0]
    elif half == 2:
        mags = np.array([3.0, 1.0])
        gray_order = [0, 1]            # bit=0 → 3, bit=1 → 1
    else:
        mags = np.array([7.0, 5.0, 3.0, 1.0])
        gray_order = [0, 1, 3, 2]      # Gray sequence 00,01,11,10 → 7,5,3,1
    mag_of = np.empty(1 << (half - 1))
    for pos, g in enumerate(gray_order):
        mag_of[g] = mags[pos]
    norm = {1: np.sqrt(2.0), 2: np.sqrt(10.0), 3: np.sqrt(42.0)}[half]
    lut = np.empty(1 << v, dtype=np.complex64)
    for word in range(1 << v):
        bits = [(word >> (v - 1 - i)) & 1 for i in range(v)]
        re_bits = bits[0::2]
        im_bits = bits[1::2]

        def axis(b):
            sign = 1.0 - 2.0 * b[0]
            gval = 0
            for x in b[1:]:
                gval = (gval << 1) | x
            return sign * mag_of[gval] if half > 1 else sign
        lut[word] = (axis(re_bits) + 1j * axis(im_bits)) / norm
    return lut


# ---------------------------------------------------------------------------
# Pilots & TPS carriers (EN 300 744 §4.5, tables 8 & 9)
# ---------------------------------------------------------------------------

CONTINUAL_PILOTS_2K = np.array([
    0, 48, 54, 87, 141, 156, 192, 201, 255, 279, 282, 333, 432, 450, 483,
    525, 531, 618, 636, 714, 759, 765, 780, 804, 873, 888, 918, 939, 942,
    969, 984, 1050, 1101, 1107, 1110, 1137, 1140, 1146, 1206, 1269, 1323,
    1377, 1491, 1683, 1704], dtype=np.int64)

TPS_CARRIERS_2K = np.array([
    34, 50, 209, 346, 413, 569, 595, 688, 790, 901, 1073, 1219, 1262, 1286,
    1469, 1594, 1687], dtype=np.int64)


def continual_pilots(mode: TransmissionMode) -> np.ndarray:
    if mode is TransmissionMode.M2K:
        return CONTINUAL_PILOTS_2K
    # 8k set = 2k pattern repeated at +1704k (periodic structure of table 9)
    out = np.unique(np.concatenate(
        [CONTINUAL_PILOTS_2K + 1704 * k for k in range(4)]))
    assert len(out) == 177 and out[-1] == 6816
    return out


def tps_carriers(mode: TransmissionMode) -> np.ndarray:
    if mode is TransmissionMode.M2K:
        return TPS_CARRIERS_2K
    out = np.concatenate([TPS_CARRIERS_2K + 1704 * k for k in range(4)])
    assert len(out) == 68
    return out


def scattered_pilots(mode: TransmissionMode, phase: int) -> np.ndarray:
    """Carrier indices k ≡ 3*(l mod 4) (mod 12) for symbol phase l mod 4."""
    kmax = mode.carriers - 1
    start = 3 * phase
    return np.arange(start, kmax + 1, 12, dtype=np.int64)


# ---------------------------------------------------------------------------
# TPS content (EN 300 744 §4.6)
# ---------------------------------------------------------------------------

TPS_SYNC_ODD = np.array([0, 0, 1, 1, 0, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0],
                        dtype=np.uint8)          # frames 1 & 3 (index 0 & 2)
TPS_SYNC_EVEN = 1 - TPS_SYNC_ODD                  # frames 2 & 4

_TPS_CONST_BITS = {Constellation.QPSK: (0, 0),
                   Constellation.QAM16: (0, 1),
                   Constellation.QAM64: (1, 0)}
_TPS_RATE_BITS = {(1, 2): (0, 0, 0), (2, 3): (0, 0, 1), (3, 4): (0, 1, 0),
                  (5, 6): (0, 1, 1), (7, 8): (1, 0, 0)}
_TPS_GI_BITS = {32: (0, 0), 16: (0, 1), 8: (1, 0), 4: (1, 1)}
_TPS_MODE_BITS = {TransmissionMode.M2K: (0, 0), TransmissionMode.M8K: (0, 1)}

# BCH(67,53), shortened from BCH(127,113):
# g(x) = x^14 + x^9 + x^8 + x^6 + x^5 + x^4 + x^2 + x + 1 (§4.6.2.5)
_TPS_BCH_G = np.zeros(15, dtype=np.uint8)
for _p in (0, 1, 2, 4, 5, 6, 8, 9, 14):
    _TPS_BCH_G[_p] = 1
_TPS_BCH_M = gf2_poly_mod_matrix(_TPS_BCH_G, 53)


def tps_bits(cfg: DvbtConfig, frame: int) -> np.ndarray:
    """s0..s67 for frame index 0..3 within the superframe."""
    s = np.zeros(68, dtype=np.uint8)
    # s0: initialization (not part of the protected/differential content)
    s[1:17] = TPS_SYNC_ODD if frame % 2 == 0 else TPS_SYNC_EVEN
    length = 31 if cfg.cell_id is not None else 23
    s[17:23] = [(length >> (5 - i)) & 1 for i in range(6)]
    s[23] = (frame >> 1) & 1
    s[24] = frame & 1
    s[25:27] = _TPS_CONST_BITS[cfg.constellation]
    s[27:30] = 0                      # non-hierarchical
    s[30:33] = _TPS_RATE_BITS[cfg.code_rate.value]
    s[33:36] = _TPS_RATE_BITS[cfg.code_rate.value]   # LP = HP
    s[36:38] = _TPS_GI_BITS[cfg.guard.denominator]
    s[38:40] = _TPS_MODE_BITS[cfg.mode]
    cell = cfg.cell_id or 0
    s[40:48] = [(cell >> (7 - i)) & 1 for i in range(8)]
    # s48..s53 reserved zeros; s54..s67 BCH parity over s1..s53
    s[54:68] = (s[1:54].astype(np.int64) @ _TPS_BCH_M.astype(np.int64)) & 1
    return s


def tps_dbpsk_signs(cfg: DvbtConfig) -> np.ndarray:
    """d[l] ∈ {+1,-1} for l = 0..271: the differential TPS factor per symbol
    (multiplies the per-carrier init sign 2(1/2-w_k))."""
    out = np.empty(cfg.symbols_per_superframe, dtype=np.float32)
    for f in range(cfg.FRAMES_PER_SUPERFRAME):
        s = tps_bits(cfg, f)
        # differential rule: l=0 → +1; l>=1 → flip iff s[l]==1
        d = np.ones(68, dtype=np.float32)
        flips = np.cumsum(s[1:]) % 2
        d[1:] = 1.0 - 2.0 * flips
        out[f * 68:(f + 1) * 68] = d
    return out


# ---------------------------------------------------------------------------
# Per-symbol carrier assembly
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CarrierPlan:
    """Static gather plan: carriers[l, k] = source[l, gidx[l % 4, k]] where
    source[l] = concat(data_cells[l], static_cells[l])."""
    gidx: np.ndarray          # [4, K] int64 into the concat source
    static_cells: np.ndarray  # [272, K - n_data] complex64
    n_data: int


@functools.cache
def carrier_plan(cfg: DvbtConfig) -> CarrierPlan:
    mode = cfg.mode
    K = mode.carriers
    n_data = mode.data_carriers
    w_sign = dvbt_pilot_signs(K)                  # ±1 per carrier
    cont = continual_pilots(mode)
    tpsc = tps_carriers(mode)
    d = tps_dbpsk_signs(cfg)                      # [272]
    boost = 4.0 / 3.0

    gidx = np.empty((4, K), dtype=np.int64)
    statics = []                                  # per phase: [n_static] cplx
    static_pos = []
    for phase in range(4):
        scat = scattered_pilots(mode, phase)
        pilot_set = np.unique(np.concatenate([cont, scat]))
        is_pilot = np.zeros(K, dtype=bool)
        is_pilot[pilot_set] = True
        is_tps = np.zeros(K, dtype=bool)
        is_tps[tpsc] = True
        assert not np.any(is_pilot & is_tps)
        data_pos = np.where(~is_pilot & ~is_tps)[0]
        assert len(data_pos) == n_data, (phase, len(data_pos))
        # source layout: [data (n_data), pilots, tps]
        src = np.empty(K, dtype=np.int64)
        src[data_pos] = np.arange(n_data)
        src[pilot_set] = n_data + np.arange(len(pilot_set))
        src[tpsc] = n_data + len(pilot_set) + np.arange(len(tpsc))
        gidx[phase] = src
        statics.append(boost * w_sign[pilot_set])
        static_pos.append(pilot_set)

    n_static = K - n_data
    static_cells = np.empty((cfg.symbols_per_superframe, n_static),
                            dtype=np.complex64)
    tps_base = w_sign[tpsc]
    for l in range(cfg.symbols_per_superframe):
        ph = l % 4
        static_cells[l] = np.concatenate(
            [statics[ph], d[l] * tps_base]).astype(np.complex64)
    return CarrierPlan(gidx=gidx, static_cells=static_cells, n_data=n_data)
