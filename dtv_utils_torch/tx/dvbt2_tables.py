"""DVB-T2 (EN 302 755) static tables and permutations (a copy of
``dtv_utils_tpu/tx/dvbt2_tables.py``; ``tests/test_torch_core.py`` pins
every table to the reference's, array for array).

Everything here is host-side NumPy, built once per config and cached; the
device path consumes only dense index arrays, XOR masks and bit-matrices.

Exactness status (see PARITY.md):
  * BCH generator polynomials — EXACT: derived from the field's primitive
    polynomial via conjugacy classes (core/galois.bch_generator_poly), which
    reproduces EN 302 755 table 7 rather than transcribing it.
  * BB scrambler, parity interleaver, column twist structure, demux
    structure, constellations, rotation angles, cell/time interleaver
    structure — from the standard's algorithmic text.
  * LDPC parity-address tables (annex A) — PARITY-RISK: the annex is a page
    of raw numbers with no generative rule; without the standard text in
    this environment the tables are procedurally generated stand-ins with
    the correct IRA structure (q, row counts, degree profile).  The encoder
    (tx/dvbt2.py) is exact for whatever table is loaded — drop in the real
    annex tables to get standard-compliant output.
  * column-twist values, demux bit maps — recalled values, PARITY-RISK.

Reference chain parameterization: the gr-dtv script dvbt2-blade.py:119-131.
"""

from __future__ import annotations

import functools

import numpy as np

from dtv_utils_torch.core.config import (Dvbt2Config, T2Constellation,
                                         T2FrameSize)
from dtv_utils_torch.core.galois import (GF2_14_DVB, GF2_16_DVB,
                                         bch_generator_poly,
                                         gf2_poly_mod_matrix)

# ---------------------------------------------------------------------------
# BCH (EN 302 755 §6.1, outer code of the FEC frame)
# ---------------------------------------------------------------------------


@functools.cache
def bch_parity_matrix(frame_size: T2FrameSize, t: int,
                      kbch: int) -> np.ndarray:
    """GF(2) matrix [kbch, t*m]: parity = msg_bits @ M (one matmul)."""
    gf = GF2_16_DVB if frame_size is T2FrameSize.NORMAL else GF2_14_DVB
    g = bch_generator_poly(gf, t)
    return gf2_poly_mod_matrix(g, kbch)


# ---------------------------------------------------------------------------
# LDPC (EN 302 755 §6.1.2 / annex A) — IRA accumulator structure
# ---------------------------------------------------------------------------

# Degree profile of the information part per rate index (1..6; 0 = the
# rate-1/4-family code protecting L1-pre):
# (number of leading 360-bit groups with the high degree, high degree).
# All remaining groups have degree 3 (the IRA repeat structure).
_LDPC_PROFILE = {0: (3, 12), 1: (30, 8), 2: (36, 12), 3: (12, 13),
                 4: (18, 12), 5: (18, 11), 6: (15, 13)}


_RATE_FRACTION = {0: (1, 4), 1: (1, 2), 2: (3, 5), 3: (2, 3),
                  4: (3, 4), 5: (4, 5), 6: (5, 6)}


@functools.cache
def ldpc_accumulator_rows(rate_idx: int, nldpc: int, nbch: int,
                          ) -> tuple[tuple[int, ...], ...]:
    """Parity-accumulator address table: one row of addresses per 360-bit
    information group (annex A shape).

    Loads the real annex-A table from dtv_utils_torch/data/t2/ when installed
    (structurally validated — see tx/t2_annex.py).  PARITY-RISK fallback:
    addresses drawn from a seeded PRNG with the standard's structure (every
    address < n_parity, degree profile above); the encoder consumes this
    table generically either way.
    """
    from dtv_utils_torch.tx import t2_annex
    num, den = _RATE_FRACTION[rate_idx]
    loaded = t2_annex.ldpc_rows(nldpc, num, den, nbch)
    if loaded is not None:
        return loaded
    n_parity = nldpc - nbch
    n_groups = nbch // 360
    n_high, deg_high = _LDPC_PROFILE[rate_idx]
    rng = np.random.default_rng(0x1DBC ^ (rate_idx << 16) ^ nldpc)
    rows = []
    for g in range(n_groups):
        deg = deg_high if g < n_high else 3
        # distinct addresses per row, like the annex
        rows.append(tuple(sorted(
            rng.choice(n_parity, size=deg, replace=False).tolist())))
    return tuple(rows)


@functools.cache
def ldpc_edge_arrays(cfg_key: tuple[int, int, int, int]
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(src_bit_idx [E], parity_idx [E]) int32 arrays for the scatter-XOR
    encoder: parity_pre[p] ^= info[src] over all edges.

    cfg_key = (rate_idx, nldpc, nbch, q).
    """
    rate_idx, nldpc, nbch, q = cfg_key
    rows = ldpc_accumulator_rows(rate_idx, nldpc, nbch)
    n_parity = nldpc - nbch
    src, dst = [], []
    for g, addrs in enumerate(rows):
        m = np.arange(360)
        for a in addrs:
            src.append(g * 360 + m)
            dst.append((a + m * q) % n_parity)
    return (np.concatenate(src).astype(np.int32),
            np.concatenate(dst).astype(np.int32))


# ---------------------------------------------------------------------------
# Bit interleaver (§6.1.3): parity interleave + column twist
# ---------------------------------------------------------------------------

# Column-twist parameters tc per (frame size, columns) — EN 302 755 table 11
# (recalled values: PARITY-RISK).
_TWIST = {
    (T2FrameSize.NORMAL, 8): (0, 0, 0, 1, 7, 20, 20, 21),
    (T2FrameSize.NORMAL, 12): (0, 0, 0, 2, 2, 2, 3, 3, 3, 6, 7, 7),
    (T2FrameSize.NORMAL, 16): (0, 2, 2, 2, 2, 3, 7, 15, 16, 20, 22, 22,
                               27, 27, 28, 32),
    (T2FrameSize.SHORT, 8): (0, 0, 0, 1, 7, 20, 20, 21),
    (T2FrameSize.SHORT, 12): (0, 0, 0, 2, 2, 2, 3, 3, 3, 6, 7, 7),
    (T2FrameSize.SHORT, 16): (0, 2, 2, 2, 2, 3, 7, 15, 16, 20, 22, 22,
                              27, 27, 28, 32),
}

_N_COLUMNS = {T2Constellation.QAM16: 8, T2Constellation.QAM64: 12,
              T2Constellation.QAM256: 16}


@functools.cache
def bit_interleaver_perm(cfg: Dvbt2Config) -> np.ndarray | None:
    """Permutation perm[Nldpc] with out[i] = codeword[perm[i]], combining
    parity interleaving and column twist.  None for QPSK (§6.1.3: the bit
    interleaver applies to 16/64/256QAM only)."""
    if cfg.constellation is T2Constellation.QPSK:
        return None
    n = cfg.nldpc
    k = cfg.nbch                      # = Kldpc information length
    q = cfg.ldpc_q
    # parity interleave: u[k + 360 t + s] = c[k + q s + t]
    pperm = np.arange(n, dtype=np.int64)
    t = np.arange(q).repeat(360)               # t index of output positions
    s = np.tile(np.arange(360), q)
    pperm[k:] = k + q * s + t
    # column twist: Nc columns, Nr rows; bit j written to column j//Nr at
    # row (j%Nr + tc[c]) % Nr; read row-wise.
    nc = _N_COLUMNS[cfg.constellation]
    if (cfg.frame_size is T2FrameSize.SHORT
            and cfg.constellation is T2Constellation.QAM256):
        nc = 8
    from dtv_utils_torch.tx import t2_annex
    tc = t2_annex.column_twist(n, nc) or _TWIST[(cfg.frame_size, nc)]
    nr = n // nc
    r = np.arange(nr).repeat(nc)               # output row index
    c = np.tile(np.arange(nc), nr)             # output column index
    j = c * nr + (r - np.asarray(tc)[c]) % nr  # input (twist-written) index
    return pperm[j].astype(np.int32)


# ---------------------------------------------------------------------------
# Bit-to-cell demux (§6.2, table 12) — recalled maps: PARITY-RISK
# ---------------------------------------------------------------------------

# table[d] = output bit position y_i of substream d (Nsub substreams -> two
# cells of v bits each, except QPSK: one cell).
_DEMUX = {
    T2Constellation.QPSK: (0, 1),
    T2Constellation.QAM16: (7, 1, 4, 2, 5, 3, 6, 0),
    T2Constellation.QAM64: (11, 7, 3, 10, 6, 2, 9, 5, 1, 8, 4, 0),
    T2Constellation.QAM256: (15, 1, 13, 3, 8, 11, 9, 5, 10, 6, 4, 2,
                             12, 14, 7, 0),
}
# §6.2: 256-QAM SHORT frames demux to 8 substreams, not 16 (table 12's
# Nldpc=16200 row) — a distinct map, not a truncation of the normal one.
_DEMUX_QAM256_SHORT = (7, 3, 1, 5, 2, 6, 4, 0)


@functools.cache
def demux_perm(cfg: Dvbt2Config) -> np.ndarray:
    """Permutation over one demux group: y[j] = bits[dperm[j]].

    Serial bit i of a group goes to substream i % Nsub (cyclic demux), and
    substream d is output bit position table[d]; groups of Nsub bits yield
    Nsub/v cells.
    """
    from dtv_utils_torch.tx import t2_annex
    if (cfg.constellation is T2Constellation.QAM256
            and cfg.frame_size is T2FrameSize.SHORT):
        fallback = _DEMUX_QAM256_SHORT
        loaded = t2_annex.demux_map(len(fallback), tag="16200_qam256")
    else:
        fallback = _DEMUX[cfg.constellation]
        loaded = t2_annex.demux_map(len(fallback))
    table = np.asarray(loaded if loaded is not None else fallback)
    nsub = len(table)
    dperm = np.empty(nsub, dtype=np.int32)
    for i in range(nsub):
        dperm[table[i]] = i
    return dperm


# ---------------------------------------------------------------------------
# Constellations + rotation (§6.3)
# ---------------------------------------------------------------------------

_NORM = {2: np.sqrt(2.0), 4: np.sqrt(10.0), 6: np.sqrt(42.0),
         8: np.sqrt(170.0)}
ROTATION_DEG = {2: 29.0, 4: 16.8, 6: 8.6, 8: 3.576334375}


def _gray_axis(bits: np.ndarray) -> np.ndarray:
    """Reflected-Gray level map: MSB = sign, 2^nb levels ±1..±(2^nb·2-1)."""
    nb = bits.shape[-1]
    # binary value of gray code
    b = np.zeros(bits.shape[:-1], dtype=np.int64)
    acc = np.zeros_like(b)
    for i in range(nb):
        acc ^= bits[..., i]
        b = (b << 1) | acc
    n_levels = 1 << nb
    # b = 0 .. 2^nb-1 maps to level (n_levels - 1 - 2b) descending from +max
    return (n_levels - 1 - 2 * b).astype(np.float64)


@functools.cache
def constellation_pairs(constellation: T2Constellation,
                        rotation: bool) -> np.ndarray:
    """[2^v, 2] float32 LUT indexed by cell word (y0 = MSB).

    Even bits (y0, y2, ...) form I, odd bits Q (EN 302 755 fig. 12-15, the
    DVB reflected-Gray mapping); normalized to unit mean power; rotated by
    the constellation's angle when rotation is on (§6.3.3).
    """
    v = constellation.bits_per_symbol
    words = np.arange(1 << v)
    bits = (words[:, None] >> np.arange(v - 1, -1, -1)) & 1
    i_lvl = _gray_axis(bits[:, 0::2])
    q_lvl = _gray_axis(bits[:, 1::2])
    pts = (i_lvl + 1j * q_lvl) / _NORM[v]
    if rotation:
        pts = pts * np.exp(1j * np.deg2rad(ROTATION_DEG[v]))
    return np.stack([pts.real, pts.imag], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# Cell interleaver (§6.4) — LFSR-based pseudo-random permutation
# ---------------------------------------------------------------------------

# feedback taps (1-based positions whose XOR feeds the shift-in) and output
# bit-permutation wires per register width Nr-1.  The 2K/8K entries reuse
# EN 300 744 §4.3.4.2's wires (the T2 generator is the same family);
# other widths are structural stand-ins: PARITY-RISK.
# Feedback tap sets proven maximal-length for the corrected (DVB-T
# §4.3.4.2 orientation) recursion below — verified by exhaustive state
# enumeration (r5): each reaches all 2^w - 1 nonzero states.  10 and 12
# are the published DVB-T 2K/8K sets.
_CI_FEEDBACK = {9: (1, 5), 10: (1, 4), 11: (1, 3), 12: (1, 2, 5, 7),
                13: (1, 10, 11, 13), 14: (1, 4, 9, 14)}
_CI_WIRES = {
    10: (0, 7, 5, 1, 8, 2, 6, 9, 3, 4),            # 2K DVB-T wires
    11: (5, 3, 10, 6, 1, 8, 0, 9, 2, 4, 7),
    12: (0, 7, 5, 1, 8, 2, 6, 9, 3, 4, 10, 11),    # 8K-style
    13: (5, 11, 3, 0, 10, 8, 6, 9, 2, 4, 1, 7, 12),
    9: (0, 7, 5, 1, 8, 2, 6, 3, 4),
    14: (0, 7, 5, 1, 8, 2, 6, 9, 3, 4, 10, 11, 12, 13),
}


@functools.cache
def cell_interleaver_perm(n_cells: int) -> np.ndarray:
    """Base permutation P[q] for one FEC block (§6.4): values from a
    maximum-length sequence with bit-permutation wires, keeping the terms
    < n_cells (the EN 300 744 §4.3.4.2 generator schematic: R'_0 = R'_1 = 0,
    R'_2 = 1, then LFSR steps; MSB toggles with i).

    If the stand-in taps for a width are not maximal (the generator cycles
    before covering [0, n_cells)), falls back to a seeded pseudo-random
    permutation — still a valid interleaver, flagged PARITY-RISK."""
    nbits = max(int(np.ceil(np.log2(n_cells))), 2)
    width = nbits - 1
    from dtv_utils_torch.tx import t2_annex
    fb = (t2_annex.lfsr_feedback(f"ci_{width}", width)
          or _CI_FEEDBACK.get(width, (1, width // 2)))
    wires = (t2_annex.lfsr_wires(f"ci_{width}", width)
             or _CI_WIRES.get(width, tuple(range(width))))
    out = np.empty(n_cells, dtype=np.int32)
    reg = np.zeros(width, dtype=np.int64)
    count = 0
    i = 0
    limit = 4 << nbits
    while count < n_cells and i < limit:
        if i == 2:
            reg[:] = 0
            reg[0] = 1
        elif i > 2:
            # DVB-T §4.3.4.2 orientation: the register shifts DOWN and
            # the feedback bit enters at the TOP.  (r5 fix: the previous
            # shift-up-feedback-at-0 recursion cycled after ~22 states
            # for every width, so the generator ALWAYS hit the
            # pseudo-random fallback — silently.)
            fb_bit = 0
            for t in fb:
                fb_bit ^= reg[t - 1]
            reg[:-1] = reg[1:]
            reg[-1] = fb_bit
        val = (i % 2) << (nbits - 1)      # toggling MSB
        for b in range(width):
            val |= int(reg[b]) << wires[b]
        if val < n_cells:
            out[count] = val
            count += 1
        i += 1
    if count < n_cells or len(np.unique(out)) != n_cells:
        import warnings
        warnings.warn(
            f"cell_interleaver_perm({n_cells}): LFSR generator not "
            "maximal for this width — falling back to a seeded "
            "pseudo-random permutation (PARITY-RISK)", stacklevel=2)
        rng = np.random.default_rng(0xCE11 ^ n_cells)
        out = rng.permutation(n_cells).astype(np.int32)
    return out


def cell_interleaver_shifts(n_blocks: int, n_cells: int) -> np.ndarray:
    """Per-FEC-block shift S(r) (§6.4): successive values of an auxiliary
    maximum-length generator (stand-in: same generator re-used, taking every
    other value — PARITY-RISK)."""
    base = cell_interleaver_perm(n_cells)
    idx = (np.arange(n_blocks, dtype=np.int64) * 997) % n_cells
    return base[idx].astype(np.int32)


# ---------------------------------------------------------------------------
# Frame geometry: per-symbol data-cell carrier maps (§8.3, §9.2)
# ---------------------------------------------------------------------------
# Scattered-pilot amplitudes per pattern (EN 302 755 table 48)
SP_AMPLITUDE = {1: 4 / 3, 2: 4 / 3, 3: 7 / 4, 4: 7 / 4,
                5: 7 / 3, 6: 7 / 3, 7: 7 / 3, 8: 7 / 3}
CP_AMPLITUDE = {1024: 4 / 3, 2048: 4 / 3, 4096: 4 / 3, 8192: 4 / 3,
                16384: 4 / 3, 32768: 8 / 3}
EDGE_AMPLITUDE = 4 / 3
P2_AMPLITUDE = 4 / 3        # PARITY-RISK recalled default; overridable by
#                             data/t2/scalar_p2_amplitude.txt (spec value
#                             is FFT-dependent — t2_annex.scalar loader)


def p2_amplitude() -> float:
    from dtv_utils_torch.tx import t2_annex
    loaded = t2_annex.scalar("p2_amplitude")
    return P2_AMPLITUDE if loaded is None else loaded

# number of continual pilots inserted by the stand-in plan (real sets are
# annex tables: PARITY-RISK; counts kept small so the exact-budget trim in
# frame_plan always lands on C_DATA)
_CP_STANDIN_COUNT = {1024: 10, 2048: 15, 4096: 20, 8192: 30,
                     16384: 40, 32768: 50}


@functools.cache
def _budget_point(cfg: Dvbt2Config):
    """(c_p2, c_data, n_fc, c_fc, fc_present) from the rate-oracle tables."""
    from dtv_utils_torch.rates import dvbt2 as R
    c_p2 = R.C_P2_SISO[cfg.fft_size]
    row = R.CELL_TABLE[(cfg.fft_size, cfg.extended_carriers)]
    c_data, n_fc, c_fc = row[cfg.pilot_pattern.number - 1]
    assert c_data > 0, "pilot pattern unsupported for this FFT size"
    fc = n_fc > 0 and (cfg.guard.oracle_idx,
                       cfg.pilot_pattern.number) not in R.FC_SUPPRESSED
    # GI 1/4 etc: FC only exists for certain GI (dvbt2rate suppression rules)
    return c_p2, c_data, n_fc, c_fc, fc


@functools.cache
def frame_plan(cfg: Dvbt2Config):
    """Per-symbol carrier maps for one T2 frame.

    Returns dict with:
      data_idx   int32 [L_F, Cmax]  carrier index of each data cell (rows
                 padded with -1 past the symbol's capacity)
      data_cnt   int32 [L_F]        data cells per symbol
      sp_idx/sp_cnt, cp_idx, edge amplitudes — pilot scatter plans
      pilot_sign uint8 [K]          reference-PRBS sign per carrier
    Counts are forced exactly to the dvbt2rate budget tables (trim cells
    become reserved-null: PARITY-RISK vs the real annex pilot sets).
    """
    from dtv_utils_torch.core.prbs import dvbt_pilot_prbs
    K = cfg.carriers
    c_p2, c_data, n_fc, c_fc, fc = _budget_point(cfg)
    n_p2 = cfg.n_p2
    lf = cfg.frame_symbols
    dx, dy = cfg.pilot_pattern.dx, cfg.pilot_pattern.dy
    p2_mod = 6 if cfg.fft_size == 32768 else 3

    from dtv_utils_torch.tx import t2_annex
    rng = np.random.default_rng(0x7E57 ^ cfg.fft_size)
    # continual pilots: annex data file when installed, else stand-in
    # spread over the band, never edges
    cp_set = t2_annex.continual_pilots(cfg.fft_size, K)
    if cp_set is None:
        cp_set = np.sort(rng.choice(
            np.arange(7, K - 7), size=_CP_STANDIN_COUNT[cfg.fft_size],
            replace=False))

    # P2 TR reservation: C_P2 tables already exclude TR_CELLS
    from dtv_utils_torch.rates.dvbt2 import TR_CELLS
    n_tr = TR_CELLS[cfg.fft_size]
    tr_p2 = t2_annex.tr_positions(cfg.fft_size, K, n_tr, p2=True)
    if tr_p2 is None:
        p2_nonpilot = np.asarray([k for k in range(K) if k % p2_mod != 0])
        tr_p2 = p2_nonpilot[:: max(len(p2_nonpilot) // n_tr, 1)][:n_tr]

    # TR reservation on data/FC symbols (§9.6.2 / annex H): when PAPR TR is
    # active the cell budget loses TR_CELLS per data and FC symbol (exactly
    # dvbt2rate's budget_papr, rates/dvbt2.py:193-199) and the TR carriers
    # are excluded from data on EVERY symbol, so the correction energy that
    # papr_reduce_tr injects lands only on cells a receiver skips.  Stand-in
    # positions (annex H values unavailable: PARITY-RISK): residues mod dx
    # != 0 so the set never collides with a scattered pilot at any symbol
    # phase, and the continual-pilot/edge carriers are excluded.
    cp_lookup = set(cp_set.tolist())
    if cfg.papr_tr:
        tr_data = t2_annex.tr_positions(cfg.fft_size, K, n_tr, p2=False)
        if tr_data is None:
            cand = np.asarray([k for k in range(7, K - 7)
                               if k % dx != 0 and k not in cp_lookup])
            # pseudo-random (not strided): an evenly spaced set would make
            # the TR kernel a picket-fence impulse train creating new peaks
            tr_rng = np.random.default_rng(0x7A9 ^ cfg.fft_size)
            tr_data = np.sort(tr_rng.choice(cand, size=n_tr, replace=False))
        assert len(set(tr_data.tolist())) == n_tr
    else:
        tr_data = np.empty(0, dtype=np.int64)
    tr_lookup = set(tr_data.tolist())
    # built once, not per carrier as in the reference: the per-carrier tests
    # below are the hot part of the host plan at 32K
    tr_p2_lookup = set(tr_p2.tolist())

    data_rows, cnts = [], []
    sp_rows, sp_cnts = [], []
    for l in range(lf):
        if l < n_p2:
            pil = set(range(0, K, p2_mod))
            data = [k for k in range(K) if k not in pil
                    and k not in tr_p2_lookup]
            target = c_p2
            sp = np.asarray(sorted(pil), dtype=np.int64)
        else:
            last = l == lf - 1
            if last and fc:
                sp_pos = set(range(0, K, dx))
                target = c_fc
            else:
                ph = (l - n_p2) % dy  # scattered phase advances per symbol
                sp_pos = set(range((dx * ph) % (dx * dy), K, dx * dy))
                target = c_data
            if cfg.papr_tr:
                target -= n_tr               # budget_papr operating point
            pil = sp_pos | {0, K - 1} | cp_lookup | tr_lookup
            data = [k for k in range(K) if k not in pil]
            sp = np.asarray(sorted(sp_pos | {0, K - 1}), dtype=np.int64)
        assert len(data) >= target, (l, len(data), target)
        data = data[:target]          # exact-budget trim (reserved nulls)
        data_rows.append(data)
        cnts.append(target)
        sp_rows.append(sp)
        sp_cnts.append(len(sp))

    cmax = max(cnts)
    data_idx = np.full((lf, cmax), -1, dtype=np.int32)
    for l, row in enumerate(data_rows):
        data_idx[l, :len(row)] = row
    smax = max(sp_cnts)
    sp_idx = np.full((lf, smax), 0, dtype=np.int32)
    sp_valid = np.zeros((lf, smax), dtype=bool)
    for l, row in enumerate(sp_rows):
        sp_idx[l, :len(row)] = row
        sp_valid[l, :len(row)] = True

    w = dvbt_pilot_prbs(K)            # x^11 + x^2 + 1 reference sequence
    pilot_sign = (1.0 - 2.0 * w.astype(np.float64))

    # per-symbol pilot amplitude: P2 rows vs SP rows vs FC row
    amp = np.full(lf, SP_AMPLITUDE[cfg.pilot_pattern.number])
    amp[:n_p2] = p2_amplitude()

    return dict(data_idx=data_idx, data_cnt=np.asarray(cnts, np.int32),
                sp_idx=sp_idx, sp_valid=sp_valid, amp=amp,
                pilot_sign=pilot_sign.astype(np.float32),
                cp_set=cp_set.astype(np.int32),
                tr_data=tr_data.astype(np.int32),
                tr_p2=tr_p2.astype(np.int32),
                budget=(c_p2, c_data, n_fc, c_fc, fc))


@functools.cache
def freq_interleaver_perms(cfg: Dvbt2Config) -> tuple[np.ndarray, np.ndarray]:
    """(H_even, H_odd) permutations over the max data-cell count (§8.5).

    Structure: LFSR-derived pseudo-random permutations, distinct for even
    and odd symbols.  Wire tables per FFT size are annex data: stand-in
    generator, PARITY-RISK."""
    c_p2, c_data, n_fc, c_fc, fc = _budget_point(cfg)
    cmax = max(c_p2, c_data, n_fc if fc else 0)
    base = cell_interleaver_perm(cmax)
    h_even = base
    # odd permutation: the spec derives H1 from H0's generator with an
    # offset; stand-in: reversed-bit-order variant
    h_odd = base[::-1].copy()
    return h_even.astype(np.int32), h_odd.astype(np.int32)


# ---------------------------------------------------------------------------
# L1 signaling (§7) — sizing exact (shared with rates/), tables stand-in
# ---------------------------------------------------------------------------

L1PRE_CELLS = 1840
L1PRE_KSIG = 200
# L1-pre protection: shortened/punctured short-frame code, rate-1/4 family
L1PRE_KBCH = 3072
L1PRE_NBCH = 3240

L1POST_KBCH = 7032       # rate-1/2 short (dvbt2rate.c:25 KBCH_1_2)
L1POST_NBCH = 7200
L1POST_KSIG = 350        # one PLP, no aux (KSIG_POST)


def l1_sizes(l1_constellation: int, n_p2: int) -> tuple[int, int, int]:
    """(n_post, n_punc, eta) — exact per dvbt2rate.c:1064-1074."""
    from dtv_utils_torch.rates.dvbt2 import ETA_MOD, l1_post_cells
    eta = ETA_MOD[l1_constellation]
    n_post, _d_l1 = l1_post_cells(eta, n_p2)
    n_punc_temp = (6 * (L1POST_KBCH - L1POST_KSIG)) // 5
    n_post_temp = L1POST_KSIG + 168 + 9000 - n_punc_temp
    n_punc = n_punc_temp - (n_post - n_post_temp)
    return n_post, n_punc, eta


# ---------------------------------------------------------------------------
# L1 field packing (§7.2) + CRC-32
# ---------------------------------------------------------------------------

def crc32_mpeg(bits: np.ndarray) -> np.ndarray:
    """DVB/MPEG CRC-32 (poly 0x04C11DB7, init all-ones, no reflect/xor-out)
    over a bit array; returns 32 bits MSB-first."""
    reg = 0xFFFFFFFF
    for b in bits:
        fb = ((reg >> 31) & 1) ^ int(b)
        reg = (reg << 1) & 0xFFFFFFFF
        if fb:
            reg ^= 0x04C11DB7
    return np.asarray([(reg >> (31 - i)) & 1 for i in range(32)],
                      dtype=np.uint8)


def _pack(fields: list[tuple[int, int]]) -> np.ndarray:
    """[(value, width), ...] -> bit array MSB-first."""
    out = []
    for val, width in fields:
        out.extend((val >> (width - 1 - i)) & 1 for i in range(width))
    return np.asarray(out, dtype=np.uint8)


_S2_FFT_CODE = {1024: 0, 2048: 1, 4096: 2, 8192: 3, 16384: 4, 32768: 5}
_GI_CODE = {(1, 32): 0, (1, 16): 1, (1, 8): 2, (1, 4): 3, (1, 128): 4,
            (19, 128): 5, (19, 256): 6}
_PLP_MOD = {2: 0, 4: 1, 6: 2, 8: 3}
_PLP_COD = {1: 0, 2: 1, 3: 2, 4: 3, 5: 4, 6: 5}


@functools.cache
def l1_pre_bits(cfg: Dvbt2Config) -> np.ndarray:
    """200-bit L1-pre signalling (EN 302 755 table 20; 168 fields + CRC32).

    Values follow the reference framemapper parameterization
    (dvbt2-blade.py:126: l1 16QAM, 2 T2 frames/superframe, PP7 etc.)."""
    n_post, _n_punc, _eta = l1_sizes(cfg.l1_constellation, cfg.n_p2)
    fields = [
        (0x00, 8),                                   # TYPE: TS only
        (int(cfg.extended_carriers), 1),             # BWT_EXT
        (0, 3),                                      # S1: T2_SISO
        (_S2_FFT_CODE[cfg.fft_size] << 1, 4),        # S2 (field1 + mixed=0)
        (0, 1),                                      # L1_REPETITION_FLAG
        (_GI_CODE[(cfg.guard.value[0], cfg.guard.value[1])], 3),   # GUARD
        (int(cfg.papr_tr), 4),                       # PAPR
        (cfg.l1_constellation, 4),                   # L1_MOD
        (0, 2),                                      # L1_COD (rate 1/2)
        (0, 2),                                      # L1_FEC_TYPE (16200)
        (n_post, 18),                                # L1_POST_SIZE (cells*eta)
        (L1POST_KSIG - 32, 18),                      # L1_POST_INFO_SIZE
        (cfg.pilot_pattern.number, 4),               # PILOT_PATTERN
        (0xFF, 8),                                   # TX_ID_AVAILABILITY
        (0x3085, 16),                                # CELL_ID
        (0x3085, 16),                                # NETWORK_ID
        (0x8001, 16),                                # T2_SYSTEM_ID
        (2, 8),                                      # NUM_T2_FRAMES
        (cfg.data_symbols, 12),                      # NUM_DATA_SYMBOLS
        (0, 3),                                      # REGEN_FLAG
        (0, 1),                                      # L1_POST_EXTENSION
        (1, 3),                                      # NUM_RF
        (0, 3),                                      # CURRENT_RF_IDX
        (0 if cfg.version_111 else 1, 4),            # T2_VERSION
        (0, 1),                                      # L1_POST_SCRAMBLED
        (0, 1),                                      # T2_BASE_LITE
        (0, 4),                                      # RESERVED
    ]
    bits = _pack(fields)
    assert len(bits) == 168, len(bits)
    return np.concatenate([bits, crc32_mpeg(bits)])


def l1_post_bits(cfg: Dvbt2Config, frame_idx: int = 0,
                 plp_start: int = 0) -> np.ndarray:
    """350-bit L1-post (configurable + dynamic + CRC32) for one type-1 PLP
    (EN 302 755 §7.2.3; field widths sum to KSIG_POST)."""
    config = [
        (0, 15),                     # SUB_SLICES_PER_FRAME
        (1, 8),                      # NUM_PLP
        (0, 4),                      # NUM_AUX
        (0, 8),                      # AUX_CONFIG_RFU
        (0, 3),                      # RF_IDX
        (0x29B92700, 32),            # FREQUENCY (698 MHz)
        # PLP loop (one PLP):
        (0, 8),                      # PLP_ID
        (1, 3),                      # PLP_TYPE: type 1
        (3, 5),                      # PLP_PAYLOAD_TYPE: TS
        (0, 1),                      # FF_FLAG
        (0, 3),                      # FIRST_RF_IDX
        (0, 8),                      # FIRST_FRAME_IDX
        (0, 8),                      # PLP_GROUP_ID
        (_PLP_COD[cfg.code_rate.value], 3),          # PLP_COD
        (_PLP_MOD[cfg.constellation.value], 3),      # PLP_MOD
        (int(cfg.rotation), 1),      # PLP_ROTATION
        (0 if cfg.frame_size.name == "NORMAL" else 1, 2),  # PLP_FEC_TYPE
        (cfg.fec_blocks, 10),        # PLP_NUM_BLOCKS_MAX
        (1, 8),                      # FRAME_INTERVAL
        (cfg.ti_blocks, 8),          # TIME_IL_LENGTH
        (0, 1),                      # TIME_IL_TYPE
        (0, 1), (0, 1),              # IN_BAND_A/B
        (0, 11),                     # RESERVED_1
        (0, 2),                      # PLP_MODE
        (1, 1),                      # STATIC_FLAG
        (1, 1),                      # STATIC_PADDING_FLAG
        # end PLP loop
        (0, 2),                      # FEF_LENGTH_MSB
        (0, 30),                     # RESERVED_2
    ]
    dynamic = [
        (frame_idx, 8),              # FRAME_IDX
        (0, 22),                     # SUB_SLICE_INTERVAL
        (0, 22),                     # TYPE_2_START
        (0, 8),                      # L1_CHANGE_COUNTER
        (0, 3),                      # START_RF_IDX
        (0, 8),                      # RESERVED_1
        (0, 8),                      # PLP_ID
        (plp_start, 22),             # PLP_START
        (cfg.fec_blocks, 10),        # PLP_NUM_BLOCKS
        (0, 8),                      # RESERVED_2
        (0, 8),                      # RESERVED_3 (aux loop empty)
    ]
    bits = np.concatenate([_pack(config), _pack(dynamic)])
    assert len(bits) == L1POST_KSIG - 32, len(bits)
    return np.concatenate([bits, crc32_mpeg(bits)])
