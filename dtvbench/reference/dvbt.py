"""Plain DVB-T modulator (EN 300 744, non-hierarchical, 8K), the
benchmark's reference.

Every stage is written as the standard describes it: energy dispersal by
the 1 + x^14 + x^15 PRBS, RS(204,188) by its division register, the
I = 12, M = 17 Forney interleaver as out[j] = in[j − 204·(j mod 12)], the
K = 7 (171, 133) mother code as XORs of delayed input bits, puncturing,
demultiplexing and the six 126-bit interleavers, the symbol interleaver
from its register sequence H(q), Gray 64-QAM, pilots and TPS, and the
inverse FFT with its cyclic prefix, in float64.  Its tables are the data
in ``tables/dvbt.json``.  It runs on the device of its input, CPU or
card, and imports nothing of the program.

The stream state between superframes is the dispersal phase (packets mod
8), the last 2244 RS-coded bytes (the interleaver's reach) and the last
6 bits into the convolutional coder (oldest first).
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import common

T = json.loads((Path(__file__).parent / "tables" / "dvbt.json").read_text())
PKT, CODED = 188, 204
OFDM = T["ofdm_8k"]
FFT, K, GUARD = OFDM["fft"], OFDM["carriers"], OFDM["guard_1/32"]
SYMBOLS = OFDM["symbols_per_frame"] * OFDM["frames_per_superframe"]
N_DATA = T["symbol_interleaver_8k"]["Nmax"]
V = 6                                         # bits per 64-QAM cell
ILV = T["outer_interleaver"]
CARRY = ILV["I"] * ILV["M"] * (ILV["I"] - 1)  # 2244 bytes
RATE = "7/8"
PUNCT = T["puncture"][RATE]
PACKETS = N_DATA * SYMBOLS * V * 7 // 8 // (CODED * 8)   # 5292
BLOCK_BYTES = PACKETS * PKT                   # TS bytes per superframe
BLOCK_SAMPLES = SYMBOLS * (FFT + GUARD)       # IQ samples per superframe
HALO_PACKETS = -(-(CARRY + 1) // CODED)       # packets whose coding the
                                              # state at a boundary needs


@dataclass
class State:
    phase: int                  # packets into the 8-packet PRBS period
    carry: torch.Tensor         # uint8 [2244]: the last RS-coded bytes
    conv: torch.Tensor          # uint8 [6]: last coder input bits, oldest first


def init_state(device) -> State:
    return State(0, torch.zeros(CARRY, dtype=torch.uint8, device=device),
                 torch.zeros(6, dtype=torch.uint8, device=device))


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@functools.cache
def dispersal_mask() -> np.ndarray:
    """uint8 [8·188]: the byte XORed onto each byte of an 8-packet group.
    The PRBS starts after the first sync byte, which is inverted; it keeps
    running, unapplied, through the other seven sync bytes."""
    p = T["dispersal_prbs"]
    n = p["packets"] * PKT
    prbs = np.packbits(common.lfsr(p["taps"], p["init"], (n - 1) * 8,
                                   "feedback"))
    mask = np.concatenate([[p["first_sync_mask"]], prbs]).astype(np.uint8)
    mask[PKT::PKT] = 0
    return mask


@functools.cache
def symbol_interleaver() -> np.ndarray:
    """H(q), q < 6048, from the 12-bit register R' (EN 300 744 §4.3.4.2)."""
    s = T["symbol_interleaver_8k"]
    nr, nmax = s["Nr"], s["Nmax"]
    nbits = nr - 1
    r_of = s["r_bit_of_rprime_bit_11_to_0"][::-1]   # index: R' bit 0..11
    h, rp = [], [0] * nbits                          # rp[j] = R' bit j
    for i in range(1 << nr):
        if i == 2:
            rp = [0] * nbits
            rp[0] = 1
        elif i > 2:
            fb = 0
            for t in s["feedback_bits"]:
                fb ^= rp[t]
            rp = rp[1:] + [fb]
        r = sum(rp[j] << r_of[j] for j in range(nbits))
        hq = ((i % 2) << (nr - 1)) + r
        if hq < nmax:
            h.append(hq)
    h = np.asarray(h, dtype=np.int64)
    if len(h) != nmax or len(np.unique(h)) != nmax:
        raise AssertionError("H(q) is not a permutation")
    return h


@functools.cache
def qam64_levels() -> np.ndarray:
    """Axis value of each 3-bit axis word (sign bit first), unnormalised."""
    a = T["qam64_axis"]
    out = np.zeros(8)
    for w in range(8):
        sign = -1.0 if (w >> 2) & 1 else 1.0
        out[w] = sign * a["gray_magnitude"][f"{(w >> 1) & 1}{w & 1}"]
    return out


@functools.cache
def qam64_points() -> np.ndarray:
    """complex64 [64]: the cell of each word y0..y5 (y0 the MSB); the
    even bits y0 y2 y4 give the real axis, the odd bits the imaginary."""
    lv = qam64_levels()
    w = np.arange(64)
    bit = [(w >> (5 - i)) & 1 for i in range(6)]
    re = lv[(bit[0] << 2) | (bit[2] << 1) | bit[4]]
    im = lv[(bit[1] << 2) | (bit[3] << 1) | bit[5]]
    return ((re + 1j * im) / np.sqrt(T["qam64_axis"]["norm"])).astype(
        np.complex64)


@functools.cache
def pilot_signs() -> np.ndarray:
    """2·(1/2 − w_k) for every carrier k."""
    p = T["pilot_prbs"]
    w = common.lfsr(p["taps"], p["init"], K, "last")
    return 1.0 - 2.0 * w.astype(np.float64)


@functools.cache
def tps_bits(frame: int) -> np.ndarray:
    """s0..s67 of frame 0..3 of a superframe, BCH parity included."""
    t = T["tps"]
    s = np.zeros(68, dtype=np.uint8)
    sync = np.asarray(t["sync_odd"], dtype=np.uint8)
    s[1:17] = sync if frame % 2 == 0 else 1 - sync
    s[17:23] = [(t["length_indicator"] >> (5 - i)) & 1 for i in range(6)]
    s[23:25] = [(frame >> 1) & 1, frame & 1]
    s[25:27] = t["constellation_64qam"]
    s[30:33] = t["rate_7/8"]
    s[33:36] = t["rate_7/8"]
    s[36:38] = t["guard_1/32"]
    s[38:40] = t["mode_8k"]
    # BCH(67,53): parity = s1..s53 as a polynomial (s1 the highest
    # degree) times x^14, modulo g(x), highest degree first
    g = np.zeros(15, dtype=np.uint8)
    g[t["bch_poly_exponents"]] = 1
    reg = list(s[1:54]) + [0] * 14
    for i in range(53):
        if reg[i]:
            for d in range(15):
                reg[i + d] ^= int(g[14 - d])
    s[54:68] = reg[53:]
    return s


@functools.cache
def carrier_layout() -> tuple[np.ndarray, np.ndarray]:
    """(data_positions [4, 6048], static [272, K] complex): the carriers
    that take data cells, in increasing order, per scattered-pilot phase,
    and the value of every pilot and TPS carrier of every symbol (0 where
    data goes)."""
    ws = pilot_signs()
    boost = T["pilot_prbs"]["boost"][0] / T["pilot_prbs"]["boost"][1]
    cont = np.asarray(T["continual_pilots_8k"]["carriers"])
    tpsc = np.asarray(T["tps_carriers_8k"]["carriers"])
    sp = T["scattered_pilots"]
    data = np.zeros((4, N_DATA), dtype=np.int64)
    static = np.zeros((SYMBOLS, K), dtype=np.complex128)
    for l in range(SYMBOLS):
        ph = l % 4
        pilots = np.union1d(cont, np.arange(sp["step"] * ph, K,
                                            sp["period"]))
        static[l, pilots] = boost * ws[pilots]
        frame, sym = divmod(l, OFDM["symbols_per_frame"])
        # DBPSK: symbol 0 of a frame sends the reference, each later symbol
        # flips it where its TPS bit is 1
        d = (-1) ** (int(np.sum(tps_bits(frame % 4)[1:sym + 1])) % 2)
        static[l, tpsc] = d * ws[tpsc]
        if l < 4:
            free = np.ones(K, dtype=bool)
            free[pilots] = False
            free[tpsc] = False
            data[ph] = np.nonzero(free)[0]
    return data, static


# ---------------------------------------------------------------------------
# Chain
# ---------------------------------------------------------------------------

def disperse(ts: torch.Tensor, phase: int) -> torch.Tensor:
    """XOR each packet with its PRBS mask row; ``phase`` is the first
    packet's place in the 8-packet period."""
    mask = torch.from_numpy(dispersal_mask()).to(ts.device).reshape(8, PKT)
    n = ts.shape[0] // PKT
    rows = (phase + torch.arange(n, device=ts.device)) % 8
    return (ts.reshape(n, PKT) ^ mask[rows]).reshape(-1)


def rs_encode(packets: torch.Tensor) -> torch.Tensor:
    """uint8 [n, 188] → codewords uint8 [n, 204]."""
    r = T["rs"]
    par = common.rs_parity(packets.to(torch.int64), r["field_poly"], r["m"],
                           r["nroots"], r["first_root"])
    return torch.cat([packets, par.to(torch.uint8)], dim=1)


def outer_interleave(coded: torch.Tensor, carry: torch.Tensor
                     ) -> torch.Tensor:
    """out[j] = in[j − 204·(j mod 12)] over carry ++ coded, for the
    positions of ``coded``."""
    ext = torch.cat([carry, coded])
    j = torch.arange(coded.shape[0], device=coded.device)
    return ext[CARRY + j - ILV["M"] * ILV["I"] * (j % ILV["I"])]


def conv_puncture(bits: torch.Tensor, history: torch.Tensor
                  ) -> torch.Tensor:
    """Mother code (X = 171, Y = 133 octal) over ``bits`` after the six
    ``history`` bits (oldest first), then the 7/8 puncturing, serialised
    X then Y per kept step."""
    c = T["conv_code"]
    ext = torch.cat([history, bits])
    n = bits.shape[0]
    out = []
    for octal in (c["g1_octal"], c["g2_octal"]):
        y = torch.zeros(n, dtype=torch.uint8, device=bits.device)
        for j in common.taps_of_octal(octal, c["K"]):
            y ^= ext[6 - j:6 - j + n]
        out.append(y)
    period = len(PUNCT["X"])
    keep = [2 * i + w for i in range(period)
            for w, pat in ((0, PUNCT["X"]), (1, PUNCT["Y"])) if pat[i]]
    xy = torch.stack(out, dim=1).reshape(-1, 2 * period)
    return xy[:, torch.tensor(keep, device=bits.device)].reshape(-1)


def cell_bit_positions(n_bits: int, device) -> torch.Tensor:
    """int64 [6, n_bits / 6]: the serial position of bit y_e of every
    cell word, for e = 0 … 5: the demultiplexer into six substreams, then
    each substream's 126-bit interleaver H_e(w) = (w + offset_e) mod 126,
    applied to the positions."""
    demux = T["demux"][str(V)]
    bi = T["bit_interleaver"]
    groups = torch.arange(n_bits, device=device).reshape(-1, V)  # x_{6u+j}
    pos = np.argsort(demux)                            # substream e ← j
    sub = torch.stack([groups[:, int(pos[e])] for e in range(V)])
    blocks = sub.reshape(V, -1, bi["block"])
    w = torch.arange(bi["block"], device=device)
    return torch.stack([blocks[e][:, (w + bi["offsets"][e]) % bi["block"]]
                        .reshape(-1) for e in range(V)])


def cell_words(serial: torch.Tensor) -> torch.Tensor:
    """Punctured serial bits → 6-bit cell words (y0 the MSB)."""
    pos = cell_bit_positions(serial.shape[0], serial.device)
    word = torch.zeros(pos.shape[1], dtype=torch.int64, device=serial.device)
    for e in range(V):
        word = (word << 1) | serial[pos[e]].to(torch.int64)
    return word


def symbols_to_carriers(words: torch.Tensor) -> torch.Tensor:
    """Cell words, whole superframes → carriers complex128 [n_sym, K]:
    the symbol interleaver, 64-QAM, and the pilot and TPS values.  The
    cells take float32 values, as the modulator's grid holds them."""
    dev = words.device
    h = torch.from_numpy(symbol_interleaver()).to(dev)
    yp = words.reshape(-1, N_DATA)                     # y'(q) per symbol
    n_sym = yp.shape[0]
    y = torch.empty_like(yp)
    even = torch.arange(0, n_sym, 2, device=dev)
    odd = torch.arange(1, n_sym, 2, device=dev)
    y[even[:, None], h[None, :]] = yp[even]            # y[H(q)] = y'(q)
    y[odd] = yp[odd][:, h]                             # y[q] = y'(H(q))
    points = torch.from_numpy(qam64_points()).to(dev)
    data_pos, static = carrier_layout()
    data_pos = torch.from_numpy(data_pos).to(dev)
    static = torch.from_numpy(static.astype(np.complex64)).to(dev)
    grid = static.repeat(n_sym // SYMBOLS, 1)
    l = torch.arange(n_sym, device=dev)
    grid[l[:, None], data_pos[l % 4]] = points[y]
    return grid.to(torch.complex128)


def carriers_to_iq(grid: torch.Tensor, precision: str = "float64"
                   ) -> torch.Tensor:
    """Carriers [n_sym, K] → IQ [n_sym·(FFT + GUARD)]: carrier k at
    frequency k − 3408 of an unnormalised inverse FFT, the last GUARD
    samples prefixed, times the output scale.  ``precision`` "float64"
    is the reference; "bfloat16" holds the carriers and the output in
    bfloat16, as a modulator one precision below float32 would."""
    n_sym = grid.shape[0]
    spec = torch.zeros((n_sym, FFT), dtype=torch.complex128,
                       device=grid.device)
    k = torch.arange(K, device=grid.device)
    spec[:, (k - (K - 1) // 2) % FFT] = grid
    if precision == "bfloat16":
        spec = _round_bf16(spec)
    elif precision != "float64":
        raise ValueError(f"unknown precision {precision!r}")
    time = torch.fft.ifft(spec, norm="forward")
    out = torch.cat([time[:, FFT - GUARD:], time], dim=1) * T["output_scale"]
    if precision == "bfloat16":
        out = _round_bf16(out)
    return out.reshape(-1)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    r = torch.view_as_real(x).to(torch.bfloat16).to(torch.float64)
    return torch.view_as_complex(r.contiguous())


def encode_to_carriers(ts: torch.Tensor, state: State
                       ) -> tuple[torch.Tensor, State]:
    """Whole superframes of TS bytes (uint8 [n·BLOCK_BYTES]) → carriers
    [n·272, K] and the state after them."""
    if ts.dim() != 1 or ts.shape[0] % BLOCK_BYTES or not ts.shape[0]:
        raise ValueError(f"need whole superframes of {BLOCK_BYTES} bytes")
    n_pkt = ts.shape[0] // PKT
    coded = rs_encode(disperse(ts, state.phase).reshape(n_pkt, PKT))
    coded = coded.reshape(-1)
    outer = outer_interleave(coded, state.carry)
    bits = common.bytes_to_bits(outer)
    serial = conv_puncture(bits, state.conv)
    grid = symbols_to_carriers(cell_words(serial))
    new = State((state.phase + n_pkt) % 8,
                torch.cat([state.carry, coded])[-CARRY:].clone(),
                bits[-6:].clone())
    return grid, new


def modulate(ts: torch.Tensor, state: State, precision: str = "float64"
             ) -> tuple[torch.Tensor, State]:
    """Whole superframes of TS bytes → IQ (complex128) and the state
    after them."""
    grid, new = encode_to_carriers(ts, state)
    return carriers_to_iq(grid, precision), new


def state_at(prev_tail: torch.Tensor, block: int) -> State:
    """The state at the start of superframe ``block`` (≥ 1) of a stream
    that started at superframe 0, from the last HALO_PACKETS packets of TS
    bytes of superframe block − 1: their dispersal, coding and
    interleaving, as the stream itself made them."""
    if block < 1:
        raise ValueError("superframe 0 starts from init_state")
    if prev_tail.shape != (HALO_PACKETS * PKT,):
        raise ValueError(f"need the last {HALO_PACKETS} packets")
    phase = (block * PACKETS - HALO_PACKETS) % 8
    coded = rs_encode(disperse(prev_tail, phase).reshape(HALO_PACKETS, PKT))
    coded = coded.reshape(-1)
    zeros = torch.zeros(CARRY, dtype=torch.uint8, device=coded.device)
    # the tail's interleaved bytes at its end read only bytes of the tail
    last = outer_interleave(coded, zeros)[-1:]
    return State((block * PACKETS) % 8, coded[-CARRY:].clone(),
                 common.bytes_to_bits(last)[-6:].clone())


# ---------------------------------------------------------------------------
# Receive: the soft demap of a capture
# ---------------------------------------------------------------------------

def carriers_of(iq: torch.Tensor) -> torch.Tensor:
    """IQ of whole OFDM symbols → carriers complex128 [n_sym, K]: the
    inverse of ``carriers_to_iq`` (the cyclic prefix dropped)."""
    sym = iq.to(torch.complex128).reshape(-1, FFT + GUARD)[:, GUARD:]
    spec = torch.fft.fft(sym / T["output_scale"], norm="forward")
    k = torch.arange(K, device=iq.device)
    return spec[:, (k - (K - 1) // 2) % FFT]


def data_cells(grid: torch.Tensor) -> torch.Tensor:
    """Carriers of whole superframes → the data cells in the order the
    symbol interleaver took them, y'(q), flattened: the inverse of
    ``symbols_to_carriers``'s data placement."""
    dev = grid.device
    data_pos = torch.from_numpy(carrier_layout()[0]).to(dev)
    h = torch.from_numpy(symbol_interleaver()).to(dev)
    n_sym = grid.shape[0]
    l = torch.arange(n_sym, device=dev)
    y = grid[l[:, None], data_pos[l % 4]]              # y[q]
    yp = torch.empty_like(y)
    yp[0::2] = y[0::2][:, h]                           # y'(q) = y[H(q)]
    yp[1::2, h] = y[1::2]                              # y'(H(q)) = y[q]
    return yp.reshape(-1)


def coded_llrs(iq: torch.Tensor) -> torch.Tensor:
    """IQ of whole superframes, from a superframe's start → the max-log
    LLR float64 of every punctured coder output bit, in stream order
    (positive for bit 0): per axis, the least squared distance to a level
    whose axis word has the bit set, less the least to one where it is
    clear.  The real axis carries y0 y2 y4, the imaginary y1 y3 y5."""
    cells = data_cells(carriers_of(iq))
    lv = torch.from_numpy(qam64_levels() / np.sqrt(
        T["qam64_axis"]["norm"])).to(iq.device)
    w = torch.arange(8, device=iq.device)
    pos = cell_bit_positions(cells.shape[0] * V, iq.device)
    out = torch.empty(cells.shape[0] * V, dtype=torch.float64,
                      device=iq.device)
    for axis, x in enumerate((cells.real, cells.imag)):
        d2 = (x[:, None] - lv[None, :]).square()       # [n, 8]
        for b in range(3):                             # y_(axis + 2b)
            set_ = ((w >> (2 - b)) & 1).bool()
            llr = d2[:, set_].amin(1) - d2[:, ~set_].amin(1)
            out[pos[axis + 2 * b]] = llr
    return out
