"""Plain ITU-T J.83 Annex B 64-QAM modulator, the benchmark's reference.

Transport framing (the sync byte replaced by a CRC-8 of the other 187
bytes), 7-bit symbols, RS(127,122) over GF(128) by its division register
with the extension symbol, the I = 128, J = 4 interleaver as
out[k] = in[k − 512·(k mod 128)], the GF(128) randomizer from its
three-register recurrence, 60 codewords and the 42-bit trailer per frame,
the trellis coder (28-bit groups, two K = 5 rate-4/5 coders, the
differential quadrant precoder), the 64-QAM literal and the
interpolate-by-2 root-raised-cosine filter in float64.  Its tables are
the data in ``tables/j83b.json``.  It runs on the device of its input and
imports nothing of the program.

It modulates a stream from its start, in one call over whole superblocks
(6405 packets each): the receive cells' captures start there.
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path

import numpy as np
import torch

from . import common

T = json.loads((Path(__file__).parent / "tables" / "j83b.json").read_text())
RS = T["rs"]
ILV = T["interleaver"]
FR = T["frame"]
TR = T["trellis"]
N_RS = 2 ** RS["m"]                            # 128 symbols per codeword
FRAME_SYMBOLS = FR["rs_blocks"] * N_RS         # 7680
FRAME_BITS = FRAME_SYMBOLS * RS["m"] + len(FR["fsync_bits"])
BLOCK_BYTES = FR["packets_per_superblock"] * 188
BLOCK_SAMPLES = (FR["frames_per_superblock"] * FRAME_BITS
                 // TR["group_bits"] * 5 * T["rrc"]["samples_per_symbol"])
HIST = T["rrc"]["ntaps"] // 2 - 1              # 49 cells of filter history


@functools.cache
def crc_table() -> np.ndarray:
    """CRC-8 (MSB first, initial 0) of each byte value."""
    poly = sum(1 << e for e in T["framing_checksum"]["poly_exponents"]
               if e < 8)
    out = np.zeros(256, dtype=np.int64)
    for b in range(256):
        r = b
        for _ in range(8):
            r = ((r << 1) ^ poly) & 0xFF if r & 0x80 else (r << 1) & 0xFF
        out[b] = r
    return out


@functools.cache
def randomizer() -> np.ndarray:
    """One frame's 7680 randomizer symbols: registers (r0, r1, r2) start
    at the seed; each step sends r2 and shifts in r2·α^3 + r1."""
    poly, m = RS["field_poly"], RS["m"]
    exp, _ = common.gf_tables(poly, m)
    a3 = int(exp[T["randomizer"]["alpha_power"]])
    r = list(T["randomizer"]["seed"])
    out = np.empty(FRAME_SYMBOLS, dtype=np.int64)
    for i in range(FRAME_SYMBOLS):
        out[i] = r[2]
        r = [common.gf_mul(r[2], a3, poly, m) ^ r[1], r[0], r[1]]
    return out


@functools.cache
def rrc_taps() -> np.ndarray:
    """GNU Radio's firdes.root_raised_cosine(gain, fs, fs/2, rolloff,
    ntaps), float64, scaled so that the taps sum to the gain."""
    p = T["rrc"]
    n, a = p["ntaps"], p["rolloff"]
    taps = np.zeros(n)
    for i in range(n):
        t = (i - n / 2.0) / p["samples_per_symbol"]
        den = 1.0 - (4.0 * a * t) ** 2
        if abs(t) < 1e-12:
            taps[i] = 1.0 - a + 4.0 * a / math.pi
        elif abs(den) < 1e-9:
            taps[i] = (a / math.sqrt(2.0)) * (
                (1.0 + 2.0 / math.pi) * math.sin(math.pi / (4.0 * a))
                + (1.0 - 2.0 / math.pi) * math.cos(math.pi / (4.0 * a)))
        else:
            taps[i] = (math.sin(math.pi * t * (1.0 - a))
                       + 4.0 * a * t * math.cos(math.pi * t * (1.0 + a))
                       ) / (math.pi * t * den)
    return p["gain"] * taps / taps.sum()


def framing(ts: torch.Tensor) -> torch.Tensor:
    """uint8 [n, 188] → the same with byte 0 the CRC-8 of bytes 1..187."""
    table = torch.from_numpy(crc_table()).to(ts.device)
    crc = torch.zeros(ts.shape[0], dtype=torch.int64, device=ts.device)
    for j in range(1, 188):
        crc = table[crc ^ ts[:, j].to(torch.int64)]
    return torch.cat([crc.to(torch.uint8)[:, None], ts[:, 1:]], dim=1)


def rs_encode(msg: torch.Tensor) -> torch.Tensor:
    """int64 [n, 122] → codewords [n, 128]: 5 parity symbols and the XOR
    of all 127 as the extension."""
    par = common.rs_parity(msg, RS["field_poly"], RS["m"], RS["nroots"],
                           RS["first_root"])
    cw = torch.cat([msg, par], dim=1)
    ext = cw[:, 0].clone()
    for j in range(1, cw.shape[1]):
        ext ^= cw[:, j]
    return torch.cat([cw, ext[:, None]], dim=1)


def interleave(symbols: torch.Tensor) -> torch.Tensor:
    """out[k] = in[k − I·J·(k mod I)], zeros before the stream starts."""
    reach = ILV["I"] * ILV["J"] * (ILV["I"] - 1)
    ext = torch.cat([torch.zeros(reach, dtype=symbols.dtype,
                                 device=symbols.device), symbols])
    k = torch.arange(symbols.shape[0], device=symbols.device)
    return ext[reach + k - ILV["I"] * ILV["J"] * (k % ILV["I"])]


def conv45(bits: torch.Tensor) -> torch.Tensor:
    """One substream's coded input bits → its kept bits: the K = 5 (25,
    37 octal) coder from zero memory, punctured 4 → 5."""
    n = bits.shape[0]
    ext = torch.cat([torch.zeros(TR["K"] - 1, dtype=torch.uint8,
                                 device=bits.device), bits])
    outs = []
    for octal in (TR["g1_octal"], TR["g2_octal"]):
        y = torch.zeros(n, dtype=torch.uint8, device=bits.device)
        for j in common.taps_of_octal(octal, TR["K"]):
            y ^= ext[TR["K"] - 1 - j:TR["K"] - 1 - j + n]
        outs.append(y)
    period = len(TR["puncture_X"])
    keep = [2 * i + w for i in range(period)
            for w, pat in ((0, TR["puncture_X"]), (1, TR["puncture_Y"]))
            if pat[i]]
    xy = torch.stack(outs, dim=1).reshape(-1, 2 * period)
    return xy[:, torch.tensor(keep, device=bits.device)].reshape(-1)


def trellis(bits: torch.Tensor) -> torch.Tensor:
    """Frame bits, whole 28-bit groups → 6-bit words, 5 per group.  Even
    bits of a group feed substream A, odd ones B; of each substream's 14
    bits the first 10 go uncoded, two per symbol, and the last 4 through
    its coder.  The uncoded pairs (w, u) of A and (z, v) of B give the
    quadrant increment, which the precoder adds up mod 4 (Gray)."""
    g = bits.reshape(-1, TR["group_bits"])
    n = g.shape[0]
    a, b = g[:, 0::2], g[:, 1::2]
    nu = TR["uncoded_per_substream"]
    ca = conv45(a[:, nu:].reshape(-1)).to(torch.int64)
    cb = conv45(b[:, nu:].reshape(-1)).to(torch.int64)
    ua = a[:, :nu].reshape(n * 5, 2).to(torch.int64)
    ub = b[:, :nu].reshape(n * 5, 2).to(torch.int64)
    w, u = ua[:, 0], ua[:, 1]
    z, v = ub[:, 0], ub[:, 1]
    q = torch.cumsum((w << 1) | (w ^ z), 0) & 3
    W = q >> 1
    Z = W ^ (q & 1)
    return (u << 5) | (v << 4) | (W << 3) | (ca << 2) | (cb << 1) | Z


def encode_to_cells(ts: torch.Tensor) -> torch.Tensor:
    """Whole superblocks of TS bytes from the stream's start → cells
    complex128 [n_symbols]."""
    if ts.dim() != 1 or ts.shape[0] % BLOCK_BYTES or not ts.shape[0]:
        raise ValueError(f"need whole superblocks of {BLOCK_BYTES} bytes")
    dev = ts.device
    framed = framing(ts.reshape(-1, 188)).reshape(-1)
    syms = common.bits_to_words(common.bytes_to_bits(framed), RS["m"])
    cw = rs_encode(syms.reshape(-1, RS["k"])).reshape(-1)
    rnd = torch.from_numpy(randomizer()).to(dev)
    frames = (interleave(cw).reshape(-1, FRAME_SYMBOLS) ^ rnd)
    fsync = torch.tensor(FR["fsync_bits"], dtype=torch.uint8, device=dev)
    bits = torch.cat([common.words_to_bits(frames, RS["m"]),
                      fsync.expand(frames.shape[0], -1)], dim=1)
    words = trellis(bits.reshape(-1))
    pts = torch.tensor(T["constellation_64"]["points"], dtype=torch.float64,
                       device=dev)
    return torch.complex(pts[words, 0], pts[words, 1])


def interpolate(cells: torch.Tensor) -> torch.Tensor:
    """Cells → 2 samples each: out[2m + p] = Σ_k h[2k + p]·c[m − k], zero
    history before the stream, in float64."""
    h = rrc_taps()
    n = cells.shape[0]
    ext = torch.cat([torch.zeros(HIST, dtype=cells.dtype,
                                 device=cells.device), cells])
    out = torch.zeros((n, 2), dtype=cells.dtype, device=cells.device)
    for k in range(len(h) // 2):
        seg = ext[HIST - k:HIST - k + n]
        out[:, 0] += h[2 * k] * seg
        out[:, 1] += h[2 * k + 1] * seg
    return out.reshape(-1)


def modulate(ts: torch.Tensor) -> torch.Tensor:
    """Whole superblocks of TS bytes, from the stream's start → IQ
    complex128."""
    return interpolate(encode_to_cells(ts))


# ---------------------------------------------------------------------------
# Receive: the matched filter
# ---------------------------------------------------------------------------

@functools.cache
def matched_filter_offset() -> int:
    """The receiver's matched filter is the correlation
    y[i] = Σ_j h[j]·x[i + j]; a unit cell m pushed through ``interpolate``
    and correlated with the taps peaks at y[2m + off]."""
    h = rrc_taps()
    n = len(h)
    cells = torch.zeros(2 * n + 1, dtype=torch.complex128)
    cells[n] = 1.0
    out = interpolate(cells).real.numpy()
    resp = np.correlate(out, h, mode="full")[n - 1:]
    return int(np.argmax(np.abs(resp))) - 2 * n


def matched_filter(iq: torch.Tensor) -> torch.Tensor:
    """IQ at 2 samples per symbol, from the stream's start → the matched
    filter's output float64 [n/2, 2] (I, Q) read at y[2m + off], one row
    per symbol, with zeros past the end of the IQ."""
    off = matched_filter_offset()
    h = rrc_taps()
    n_sym = iq.shape[0] // 2
    rails = torch.view_as_real(iq.to(torch.complex128))
    ext = torch.cat([rails, rails.new_zeros((len(h) + 2, 2))])
    y = torch.zeros((n_sym, 2), dtype=torch.float64, device=iq.device)
    for j in range(len(h)):
        y += h[j] * ext[off + j:off + j + 2 * n_sym:2]
    return y
