"""DVB-T2 P1 preamble (EN 302 755 §9.8) — carrier distribution sequence,
S1/S2 modulation signalling sequences, DBPSK + scrambling, and the C-A-B
guard structure.

A copy of ``dtv_utils_tpu/tx/t2_p1.py`` (host NumPy; the tests pin its
tables and ``tx/dvbt2._p1_samples`` to the reference's, bit for bit).

Reference chain anchor: dvbt2-blade.py:131 instantiates
``dtv.dvbt2_p1insertion_cc(...)``; that external gr-dtv block implements this
clause.  The reference repo itself carries none of these tables, and the
standard text is not available in this environment, so the tables here are
RECONSTRUCTED from their generative structure (verified self-consistent with
independently recalled fragments of the published tables) rather than
transcribed:

  * The 384-entry carrier distribution sequence (CDS) of the 853-carrier 1K
    P1 symbol is a complementary-set sequence.  The generative rule
    ``s_{2n} = s_n ++ (complement-first-half s_n)`` from seed ``[1, 1]``
    reproduces the first 64 published entries (44, 45, 47, 51, 54, 59, 62,
    64, ... 171) exactly.  The three signalling regions carry exactly
    64 + 256 + 64 active carriers (S1, S2, S1-repeat), giving blocks
    [0, 128), [128, 608), [637, 765) of the 765-carrier span 44..808.
  * The 8 S1 patterns (8 bytes each) satisfy S1[r][k] = T[r XOR k] with
    T = (0x12, 0x47, 0x21, 0x74, 0x1D, 0x48, 0x2E, 0x7B); every byte is
    0x12 XOR a combination of the complementary masks {0x55, 0x33, 0x0F}.
  * The 16 S2 patterns (32 bytes each) satisfy S2[r][k] = U[r XOR k] with
    U built from T by two levels of the same half-complement doubling.
  * MSS = S1 ++ S2 ++ S1 (384 bits), DBPSK-modulated then scrambled by the
    clause-9.2.1 reference PRBS (x^11 + x^2 + 1, all-ones init).
  * Guard structure: C (542 samples, frequency-shifted by +f_SH = one
    1K carrier spacing) + A (1024) + B (482, frequency-shifted).

Validation available here (tests/test_t2_p1.py): active-carrier count/span/
block structure, XOR table structure, P1 peak-to-average ~= 10 dB (the CSS
design goal; the previous stand-in measured ~31 dB), and a receiver-style
C/B guard-correlation detection of the P1 start.  Bit-level certification
against the standard text remains open — see PARITY.md.
"""

from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# Carrier distribution sequence (§9.8.2.2)
# ---------------------------------------------------------------------------

P1_CARRIERS = 853          # carriers of the 1K P1 symbol, indices 0..852
P1_ACTIVE = 384
_SPAN_LO, _SPAN_HI = 44, 808


def _css(n: int) -> np.ndarray:
    """Complementary-set bit sequence: s_{2n} = s_n ++ c(s_n) with
    c(x) = (~x[:n/2]) ++ x[n/2:], seed [1, 1]."""
    s = np.array([1, 1], dtype=np.uint8)
    while len(s) < n:
        h = len(s) // 2
        s = np.concatenate([s, np.concatenate([1 - s[:h], s[h:]])])
    return s[:n]


@functools.cache
def p1_active_carriers() -> np.ndarray:
    """The 384 active carriers (ascending, in 0..852).

    Three regions of the CSS sequence: rel [0, 128) carries the 64 S1
    actives, rel [128, 608) the 256 S2 actives, and the S1-repeat block
    reuses the head pattern at the top of the span (rel [637, 765) ->
    carriers 681..808); rel [608, 637) carries no active carriers.
    """
    s = _css(1024)
    head = np.nonzero(s[:128])[0]                      # 64 actives
    mid = 128 + np.nonzero(s[128:608])[0]              # 256 actives
    tail = 637 + head                                  # 64 actives
    rel = np.concatenate([head, mid, tail])
    out = (rel + _SPAN_LO).astype(np.int32)
    assert out.shape == (P1_ACTIVE,) and out[0] == _SPAN_LO \
        and out[-1] == _SPAN_HI
    return out


# ---------------------------------------------------------------------------
# S1 / S2 modulation signalling sequences (§9.8.2.3)
# ---------------------------------------------------------------------------

_T = np.asarray([0x12, 0x47, 0x21, 0x74, 0x1D, 0x48, 0x2E, 0x7B],
                dtype=np.uint8)


@functools.cache
def _u_table() -> np.ndarray:
    """32-byte base row of the S2 patterns: two more levels of the byte
    half-complement doubling g(x) = x[:n/2] ++ ~x[n/2:] applied to T."""
    def g(x):
        h = len(x) // 2
        return np.concatenate([x[:h], x[h:] ^ 0xFF])
    v = np.concatenate([_T, g(_T)])
    return np.concatenate([v, g(v)]).astype(np.uint8)


def s1_pattern(s1: int) -> np.ndarray:
    """64-bit S1 modulation pattern (MSB-first bits of S1[s1][k]=T[s1^k])."""
    assert 0 <= s1 < 8
    by = _T[np.arange(8) ^ s1]
    return np.unpackbits(by)


def s2_pattern(s2: int) -> np.ndarray:
    """256-bit S2 modulation pattern (S2[s2][k] = U[s2 ^ k])."""
    assert 0 <= s2 < 16
    by = _u_table()[np.arange(32) ^ s2]
    return np.unpackbits(by)


def mss_bits(s1: int, s2: int) -> np.ndarray:
    """The 384-bit modulation signalling sequence: S1 ++ S2 ++ S1."""
    h = s1_pattern(s1)
    return np.concatenate([h, s2_pattern(s2), h])


def _p1_prbs(n: int) -> np.ndarray:
    """Clause 9.2.1 reference PRBS: x^11 + x^2 + 1, all-ones init."""
    reg = np.ones(11, dtype=np.int64)
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        out[i] = reg[10]
        fb = reg[10] ^ reg[1]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


@functools.cache
def p1_symbols(s1: int, s2: int) -> np.ndarray:
    """[384] float64 BPSK symbols on the active carriers: MSS bits DBPSK-
    modulated (phase inverts on every 1 bit) then scrambled by the
    reference PRBS."""
    bits = mss_bits(s1, s2) ^ _p1_prbs(P1_ACTIVE)
    diff = np.cumsum(bits) % 2
    return 1.0 - 2.0 * diff.astype(np.float64)


# ---------------------------------------------------------------------------
# Time-domain P1 (§9.8.1): C (542, +f_SH) + A (1024) + B (482, +f_SH)
# ---------------------------------------------------------------------------

P1_LEN = 2048
_C_LEN, _A_LEN, _B_LEN = 542, 1024, 482


def p1_time(s1: int, s2: int, mean_power: float = 1.0) -> np.ndarray:
    """The 2048-sample complex P1, scaled to the requested mean sample
    power over the A part (the caller matches it to the data symbols'
    mean power so the preamble rides at signal level)."""
    spec = np.zeros(1024, dtype=np.complex128)
    # carrier k of the 853 window sits at centered bin k + 86
    # ((1024 - 853 + 1) // 2 = 86), DC = carrier 426
    spec[p1_active_carriers() + (1024 - P1_CARRIERS + 1) // 2] = \
        p1_symbols(s1, s2)
    a = np.fft.ifft(np.fft.ifftshift(spec)) * 1024
    a *= np.sqrt(mean_power / np.mean(np.abs(a) ** 2))
    shift = np.exp(2j * np.pi * np.arange(1024) / 1024)   # f_SH = 1 carrier
    c = (a * shift)[:_C_LEN]
    b = (a * shift)[_C_LEN:]
    out = np.concatenate([c, a, b])
    assert out.shape == (P1_LEN,)
    return out


def detect_p1(x: np.ndarray) -> int:
    """Receiver-style P1 search (the C-A-B correlation the guard structure
    exists for).  C repeats A's head at lag 542 with a +f_SH rotation
    (x[t+k] = x[t+542+k]·e^{j2πk/1024}), and B repeats A's tail at lag 482;
    de-rotating by f_SH makes each product constant-phase so a windowed sum
    adds coherently.  Returns the sample index maximizing the combined
    metric — used by tests to prove the emitted preamble is detectable."""
    n = len(x)
    ph = np.exp(-2j * np.pi * np.arange(n) / 1024)
    prod_c = (x * ph)[: n - _C_LEN] * np.conj(x[_C_LEN:])
    prod_b = (x / ph)[: n - _B_LEN] * np.conj(x[_B_LEN:])
    cc = np.convolve(prod_c, np.ones(_C_LEN), mode="valid")
    cb = np.convolve(prod_b, np.ones(_B_LEN), mode="valid")
    L = n - P1_LEN + 1
    shift = _C_LEN + _A_LEN - _B_LEN
    m = np.abs(cc[:L]) + np.abs(cb[shift:shift + L])
    # The guard-correlation metric has an exact 2-sample plateau
    # {t0, t0+1} at a P1 start (measured: both windows sum the same
    # coherent products to float dust), so a bare argmax lands on t0+1
    # about half the time — one sample late, which desyncs the whole
    # frame FFT.  The true start is the plateau's FIRST index: take the
    # earliest t within a small relative epsilon of the peak (the t0-1
    # neighbour is ~0.4% lower, two orders above the epsilon).
    peak = float(m.max())
    return int(np.argmax(m >= peak * (1.0 - 1e-4)))
