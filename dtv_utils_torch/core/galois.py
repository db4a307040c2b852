"""GF(2^m) tables (NumPy, host) and the GF(2) matrix product (torch, device).

The table builders are copies of ``dtv_utils_tpu/core/galois.py``: GF(2^m)
codes are linear over GF(2), so an encoder is a bit-matrix built once on the
host and the device work is one matrix product, ``parity = (bits @ M) & 1``.
``tests/test_torch_core.py`` pins each copied table to the reference's.
"""

from __future__ import annotations

import numpy as np
import torch


class GF:
    """GF(2^m) with log/antilog tables built from a primitive polynomial.

    ``poly`` includes the x^m term, e.g. 0x89 for x^7+x^3+1.
    """

    def __init__(self, poly: int, m: int):
        self.m = m
        self.q = 1 << m
        self.poly = poly
        exp = np.zeros(2 * self.q, dtype=np.int64)
        log = np.zeros(self.q, dtype=np.int64)
        x = 1
        for i in range(self.q - 1):
            if i > 0 and x == 1:  # cycled early → element order < q-1
                raise ValueError(f"0x{poly:x} is not primitive over GF(2^{m})")
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & self.q:
                x ^= poly
        # duplicate so exp[a+b] never needs a mod
        exp[self.q - 1: 2 * (self.q - 1)] = exp[: self.q - 1]
        self.exp = exp
        self.log = log

    def mul(self, a, b):
        """Element-wise GF multiply of integer ndarrays (host-side NumPy)."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        out = self.exp[self.log[a] + self.log[b]]
        return np.where((a == 0) | (b == 0), 0, out)

    def pow_alpha(self, i: int) -> int:
        return int(self.exp[i % (self.q - 1)])

    def rs_generator_poly(self, nroots: int, first_root: int = 0,
                          root_step: int = 1) -> np.ndarray:
        """g(x) = prod_{i}(x + alpha^{first_root + i*root_step}), ascending
        coefficient order, length nroots+1, g[nroots] == 1 (monic)."""
        g = np.zeros(nroots + 1, dtype=np.int64)
        g[0] = 1
        deg = 0
        for i in range(nroots):
            root = self.pow_alpha(first_root + i * root_step)
            ng = np.zeros(nroots + 1, dtype=np.int64)
            ng[1: deg + 2] = g[: deg + 1]                  # x * g
            ng[: deg + 1] ^= self.mul(g[: deg + 1], root)  # + root * g
            g = ng
            deg += 1
        return g

    def rs_encode_ref(self, msg: np.ndarray, genpoly: np.ndarray) -> np.ndarray:
        """Systematic RS encode (batch) by polynomial-division LFSR, returning
        parity symbols highest-degree first.  msg: [..., k] → [..., nroots]."""
        msg = np.asarray(msg, dtype=np.int64)
        nroots = len(genpoly) - 1
        batch = msg.shape[:-1]
        k = msg.shape[-1]
        state = np.zeros(batch + (nroots,), dtype=np.int64)
        taps = genpoly[:nroots]  # ascending order coefficients
        for i in range(k):
            fb = state[..., -1] ^ msg[..., i]
            shifted = np.zeros_like(state)
            shifted[..., 1:] = state[..., :-1]
            state = shifted ^ self.mul(fb[..., None], taps)
        return state[..., ::-1]


GF256 = GF(0x11D, 8)   # DVB field: x^8+x^4+x^3+x^2+1 (EN 300 744 §4.3.2)
GF128 = GF(0x89, 7)    # ITU-T J.83 Annex B field: x^7+x^3+1


def rs_parity_bitmatrix(gf: GF, k_sym: int, genpoly: np.ndarray,
                        msb_first: bool = True) -> np.ndarray:
    """GF(2) matrix M [k_sym*m, nroots*m] with parity_bits = msg_bits @ M mod 2.

    Built by encoding all k_sym*m unit bit-vectors at once through the
    LFSR encoder (RS is GF(2)-linear).
    """
    m = gf.m
    nroots = len(genpoly) - 1
    nbits = k_sym * m
    msgs = np.zeros((nbits, k_sym), dtype=np.int64)
    for i in range(nbits):
        sym, bit = divmod(i, m)
        shift = (m - 1 - bit) if msb_first else bit
        msgs[i, sym] = 1 << shift
    par = gf.rs_encode_ref(msgs, genpoly)  # [nbits, nroots]
    out = np.zeros((nbits, nroots * m), dtype=np.uint8)
    for j in range(m):
        shift = (m - 1 - j) if msb_first else j
        out[:, j::m] = ((par >> shift) & 1).astype(np.uint8)
    return out


def gf2_poly_mod_matrix(genpoly_bits: np.ndarray, k_bits: int) -> np.ndarray:
    """GF(2) parity matrix for a binary BCH/CRC code: data d(x) (k_bits bits,
    first bit = highest degree) → parity = d(x)*x^r mod g(x), r = deg(g).

    genpoly_bits: coefficients of g(x), ascending order, g[r] == 1.
    Returns M [k_bits, r] with parity_bits = data_bits @ M mod 2, parity
    highest-degree first.
    """
    g = np.asarray(genpoly_bits, dtype=np.uint8)
    r = len(g) - 1
    M = np.zeros((k_bits, r), dtype=np.uint8)
    rem = np.zeros(r, dtype=np.uint8)  # ascending coeffs
    rem[0] = 1
    for _ in range(r):
        rem = _gf2_mulx_mod(rem, g)
    # now rem == x^r mod g; assign for the LAST data bit (lowest degree)
    for i in range(k_bits - 1, -1, -1):
        M[i] = rem[::-1]  # store highest-degree-first
        rem = _gf2_mulx_mod(rem, g)
    return M


def _gf2_mulx_mod(rem: np.ndarray, g: np.ndarray) -> np.ndarray:
    r = len(rem)
    carry = rem[r - 1]
    out = np.empty_like(rem)
    out[1:] = rem[:-1]
    out[0] = 0
    if carry:
        out ^= g[:r]
    return out


def gf2_matmul(x_bits: torch.Tensor, mat_bits: torch.Tensor) -> torch.Tensor:
    """Binary matrix product (x @ M) mod 2.

    x_bits: [..., K] in {0,1} (any dtype), mat_bits: [K, P] in {0,1}.
    Returns uint8 [..., P].  CUDA has no integer matmul for these shapes
    (``torch._int_mm`` wants K and P to be multiples of 8; the J.83B shapes
    are 854x35, 889x7 and 1496x8, DVB-T's 1329x1512), so the product runs
    in float32: 0 and 1 are exact even in TF32, and an fp32 sum of at most
    K < 2^24 ones is an exact integer.  Never bf16/fp16: their reductions
    may run in reduced precision.
    """
    if mat_bits.shape[0] >= 1 << 24:
        raise ValueError("K >= 2^24 would make the float32 sum inexact")
    acc = torch.matmul(x_bits.to(torch.float32), mat_bits.to(torch.float32))
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def gf2_polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Multiply binary polynomials (ascending coefficient arrays) mod 2."""
    return (np.convolve(np.asarray(a, np.int64),
                        np.asarray(b, np.int64)) & 1).astype(np.uint8)


def minimal_polynomial(gf: GF, j: int) -> np.ndarray:
    """Minimal polynomial of alpha^j over GF(2), ascending coeffs, monic.

    Computed from the conjugacy class {alpha^(j*2^k)} — this is how the
    DVB BCH generator tables (EN 302 755 / EN 302 307 table 7) are *derived*,
    so building them from the field's primitive polynomial reproduces the
    standard's tables without transcribing them.
    """
    q1 = gf.q - 1
    # conjugacy class exponents
    expos = []
    e = j % q1
    while e not in expos:
        expos.append(e)
        e = (e * 2) % q1
    # poly = prod (x + alpha^e) over the class, coefficients in GF(2^m)
    poly = np.zeros(len(expos) + 1, dtype=np.int64)
    poly[0] = 1
    deg = 0
    for e in expos:
        root = gf.pow_alpha(e)
        ng = np.zeros_like(poly)
        ng[1: deg + 2] = poly[: deg + 1]
        ng[: deg + 1] ^= gf.mul(poly[: deg + 1], root)
        poly = ng
        deg += 1
    assert np.all((poly == 0) | (poly == 1)), "not GF(2)-valued"
    return poly.astype(np.uint8)


def bch_generator_poly(gf: GF, t: int) -> np.ndarray:
    """BCH generator g(x) = prod_{i=1..t} minpoly(alpha^(2i-1)), ascending."""
    g = np.ones(1, dtype=np.uint8)
    for i in range(1, t + 1):
        g = gf2_polymul(g, minimal_polynomial(gf, 2 * i - 1))
    return g


# BCH fields for DVB-T2/S2 FEC (EN 302 755 §6.1 / EN 302 307 §5.3):
# normal FECFRAME over GF(2^16), poly x^16+x^5+x^3+x^2+1 (= table 7's g1);
# short FECFRAME over GF(2^14), poly x^14+x^5+x^3+x+1.
GF2_16_DVB = GF(0x1002D, 16)
GF2_14_DVB = GF(0x402B, 14)
