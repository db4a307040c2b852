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
    are 854x35, 889x7 and 1496x8), so the product runs in float32: 0 and 1
    are exact even in TF32, and an fp32 sum of at most K < 2^24 ones is an
    exact integer.
    """
    if mat_bits.shape[0] >= 1 << 24:
        raise ValueError("K >= 2^24 would make the float32 sum inexact")
    acc = torch.matmul(x_bits.to(torch.float32), mat_bits.to(torch.float32))
    return (acc.to(torch.int32) & 1).to(torch.uint8)
