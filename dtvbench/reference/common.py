"""Plain building blocks shared by the reference modulators: Galois-field
tables, a byte-serial Reed-Solomon encoder run over many codewords at once,
Fibonacci LFSRs and bit packing.

Everything here follows the textbook definitions one step at a time; the
only vectorisation is across codewords, packets or bits that do not depend
on each other.  It imports torch and numpy and nothing of the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.cache
def gf_tables(poly: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """(exp, log) of GF(2^m) built from the primitive polynomial ``poly``
    (bit i = coefficient of x^i); exp has 2·(2^m − 1) entries."""
    q = 1 << m
    exp = np.zeros(2 * (q - 1), dtype=np.int64)
    log = np.zeros(q, dtype=np.int64)
    x = 1
    for i in range(q - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & q:
            x ^= poly
    if x != 1:
        raise ValueError(f"0x{poly:x} is not primitive over GF(2^{m})")
    exp[q - 1:] = exp[:q - 1]
    return exp, log


def gf_mul(a: int, b: int, poly: int, m: int) -> int:
    if a == 0 or b == 0:
        return 0
    exp, log = gf_tables(poly, m)
    return int(exp[log[a] + log[b]])


@functools.cache
def gf_mul_table(poly: int, m: int) -> np.ndarray:
    """The full multiplication table [2^m, 2^m]."""
    q = 1 << m
    exp, log = gf_tables(poly, m)
    a = np.arange(q)
    t = exp[(log[a][:, None] + log[a][None, :]) % (q - 1)]
    t[0, :] = 0
    t[:, 0] = 0
    return t


@functools.cache
def rs_generator(poly: int, m: int, nroots: int, first_root: int) -> tuple:
    """g(x) = Π_{i<nroots} (x − α^(first_root+i)), coefficients highest
    degree first (g[0] = 1)."""
    exp, _ = gf_tables(poly, m)
    g = [1]
    for i in range(nroots):
        root = int(exp[(first_root + i) % ((1 << m) - 1)])
        nxt = g + [0]
        for j in range(1, len(nxt)):
            nxt[j] ^= gf_mul(g[j - 1], root, poly, m)
        g = nxt
    return tuple(g)


def rs_parity(msg: torch.Tensor, poly: int, m: int, nroots: int,
              first_root: int) -> torch.Tensor:
    """Systematic RS parity of each row of ``msg`` (int64 symbols [n, k]):
    the remainder of msg(x)·x^nroots by g(x), by the division register,
    one message symbol at a time → int64 [n, nroots], highest degree
    first."""
    dev = msg.device
    mul = torch.from_numpy(gf_mul_table(poly, m)).to(dev)
    gen = torch.tensor(rs_generator(poly, m, nroots, first_root)[1:],
                       dtype=torch.int64, device=dev)
    reg = torch.zeros((msg.shape[0], nroots), dtype=torch.int64, device=dev)
    zero = torch.zeros((msg.shape[0], 1), dtype=torch.int64, device=dev)
    for j in range(msg.shape[1]):
        fb = msg[:, j] ^ reg[:, 0]
        reg = torch.cat([reg[:, 1:], zero], dim=1) ^ mul[fb[:, None],
                                                         gen[None, :]]
    return reg


def lfsr(taps: list[int], init: list[int], length: int,
         output: str) -> np.ndarray:
    """Fibonacci LFSR: register positions 1..n (position 1 the newest bit),
    feedback = XOR of the ``taps`` positions, shifted in at position 1.
    ``output`` "feedback" emits the feedback bit, "last" emits position n
    before the shift."""
    reg = list(init)
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        fb = 0
        for t in taps:
            fb ^= reg[t - 1]
        out[i] = fb if output == "feedback" else reg[-1]
        reg = [fb] + reg[:-1]
    return out


def bytes_to_bits(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., n] → bits uint8 [..., 8n], MSB first."""
    shifts = torch.arange(7, -1, -1, device=b.device, dtype=torch.uint8)
    return ((b[..., None] >> shifts) & 1).reshape(*b.shape[:-1], -1)


def bits_to_words(bits: torch.Tensor, width: int) -> torch.Tensor:
    """bits [..., width·n] (MSB first) → int64 words [..., n]."""
    w = bits.reshape(*bits.shape[:-1], -1, width).to(torch.int64)
    weights = 1 << torch.arange(width - 1, -1, -1, device=bits.device)
    return (w * weights).sum(-1)


def words_to_bits(words: torch.Tensor, width: int) -> torch.Tensor:
    """int words [..., n] → bits uint8 [..., width·n], MSB first."""
    shifts = torch.arange(width - 1, -1, -1, device=words.device)
    return ((words.to(torch.int64)[..., None] >> shifts) & 1).to(
        torch.uint8).reshape(*words.shape[:-1], -1)


def taps_of_octal(octal: str, k: int) -> list[int]:
    """Delays j (output = XOR of d[i − j]) of a generator in octal, the
    most significant of its k bits being the current input."""
    g = int(octal, 8)
    return [j for j in range(k) if (g >> (k - 1 - j)) & 1]
