"""Reed-Solomon decoder: syndromes, Berlekamp-Massey, Chien and Forney
(port of ``dtv_utils_tpu/ops/rs_decode.py``).

``RsDecoder.decode_words`` and ``decode_bytes`` decode a batch of
codewords.  A CUDA batch goes through one kernel hand-written for Hopper
(``csrc/rs_decode.cu``), one launch per decode, which runs every step for
each codeword with no intermediate in device memory; it is generic over
the code up to ``MAX_M`` and ``MAX_ROOTS``, so both served codes (DVB-T's
RS(204,188) over GF(256), J.83B's (127,122) over GF(128)) take it with
their own parameters.  The launch runs inside the span
``rs_decode_kernel`` (``utils/trace.span``) and is counted in
``_build.LAUNCHES["rs_decode"]``.  A CPU batch takes the plain version,
``decode_reference``; there is no other route and no fallback.  The
JAX package's decoder is XLA ops, so the kernel replaces no TPU kernel:
it was added because the plain version's 773 launches a DVB-T receive
call held the host.

The plain version is a few dozen batched PyTorch ops:

* Syndromes are GF(2)-linear in the codeword bits, so a batch computes all
  of them as one float32 0/1 product with a bit-matrix built on the host
  (``core/galois.gf2_matmul``, exact in TF32 too).
* Berlekamp-Massey runs 2t fixed, branchless iterations (``torch.where``
  for the conditional update) on [batch, 2t+1] registers.
* Chien search and Forney are dense [batch, n, ·] table lookups.

GF products are looked up in the log domain with a zero sentinel:
``mul(a, b) = expz[logz[a] + logz[b]]``, where ``logz[0]`` is large enough
that any sum with it lands in a zero tail of ``expz``, so no separate test
for zero operands is needed; the kernel looks up the same tables.  XOR
reductions over a small last axis (at most 2t+1 terms) fold in halves.
Every value is an exact integer, so the kernel's outputs equal the plain
version's, and both equal the reference's, including on packets with more
than t errors.  No step syncs with the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dtv_utils_torch.core import bits as bitops
from dtv_utils_torch.core.galois import GF, GF256, gf2_matmul
from dtv_utils_torch.ops import _build
from dtv_utils_torch.utils.trace import span

# csrc/rs_decode.cu's caps: GF(2^m) with m <= MAX_M, at most MAX_ROOTS roots
MAX_M, MAX_ROOTS = 8, 16
# the codeword dtypes both routes take; the kernel reads each as it is
CODEWORD_DTYPES = (torch.uint8, torch.int32, torch.int64)


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of an integer tensor over its last axis (folded in halves)."""
    m = x.shape[-1]
    if m == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while m > 1:
        h = m // 2
        y = x[..., :h] ^ x[..., h:2 * h]
        if m % 2:
            y[..., 0] ^= x[..., 2 * h]
        x, m = y, h
    return x[..., 0]


class RsDecoder:
    """Decoder for the systematic codes ``RsBitEncoder`` emits: ``k_sym``
    data symbols + ``nroots`` parity, roots α^{first_root + i}."""

    def __init__(self, gf: GF, k_sym: int, nroots: int,
                 first_root: int = 0, root_step: int = 1):
        if root_step != 1:
            raise ValueError("Chien/Forney assume consecutive roots "
                             "(root_step == 1)")
        self.gf = gf
        self.k_sym = k_sym
        self.nroots = nroots
        self.t = nroots // 2
        self.n = k_sym + nroots
        self.first_root = first_root
        m, q = gf.m, gf.q
        # syndrome bit-matrix: S_j = Σ_k cw[k]·α^{(first_root+j)(n-1-k)};
        # bit b of symbol k contributes mul(1 << b, that power) to S_j
        M = np.zeros((self.n * m, nroots * m), dtype=np.int8)
        for k in range(self.n):
            for j in range(nroots):
                w = gf.pow_alpha((first_root + j) * (self.n - 1 - k))
                for b in range(m):
                    val = int(gf.mul(1 << b, w))
                    # symbol bits MSB-first (core/bits convention)
                    for ob in range(m):
                        if (val >> (m - 1 - ob)) & 1:
                            M[k * m + (m - 1 - b), j * m + ob] = 1
        self.synd_M = M
        # Chien/Forney tables over the n real positions: position e (0 =
        # the LAST transmitted symbol, degree 0) → X_e = α^e
        e = np.arange(self.n)
        jj = np.arange(nroots + 1)
        self.chien = gf.exp[(-e[:, None] * jj[None, :]) % (q - 1)].astype(
            np.int32)
        # X_e^{1-first_root}, the Forney factor (characteristic 2: no sign)
        self.xfact = gf.exp[(e * (1 - first_root)) % (q - 1)].astype(np.int32)
        self._device_tables: dict[torch.device, dict[str, torch.Tensor]] = {}

    def _tables(self, device: torch.device) -> dict[str, torch.Tensor]:
        """Device tables, built once per device."""
        if device not in self._device_tables:
            self._device_tables[device] = self._build_tables(device)
        return self._device_tables[device]

    def _build_tables(self, device: torch.device) -> dict[str, torch.Tensor]:
        q1 = self.gf.q - 1
        zero = 2 * q1                       # logz[0]: any sum with it >= 2·q1
        exp = self.gf.exp[:q1]
        expz = np.zeros(2 * zero + 1, dtype=np.int32)
        expz[:2 * q1] = np.tile(exp, 2)
        logz = self.gf.log.astype(np.int32).copy()
        logz[0] = zero
        log_of = logz.__getitem__

        def up(a, dtype=torch.int32):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

        nr = self.nroots
        # Forney's ω_j = XOR_{i<=j} C_i·S_{j-i}: column j-i of S, or the
        # zero column nr where i > j
        jj, ii = np.meshgrid(np.arange(nr), np.arange(nr), indexing="ij")
        return dict(
            synd_M=up(self.synd_M, torch.float32),
            expz=up(expz), logz=up(logz), log=up(self.gf.log),
            chien_log=up(log_of(self.chien)),                  # [n, nr+1]
            xfact_log=up(log_of(self.xfact)),                  # [n]
            omega_idx=up(np.where(ii <= jj, jj - ii, nr), torch.int64),
            zero=torch.tensor(zero, dtype=torch.int32).to(device))

    def syndromes(self, cw_words: torch.Tensor) -> torch.Tensor:
        """[..., n] symbol words → [..., nroots] syndrome words (int32)."""
        M = self._tables(cw_words.device)["synd_M"]
        sb = gf2_matmul(bitops.words_to_bits(cw_words, self.gf.m), M)
        return bitops.bits_to_words(sb, self.gf.m)

    def _inv(self, tb: dict, a: torch.Tensor) -> torch.Tensor:
        """α^{-log a}; callers never pass 0."""
        return tb["expz"][(self.gf.q - 1) - tb["log"][a]]

    def _berlekamp(self, tb: dict, S: torch.Tensor):
        """S int32 [batch, 2t] → error locator C [batch, 2t+1] (C[0] = 1)
        and its degree L [batch]."""
        nr = self.nroots
        batch = S.shape[0]
        expz, logz = tb["expz"], tb["logz"]
        log_s_rev = logz[S].flip(-1)        # [:, nr-1-r+i] is log S[r-i]
        C = F.pad(torch.ones((batch, 1), dtype=torch.int32,
                             device=S.device), (0, nr))
        B = C.clone()
        L = torch.zeros(batch, dtype=torch.int32, device=S.device)
        bden = torch.ones(batch, dtype=torch.int32, device=S.device)
        # fixed-shift Massey variant: B picks up one x factor per iteration
        # (inside the update), which absorbs the classic x^m counter
        for r in range(nr):
            # discrepancy d = XOR_{i=0..r} C[i]·S[r-i]  (deg C <= L <= r)
            d = xor_reduce(expz[logz[C[:, :r + 1]]
                                + log_s_rev[:, nr - 1 - r:]])
            coef = expz[logz[d] + logz[self._inv(
                tb, torch.where(bden == 0, 1, bden))]]
            Bx = F.pad(B[:, :-1], (1, 0))
            Cn = C ^ expz[logz[coef][:, None] + logz[Bx]]
            nonzero = d != 0
            upgrade = nonzero & (2 * L <= r)
            B = torch.where(upgrade[:, None], C, Bx)
            L = torch.where(upgrade, r + 1 - L, L)
            bden = torch.where(upgrade, d, bden)
            C = torch.where(nonzero[:, None], Cn, C)
        return C, L

    def decode_reference(self, cw: torch.Tensor):
        """Plain version of the kernel: cw int [batch, n] → (corrected
        int32 [batch, n], n_errors int32 [batch], ok bool [batch]) on the
        device of ``cw``, in batched PyTorch ops."""
        tb = self._tables(cw.device)
        expz, logz = tb["expz"], tb["logz"]
        nr = self.nroots
        cw = cw.to(torch.int32)
        S = self.syndromes(cw)                              # [batch, 2t]
        clean = (S == 0).all(-1)
        C, L = self._berlekamp(tb, S)
        log_c = logz[C]                                     # [batch, nr+1]

        # Chien over the n real positions: lam[e] = Λ(α^{-e})
        lam = xor_reduce(expz[log_c[:, None, :] + tb["chien_log"]])
        is_err = lam == 0                                   # [batch, n]
        n_found = is_err.sum(-1, dtype=torch.int32)

        # Forney: ω = S(x)·C(x) mod x^nr
        log_s = torch.cat([logz[S], tb["zero"].expand(S.shape[0], 1)], 1)
        omega = xor_reduce(expz[log_c[:, None, :nr]
                                + log_s[:, tb["omega_idx"]]])   # [batch, nr]
        om_val = xor_reduce(expz[logz[omega][:, None, :]
                                 + tb["chien_log"][:, :nr]])
        # Λ'(X^{-1}) = XOR over odd j of C_j·X^{-(j-1)}
        dlam = xor_reduce(expz[log_c[:, None, 1::2]
                               + tb["chien_log"][:, 0:nr:2]])
        inv_dlam = self._inv(tb, torch.where(dlam == 0, 1, dlam))
        mag = expz[logz[expz[logz[om_val] + logz[inv_dlam]]]
                   + tb["xfact_log"]]
        # is_err/mag are indexed by DEGREE e; codeword index k = n-1-e
        patch = torch.where(is_err, mag, 0).flip(-1)
        corrected = cw ^ patch

        ok = clean | ((n_found == L) & (L <= self.t))
        n_err = torch.where(clean, 0, n_found)
        return corrected, n_err, ok

    def _check(self, cw: torch.Tensor) -> None:
        """The arguments both routes take: a code within the kernel's caps
        and codewords [batch, n] of a ``CODEWORD_DTYPES`` dtype whose
        symbols are contiguous (rows may be strided)."""
        if self.gf.m > MAX_M or self.nroots > MAX_ROOTS:
            raise ValueError(
                f"the RS kernel takes GF(2^m) with m <= {MAX_M} and at most "
                f"{MAX_ROOTS} roots, not GF(2^{self.gf.m}) with "
                f"{self.nroots}")
        if cw.dtype not in CODEWORD_DTYPES:
            raise TypeError(f"codewords must be one of {CODEWORD_DTYPES}, "
                            f"got {cw.dtype}")
        if cw.dim() != 2 or cw.shape[1] != self.n:
            raise ValueError(f"need codewords [batch, {self.n}], got "
                             f"{tuple(cw.shape)}")
        if cw.stride(1) != 1:
            raise ValueError("each codeword's symbols must be contiguous")

    def _decode(self, cw: torch.Tensor, out_dtype: torch.dtype):
        """(corrected ``out_dtype`` [batch, n], n_errors, ok): the kernel
        on the card, ``decode_reference`` on the CPU."""
        self._check(cw)
        if not _build.on_card(cw):
            corrected, n_err, ok = self.decode_reference(cw)
            return corrected.to(out_dtype), n_err, ok
        tb = self._tables(cw.device)
        batch = cw.shape[0]
        corrected = torch.empty((batch, self.n), dtype=out_dtype,
                                device=cw.device)
        n_err = torch.empty(batch, dtype=torch.int32, device=cw.device)
        ok = torch.empty(batch, dtype=torch.bool, device=cw.device)
        with span("rs_decode_kernel"):
            _build.launch("rs_decode", cw.device, cw.data_ptr(),
                          cw.element_size(), batch, cw.stride(0),
                          self.gf.m, self.n, self.nroots, self.first_root,
                          tb["expz"].data_ptr(), tb["logz"].data_ptr(),
                          corrected.data_ptr(), corrected.element_size(),
                          n_err.data_ptr(), ok.data_ptr())
        return corrected, n_err, ok

    def decode_words(self, cw: torch.Tensor):
        """cw [batch, n] (a ``CODEWORD_DTYPES`` dtype, symbols contiguous)
        → (corrected int32 [batch, n], n_errors int32 [batch], ok bool
        [batch]) on the device of ``cw``.  ``ok`` is False when the packet
        had more than t errors (detected: locator degree mismatch or a root
        in the shortened code's virtual prefix)."""
        return self._decode(cw, torch.int32)

    def decode_bytes(self, cw: torch.Tensor):
        """uint8 [batch, n] (GF(256) only) → (corrected uint8, n_errors,
        ok)."""
        if self.gf.m != 8:
            raise ValueError(f"decode_bytes needs GF(2^8), not "
                             f"GF(2^{self.gf.m})")
        return self._decode(cw, torch.uint8)


@functools.cache
def DVBT_RS_DEC() -> RsDecoder:
    """Decoder for the DVB-T outer code (shortened RS(204,188), t=8)."""
    return RsDecoder(GF256, k_sym=188, nroots=16)
