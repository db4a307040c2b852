"""Reed-Solomon parity as a GF(2) bit-matrix product (port of
``dtv_utils_tpu/ops/rs.py``).

RS codes are linear over GF(2): ``parity_bits = msg_bits @ M mod 2`` with M
built once in NumPy by pushing unit vectors through the LFSR encoder.  The
device copy of M is made once per device.  Shortening costs nothing: the
leading zero symbols of the mother code leave the division register at
zero, so the 188-byte DVB-T encoder is exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dtv_utils_torch.core import bits as bitops
from dtv_utils_torch.core.galois import (GF, GF256, gf2_matmul,
                                         rs_parity_bitmatrix)


class RsBitEncoder:
    """Systematic RS encoder over GF(2^m) via a GF(2) parity bit-matrix:
    ``k_sym`` data symbols + ``nroots`` parity symbols."""

    def __init__(self, gf: GF, k_sym: int, nroots: int,
                 first_root: int = 0, root_step: int = 1):
        self.gf = gf
        self.k_sym = k_sym
        self.nroots = nroots
        self.m = gf.m
        self.genpoly = gf.rs_generator_poly(nroots, first_root, root_step)
        # [k_sym*m, nroots*m] uint8, host
        self.M = rs_parity_bitmatrix(gf, k_sym, self.genpoly)
        self._device_M: dict[torch.device, torch.Tensor] = {}

    def parity_bits(self, msg_bits: torch.Tensor) -> torch.Tensor:
        """msg_bits [..., k_sym*m] in {0,1} → parity bits uint8 [..., nroots*m]."""
        dev = msg_bits.device
        M = self._device_M.get(dev)
        if M is None:
            M = self._device_M[dev] = torch.from_numpy(self.M).to(
                dev, torch.float32)
        return gf2_matmul(msg_bits, M)

    def encode_bytes(self, msg: torch.Tensor) -> torch.Tensor:
        """uint8 msg [..., k_sym] (m == 8 only) → codeword uint8
        [..., k_sym + nroots]."""
        if self.m != 8:
            raise ValueError(f"encode_bytes needs GF(2^8), not GF(2^{self.m})")
        parity = bitops.bits_to_bytes(
            self.parity_bits(bitops.bytes_to_bits(msg)))
        return torch.cat([msg, parity], dim=-1)

    def encode_bytes_ref(self, msg: np.ndarray) -> np.ndarray:
        """Host oracle: the byte-serial LFSR encoder, independent of M."""
        par = self.gf.rs_encode_ref(np.asarray(msg, dtype=np.int64),
                                    self.genpoly)
        return np.concatenate(
            [np.asarray(msg, dtype=np.int64), par], axis=-1).astype(np.uint8)


@functools.cache
def DVBT_RS() -> RsBitEncoder:
    """The DVB-T outer code: shortened RS(204,188), t=8, GF(256)/0x11d
    (EN 300 744 §4.3.2)."""
    return RsBitEncoder(GF256, k_sym=188, nroots=16)
