"""Reed-Solomon parity as a GF(2) bit-matrix product (port of
``dtv_utils_tpu/ops/rs.py``).

RS codes are linear over GF(2): ``parity_bits = msg_bits @ M mod 2`` with M
built once in NumPy by pushing unit vectors through the LFSR encoder.  The
device copy of M is made once per device.
"""

from __future__ import annotations

import torch

from dtv_utils_torch.core.galois import GF, gf2_matmul, rs_parity_bitmatrix


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
