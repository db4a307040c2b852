"""Typed configuration — pure-Python copies of ``dtv_utils_tpu/core/config.py``.

Copied, not imported: importing ``dtv_utils_tpu.core`` imports JAX, which the
GPU machine does not have.  ``tests/test_torch_core.py`` pins every field
to the reference's, so the two cannot drift apart unnoticed.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from fractions import Fraction


class Constellation(enum.Enum):
    QPSK = 2
    QAM16 = 4
    QAM64 = 6

    @property
    def bits_per_symbol(self) -> int:
        return self.value


@dataclass(frozen=True)
class J83bConfig:
    """ITU-T J.83 Annex B 64/256-QAM cable (qam-blade.py parameterization)."""
    constellation: Constellation = Constellation.QAM64
    interleaver_I: int = 128
    interleaver_J: int = 4
    control_word: int = 6
    symbol_rate: Fraction = Fraction(5_056_941)     # qam-blade.py:36
    interpolation: int = 2
    rrc_rolloff: float = 0.18                       # qam-blade.py:59
    rrc_ntaps: int = 100

    @property
    def sample_rate(self) -> Fraction:
        return self.symbol_rate * self.interpolation
