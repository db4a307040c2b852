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


class CodeRate(enum.Enum):
    """DVB-T inner (punctured convolutional) code rates."""
    R1_2 = (1, 2)
    R2_3 = (2, 3)
    R3_4 = (3, 4)
    R5_6 = (5, 6)
    R7_8 = (7, 8)

    @property
    def num(self) -> int:
        return self.value[0]

    @property
    def den(self) -> int:
        return self.value[1]

    @property
    def fraction(self) -> Fraction:
        return Fraction(*self.value)


class GuardInterval(enum.Enum):
    """Guard interval as fraction of useful symbol time."""
    G1_32 = 32
    G1_16 = 16
    G1_8 = 8
    G1_4 = 4

    @property
    def denominator(self) -> int:
        return self.value


class TransmissionMode(enum.Enum):
    """DVB-T FFT mode (EN 300 744 §4.4)."""
    M2K = 2048
    M8K = 8192

    @property
    def fft_size(self) -> int:
        return self.value

    @property
    def carriers(self) -> int:
        """Total active carriers K (1705 / 6817)."""
        return {2048: 1705, 8192: 6817}[self.value]

    @property
    def data_carriers(self) -> int:
        """Payload cells per OFDM symbol (1512 / 6048)."""
        return {2048: 1512, 8192: 6048}[self.value]


@dataclass(frozen=True)
class DvbtConfig:
    """DVB-T modulator parameters (EN 300 744, non-hierarchical).  The
    defaults are the reference's (2K, QPSK, 1/2, 1/4), not the flagship."""
    mode: TransmissionMode = TransmissionMode.M2K
    bandwidth_mhz: int = 8              # 5, 6, 7 or 8
    constellation: Constellation = Constellation.QPSK
    code_rate: CodeRate = CodeRate.R1_2
    guard: GuardInterval = GuardInterval.G1_4
    cell_id: int | None = None          # None → TPS length indicator 23

    SYMBOLS_PER_FRAME = 68
    FRAMES_PER_SUPERFRAME = 4

    @property
    def sample_rate(self) -> Fraction:
        """Complex sample rate = bw * 8/7 MHz."""
        return Fraction(self.bandwidth_mhz * 8_000_000, 7)

    @property
    def fft_size(self) -> int:
        return self.mode.fft_size

    @property
    def guard_samples(self) -> int:
        return self.fft_size // self.guard.denominator

    @property
    def symbol_samples(self) -> int:
        return self.fft_size + self.guard_samples

    @property
    def symbols_per_superframe(self) -> int:
        return self.SYMBOLS_PER_FRAME * self.FRAMES_PER_SUPERFRAME

    @property
    def cells_per_superframe(self) -> int:
        return self.mode.data_carriers * self.symbols_per_superframe

    @property
    def bits_per_superframe(self) -> int:
        """Punctured (channel) bits carried by one superframe."""
        return self.cells_per_superframe * self.constellation.bits_per_symbol

    @property
    def rs_blocks_per_superframe(self) -> int:
        """RS(204,188) codewords per superframe — integral for every mode,
        constellation and rate."""
        blocks = (Fraction(self.bits_per_superframe) * self.code_rate.fraction
                  / (204 * 8))
        if blocks.denominator != 1:
            raise ValueError(f"non-integral superframe budget {blocks}")
        return int(blocks)

    @property
    def ts_bytes_per_superframe(self) -> int:
        return self.rs_blocks_per_superframe * 188

    @property
    def useful_bitrate(self) -> Fraction:
        """Exact TS bitrate (the dvbtrate oracle)."""
        sf_duration = Fraction(self.symbols_per_superframe
                               * self.symbol_samples) / self.sample_rate
        return Fraction(self.ts_bytes_per_superframe * 8) / sf_duration

    @property
    def samples_per_superframe(self) -> int:
        return self.symbols_per_superframe * self.symbol_samples


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
