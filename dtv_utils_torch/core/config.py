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


# ---------------------------------------------------------------------------
# DVB-T2 (EN 302 755) — enum surface mirrors the dtv.* constants the
# reference passes at the gr-dtv script dvbt2-blade.py:37-60.
# ---------------------------------------------------------------------------

class T2FrameSize(enum.Enum):
    NORMAL = 64800
    SHORT = 16200

    @property
    def nldpc(self) -> int:
        return self.value


class T2CodeRate(enum.Enum):
    """LDPC code rate; .value = the dvbt2rate CLI index (rates/dvbt2.py)."""
    R1_2 = 1
    R3_5 = 2
    R2_3 = 3
    R3_4 = 4
    R4_5 = 5
    R5_6 = 6

    @property
    def fraction(self) -> Fraction:
        return {1: Fraction(1, 2), 2: Fraction(3, 5), 3: Fraction(2, 3),
                4: Fraction(3, 4), 5: Fraction(4, 5), 6: Fraction(5, 6)}[
                    self.value]


class T2Constellation(enum.Enum):
    QPSK = 2
    QAM16 = 4
    QAM64 = 6
    QAM256 = 8

    @property
    def bits_per_symbol(self) -> int:
        return self.value


class T2Guard(enum.Enum):
    """.value = (numerator, denominator, dvbt2rate CLI index)."""
    G1_32 = (1, 32, 0)
    G1_16 = (1, 16, 1)
    G1_8 = (1, 8, 2)
    G1_4 = (1, 4, 3)
    G1_128 = (1, 128, 4)
    G19_128 = (19, 128, 5)
    G19_256 = (19, 256, 6)

    @property
    def fraction(self) -> Fraction:
        return Fraction(self.value[0], self.value[1])

    @property
    def oracle_idx(self) -> int:
        return self.value[2]


class T2PilotPattern(enum.Enum):
    """.value = (pattern number, Dx, Dy) — EN 302 755 table 58."""
    PP1 = (1, 3, 4)
    PP2 = (2, 6, 2)
    PP3 = (3, 6, 4)
    PP4 = (4, 12, 2)
    PP5 = (5, 12, 4)
    PP6 = (6, 24, 2)
    PP7 = (7, 24, 4)
    PP8 = (8, 6, 16)

    @property
    def number(self) -> int:
        return self.value[0]

    @property
    def dx(self) -> int:
        return self.value[1]

    @property
    def dy(self) -> int:
        return self.value[2]


_T2_KBCH_NORMAL = {1: 32208, 2: 38688, 3: 43040, 4: 48408, 5: 51648,
                   6: 53840}
_T2_KBCH_SHORT = {1: 7032, 2: 9552, 3: 10632, 4: 11712, 5: 12432, 6: 13152}
_T2_NBCH_NORMAL = {1: 32400, 2: 38880, 3: 43200, 4: 48600, 5: 51840,
                   6: 54000}
# short frames: Nbch = Kldpc per EN 302 755 table 6 (t=12, 168 parity bits)
_T2_NBCH_SHORT = {1: 7200, 2: 9720, 3: 10800, 4: 11880, 5: 12600, 6: 13320}
_T2_CARRIERS = {1024: (853, 853), 2048: (1705, 1705), 4096: (3409, 3409),
                8192: (6817, 6913), 16384: (13633, 13921),
                32768: (27265, 27841)}


@dataclass(frozen=True)
class Dvbt2Config:
    """DVB-T2 modulator parameters (EN 302 755, single PLP type-1, SISO).

    Defaults are the reference's hardcoded set (dvbt2-blade.py:37-60):
    4K FFT, normal FECFRAME, rate 2/3, 64QAM rotated, GI 1/32, PP7,
    100 data symbols, 31 FEC blocks, 3 TI blocks, L1-post 16QAM, PAPR off.
    """
    fft_size: int = 4096
    extended_carriers: bool = False
    frame_size: T2FrameSize = T2FrameSize.NORMAL
    code_rate: T2CodeRate = T2CodeRate.R2_3
    constellation: T2Constellation = T2Constellation.QAM64
    rotation: bool = True
    guard: T2Guard = T2Guard.G1_32
    pilot_pattern: T2PilotPattern = T2PilotPattern.PP7
    l1_constellation: int = 2          # 0=BPSK 1=QPSK 2=16QAM 3=64QAM
    data_symbols: int = 100            # L_data = L_F - N_P2
    fec_blocks: int = 31               # FEC blocks per interleaving frame
    ti_blocks: int = 3
    papr_tr: bool = False
    bandwidth_mhz: int = 8
    version_111: bool = True           # T2 version 1.1.1 signaling

    @property
    def sample_rate(self) -> Fraction:
        if self.bandwidth_mhz == 0:    # 1.7 MHz channel (dvbt2rate.c:113-117)
            return Fraction(131_000_000, 71)
        return Fraction(self.bandwidth_mhz * 8_000_000, 7)

    @property
    def kbch(self) -> int:
        tab = (_T2_KBCH_NORMAL if self.frame_size is T2FrameSize.NORMAL
               else _T2_KBCH_SHORT)
        return tab[self.code_rate.value]

    @property
    def nbch(self) -> int:
        tab = (_T2_NBCH_NORMAL if self.frame_size is T2FrameSize.NORMAL
               else _T2_NBCH_SHORT)
        return tab[self.code_rate.value]

    @property
    def bch_t(self) -> int:
        if self.frame_size is T2FrameSize.SHORT:
            return 12
        return (self.nbch - self.kbch) // 16

    @property
    def nldpc(self) -> int:
        return self.frame_size.nldpc

    @property
    def ldpc_q(self) -> int:
        return (self.nldpc - self.nbch) // 360

    @property
    def cells_per_fec_block(self) -> int:
        return self.nldpc // self.constellation.bits_per_symbol

    @property
    def carriers(self) -> int:
        k = _T2_CARRIERS[self.fft_size]
        return k[1] if self.extended_carriers else k[0]

    @property
    def n_p2(self) -> int:
        return {1024: 16, 2048: 8, 4096: 4, 8192: 2, 16384: 1, 32768: 1}[
            self.fft_size]

    @property
    def frame_symbols(self) -> int:
        """L_F = N_P2 + L_data OFDM symbols per T2 frame (excl. P1)."""
        return self.n_p2 + self.data_symbols

    @property
    def guard_samples(self) -> int:
        return int(self.fft_size * self.guard.fraction)

    @property
    def payload_bytes_per_frame(self) -> int:
        """TS bytes consumed per T2 frame (DFL bits x FEC blocks / 8)."""
        return (self.kbch - 80) // 8 * self.fec_blocks
