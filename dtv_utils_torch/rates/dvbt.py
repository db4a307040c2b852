"""DVB-T useful-bitrate oracle (vectorized; a copy of
``dtv_utils_tpu/rates/dvbt.py``, pinned by ``tests/test_torch_rates.py``).

Behavioral parity target: the reference dvbtrate.c (formula at :44-55) —
``rate = bw·8e6/7 · 6048 · bits_per_cell · (188/204) · cr/(cr+1)
/ (8192 + 8192/gi)`` — evaluated here for the full (constellation, code-rate,
guard) grid at once, both as exact rationals and as float64 matching the C
double arithmetic bit-for-bit.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

CODE_RATES = (1, 2, 3, 5, 7)          # numerators; denominator = num + 1
GUARDS = (4, 8, 16, 32)
CONSTELLATIONS = (("QPSK", 2), ("QAM-16", 4), ("QAM-64", 6))


def rate_grid(bandwidth_mhz: int) -> np.ndarray:
    """float64 [3 constellations, 5 code rates, 4 guards] TS bitrates,
    computed with the exact integer-rational numerator/denominator split the
    reference uses so the double rounding is identical."""
    clock_num = np.int64(bandwidth_mhz * 8_000_000)
    bits = np.array([b for _, b in CONSTELLATIONS], dtype=np.int64)
    cr = np.array(CODE_RATES, dtype=np.int64)
    gi = np.array(GUARDS, dtype=np.int64)
    num = (clock_num * 6048 * bits[:, None, None] * 188 * cr[None, :, None])
    guard_den = 8192 + 8192 // gi
    den = 204 * guard_den[None, None, :] * (cr + 1)[None, :, None] * 7
    return num.astype(np.float64) / den.astype(np.float64)


def rate_exact(bandwidth_mhz: int, bits_per_cell: int, cr_num: int,
               guard_den: int) -> Fraction:
    """Single exact rational rate (used as modulator consistency check)."""
    return (Fraction(bandwidth_mhz * 8_000_000 * 6048 * bits_per_cell
                     * 188 * cr_num,
                     204 * (8192 + 8192 // guard_den) * (cr_num + 1) * 7))


def format_report(bandwidth_mhz: int) -> str:
    """Byte-identical stdout of ``dvbtrate <bw>`` (dvbtrate.c:43-85)."""
    grid = rate_grid(bandwidth_mhz)
    out = []
    for ci, (name, _) in enumerate(CONSTELLATIONS):
        out.append(name)
        for ri, crn in enumerate(CODE_RATES):
            row = " ".join(f"{grid[ci, ri, gi]:f}" for gi in range(len(GUARDS)))
            out.append(f"coderate = {crn}/{crn + 1} {row}")
    return "\n".join(out) + "\n"
