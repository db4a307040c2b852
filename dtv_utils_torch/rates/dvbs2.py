"""DVB-S2 / DVB-S2X useful-bitrate oracle (vectorized; a copy of
``dtv_utils_tpu/rates/dvbs2.py``, pinned by ``tests/test_torch_rates.py``).

Behavioral parity target: the reference dvbs2rate.c.  The TS rate for a
MODCOD is (dvbs2rate.c:57-73):

    tsrate = symrate / (F/mod + 90 + ceil(F/mod/90/16 - 1)·pilots)
                     · (F·r − t_scale·bch − 80)

with F = 64800 (normal) or 16200 (short), t_scale = 16 (normal) / 14 (short),
pilots ∈ {0, 36}.  MODCOD tables are ETSI EN 302 307-1/-2 standards data:
(code-rate num/den, BCH t, print alignment), plus for short frames the
*effective* code rate used by the formula.  The whole sweep evaluates as one
vectorized float64 program with C-identical rounding.
"""

from __future__ import annotations

import numpy as np

# (num, den, bch_t, print_spaces) — ETSI EN 302 307-1 §5.3 normal FECFRAME
S2_NORMAL = {
    "QPSK": (2, [(1, 4, 12, 2), (1, 3, 12, 2), (2, 5, 12, 2), (1, 2, 12, 2),
                 (3, 5, 12, 2), (2, 3, 10, 2), (3, 4, 12, 2), (4, 5, 12, 2),
                 (5, 6, 10, 2), (8, 9, 8, 2), (9, 10, 8, 1)]),
    "8PSK": (3, [(3, 5, 12, 2), (2, 3, 10, 2), (3, 4, 12, 2), (5, 6, 10, 2),
                 (8, 9, 8, 2), (9, 10, 8, 1)]),
    "16APSK": (4, [(2, 3, 10, 2), (3, 4, 12, 2), (4, 5, 12, 2), (5, 6, 10, 2),
                   (8, 9, 8, 2), (9, 10, 8, 1)]),
    "32APSK": (5, [(3, 4, 12, 2), (4, 5, 12, 2), (5, 6, 10, 2), (8, 9, 8, 2),
                   (9, 10, 8, 1)]),
}

# (num, den, bch_t, spaces, eff_num, eff_den) — short FECFRAME effective rates
# per EN 302 307-1 Table 5b
S2_SHORT = {
    "QPSK": (2, [(1, 4, 12, 2, 1, 5), (1, 3, 12, 2, 1, 3), (2, 5, 12, 2, 2, 5),
                 (1, 2, 12, 2, 4, 9), (3, 5, 12, 2, 3, 5), (2, 3, 12, 2, 2, 3),
                 (3, 4, 12, 2, 11, 15), (4, 5, 12, 2, 7, 9),
                 (5, 6, 12, 2, 37, 45), (8, 9, 12, 2, 8, 9)]),
    "8PSK": (3, [(3, 5, 12, 2, 3, 5), (2, 3, 12, 2, 2, 3),
                 (3, 4, 12, 2, 11, 15), (5, 6, 12, 2, 37, 45),
                 (8, 9, 12, 2, 8, 9)]),
    "16APSK": (4, [(2, 3, 12, 2, 2, 3), (3, 4, 12, 2, 11, 15),
                   (4, 5, 12, 2, 7, 9), (5, 6, 12, 2, 37, 45),
                   (8, 9, 12, 2, 8, 9)]),
    "32APSK": (5, [(3, 4, 12, 2, 11, 15), (4, 5, 12, 2, 7, 9),
                   (5, 6, 12, 2, 37, 45), (8, 9, 12, 2, 8, 9)]),
}

# DVB-S2X (EN 302 307-2) normal FECFRAME MODCODs, keyed by printed heading.
S2X_NORMAL = [
    ("QPSK", 2, [(13, 45, 12, 3), (9, 20, 12, 4), (11, 20, 12, 3)]),
    ("8APSK", 3, [(100, 180, 12, 1), (104, 180, 12, 1)]),
    ("8PSK", 3, [(23, 36, 12, 3), (25, 36, 12, 3), (13, 18, 12, 3)]),
    ("16APSK", 4, [(26, 45, 12, 3), (3, 5, 12, 5), (28, 45, 12, 3),
                   (23, 36, 12, 3), (25, 36, 12, 3), (13, 18, 12, 3),
                   (140, 180, 12, 1), (154, 180, 12, 1)]),
    ("8+8APSK", 4, [(90, 180, 12, 2), (96, 180, 12, 2), (100, 180, 12, 1),
                    (18, 30, 12, 3), (20, 30, 12, 3)]),
    ("4+12+16rbAPSK", 5, [(2, 3, 12, 5)]),
    ("4+8+4+16APSK", 5, [(128, 180, 12, 1), (132, 180, 12, 1),
                         (140, 180, 12, 1)]),
    ("64APSK", 6, [(128, 180, 12, 1)]),
    ("4+12+20+28APSK", 6, [(132, 180, 12, 1)]),
    ("8+16+20+20APSK", 6, [(7, 9, 12, 5), (4, 5, 12, 5), (5, 6, 12, 5)]),
    ("128APSK", 7, [(135, 180, 12, 1), (140, 180, 12, 1)]),
    ("256APSK", 8, [(20, 30, 12, 3), (22, 30, 12, 3), (116, 180, 12, 1),
                    (124, 180, 12, 1), (128, 180, 12, 1), (135, 180, 12, 1)]),
]

S2X_SHORT = [
    ("QPSK", 2, [(11, 45, 12, 3), (4, 15, 12, 4), (14, 45, 12, 3),
                 (7, 15, 12, 4), (8, 15, 12, 4), (32, 45, 12, 3)]),
    ("8PSK", 3, [(7, 15, 12, 4), (8, 15, 12, 4), (26, 45, 12, 3),
                 (32, 45, 12, 3)]),
    ("16APSK", 4, [(7, 15, 12, 4), (8, 15, 12, 4), (26, 45, 12, 3),
                   (3, 5, 12, 5), (32, 45, 12, 3)]),
    ("4+12+16rbAPSK", 5, [(2, 3, 12, 5), (32, 45, 12, 3)]),
]

# VL-SNR rows: (label, es_no, frame_len, kbch) — dvbs2rate.c:147-165
VLSNR_ROWS = [
    ("DVB-S2X short FECFRAME", None, None, None),
    ("BPSK-SF2", None, None, None),
    ("coderate = 1/5,  ", -9.90, 33282, 2512),
    ("coderate = 11/45,", -8.30, 33282, 3792),
    ("BPSK", None, None, None),
    ("coderate = 1/5,  ", -6.10, 16686, 3072),
    ("coderate = 4/15, ", -4.90, 16686, 4152),
    ("coderate = 1/3,  ", -3.72, 16686, 5232),
    ("DVB-S2X medium FECFRAME", None, None, None),
    ("BPSK", None, None, None),
    ("coderate = 1/5,  ", -6.85, 33282, 5660),
    ("coderate = 11/45,", -5.50, 33282, 7740),
    ("coderate = 1/3,  ", -4.00, 33282, 10620),
    ("DVB-S2X normal FECFRAME", None, None, None),
    ("QPSK", None, None, None),
    ("coderate = 2/9,  ", -2.85, 33282, 14208),
]


def ts_rate(symbol_rate: float, mod_bits: int, num: int, den: int,
            bch_t: float, pilots: float, short: bool = False) -> np.ndarray:
    """Vectorized MODCOD rate; operand order mirrors dvbs2rate.c:57-73 so
    float64 rounding is identical (inputs broadcast)."""
    fec = 16200.0 if short else 64800.0
    t_scale = 14.0 if short else 16.0
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    bch_t = np.asarray(bch_t, dtype=np.float64)
    slots = fec / mod_bits + 90 + np.ceil(fec / mod_bits / 90 / 16 - 1) * pilots
    return symbol_rate / slots * (fec * (num / den) - t_scale * bch_t - 80)


def _dump(rate: float, num: int, den: int, bch: int, spaces: int) -> str:
    return (f"coderate = {num}/{den},{' ' * spaces}BCH rate = {bch:2d}, "
            f"ts rate = {rate:f}")


def format_report(symbol_rate: float, short: bool = False,
                  s2x: bool = False, vlsnr: bool = False) -> str:
    """Byte-identical stdout of ``dvbs2rate [-svx] <symrate>``."""
    out: list[str] = []
    if vlsnr:
        for label, esno, flen, kbch in VLSNR_ROWS:
            if esno is None:
                out.append(label)
                continue
            rate = (symbol_rate / flen) * (kbch - 80)
            ebno = esno - 10 * np.log10((1.0 / flen) * (kbch - 80))
            out.append(f"{label} Es/No = {esno:0.2f}, Eb/No = {ebno:f}, "
                       f"ts_rate = {rate:f}")
        return "\n".join(out) + "\n"

    if not s2x:
        if not short:
            out.append("DVB-S2 normal FECFRAME")
            groups = [(n, S2_NORMAL[n][0], S2_NORMAL[n][1])
                      for n in ("QPSK", "8PSK", "16APSK", "32APSK")]
            for name, mod, rows in groups:
                for pilots in (0.0, 36.0):
                    out.append(f"{name}, pilots {'off' if not pilots else 'on'}")
                    for num, den, bch, sp in rows:
                        r = float(ts_rate(symbol_rate, mod, num, den, bch,
                                          pilots))
                        out.append(_dump(r, num, den, bch, sp))
        else:
            out.append("DVB-S2 short FECFRAME")
            groups = [(n, S2_SHORT[n][0], S2_SHORT[n][1])
                      for n in ("QPSK", "8PSK", "16APSK", "32APSK")]
            for name, mod, rows in groups:
                for pilots in (0.0, 36.0):
                    out.append(f"{name}, pilots {'off' if not pilots else 'on'}")
                    for num, den, bch, sp, en, ed in rows:
                        r = float(ts_rate(symbol_rate, mod, en, ed, bch,
                                          pilots, short=True))
                        out.append(_dump(r, num, den, bch, sp))
    else:
        if not short:
            out.append("DVB-S2X normal FECFRAME")
            table = S2X_NORMAL
        else:
            out.append("DVB-S2X short FECFRAME")
            table = S2X_SHORT
        for name, mod, rows in table:
            for pilots in (0.0, 36.0):
                out.append(f"{name}, pilots {'off' if not pilots else 'on'}")
                for num, den, bch, sp in rows:
                    r = float(ts_rate(symbol_rate, mod, num, den, bch, pilots,
                                      short=short))
                    out.append(_dump(r, num, den, bch, sp))
    return "\n".join(out) + "\n"
