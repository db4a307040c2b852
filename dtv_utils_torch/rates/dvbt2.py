"""DVB-T2 bitrate / frame-budget oracle (a copy of
``dtv_utils_tpu/rates/dvbt2.py``, pinned by ``tests/test_torch_core.py``).

Behavioral parity target: the reference dvbt2rate.c (full file) — same 11
positional args, byte-identical stdout.  The cell-budget tables (C_P2, C_DATA,
N_FC, C_FC per FFT size × pilot pattern × carrier mode, EN 302 755 tables
42-45) are exported as data for the T2 modulator; the reference embeds them in
switch ladders (dvbt2rate.c:492-1032).

The arithmetic mirrors the C double/int operations step by step (float64 ops
in the same order, C truncating int division) so printf output matches
bit-for-bit.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

KBCH_1_2 = 7032
KSIG_POST = 350
NBCH_PARITY = 168

FFT_SIZES = (1024, 2048, 4096, 8192, 16384, 32768)

N_P2_TABLE = {1024: 16, 2048: 8, 4096: 4, 8192: 2, 16384: 1, 32768: 1}
C_P2_SISO = {1024: 558, 2048: 1118, 4096: 2236, 8192: 4472,
             16384: 8944, 32768: 22432}
C_P2_MISO = {1024: 546, 2048: 1098, 4096: 2198, 8192: 4398,
             16384: 8814, 32768: 17612}

# (C_DATA, N_FC, C_FC) per pilot pattern PP1..PP8 (EN 302 755 tables 42-45;
# reference ladders dvbt2rate.c:561-1032).  Key: (fft, extended_carriers).
_Z = (0, 0, 0)
CELL_TABLE: dict[tuple[int, bool], tuple[tuple[int, int, int], ...]] = {
    (1024, False): ((764, 568, 402), (768, 710, 654), (798, 710, 490),
                    (804, 780, 707), (818, 780, 544), _Z, _Z, _Z),
    (2048, False): ((1522, 1136, 804), (1532, 1420, 1309), (1596, 1420, 980),
                    (1602, 1562, 1415), (1632, 1562, 1088), _Z,
                    (1646, 1632, 1396), _Z),
    (4096, False): ((3084, 2272, 1609), (3092, 2840, 2619), (3228, 2840, 1961),
                    (3234, 3124, 2831), (3298, 3124, 2177), _Z,
                    (3328, 3266, 2792), _Z),
    (8192, False): ((6208, 4544, 3218), (6214, 5680, 5238), (6494, 5680, 3922),
                    (6498, 6248, 5662), (6634, 6248, 4354), _Z,
                    (6698, 6532, 5585), (6698, 0, 0)),
    (8192, True): ((6296, 4608, 3264), (6298, 5760, 5312), (6584, 5760, 3978),
                   (6588, 6336, 5742), (6728, 6336, 4416), _Z,
                   (6788, 6624, 5664), (6788, 0, 0)),
    (16384, False): ((12418, 9088, 6437), (12436, 11360, 10476),
                     (12988, 11360, 7845), (13002, 12496, 11324),
                     (13272, 12496, 8709), (13288, 13064, 11801),
                     (13416, 13064, 11170), (13406, 0, 0)),
    (16384, True): ((12678, 9280, 6573), (12698, 11600, 10697),
                    (13262, 11600, 8011), (13276, 12760, 11563),
                    (13552, 12760, 8893), (13568, 13340, 12051),
                    (13698, 13340, 11406), (13688, 0, 0)),
    (32768, False): (_Z, (24886, 22720, 20952), _Z, (26022, 24992, 22649),
                     _Z, (26592, 26128, 23603), (26836, 0, 0), (26812, 0, 0)),
    (32768, True): (_Z, (25412, 23200, 21395), _Z, (26572, 25520, 23127),
                    _Z, (27152, 26680, 24102), (27404, 0, 0), (27376, 0, 0)),
}
for _fft in (1024, 2048, 4096):
    CELL_TABLE[(_fft, True)] = CELL_TABLE[(_fft, False)]

# SISO frame-closing-symbol suppression (dvbt2rate.c:1034-1054):
# (guard_enum, pilot_pattern) pairs with no FC symbol.
FC_SUPPRESSED = {(4, 7), (0, 4), (1, 2), (6, 2)}   # (GI enum, PP number)

# tone-reservation cells removed in PAPR mode (dvbt2rate.c:1108-1196)
TR_CELLS = {1024: 10, 2048: 18, 4096: 36, 8192: 72, 16384: 144, 32768: 288}

KBCH_NORMAL = {1: 32208, 2: 38688, 3: 43040, 4: 48408, 5: 51648, 6: 53840}
KBCH_SHORT = {7: 5232, 8: 6312, 1: 7032, 2: 9552, 3: 10632, 4: 11712,
              5: 12432, 6: 13152}
# cells per FECFRAME (dvbt2rate.c:438-491), keyed by constellation enum 1..6
CELL_SIZE_NORMAL = {1: 32400, 2: 16200, 3: 10800, 4: 8100, 5: 6480, 6: 5400}
CELL_SIZE_SHORT = {1: 8100, 2: 4050, 3: 2700, 4: 2025, 5: 1620, 6: 1350}

GI_FRACTIONS = {0: (1, 32), 1: (1, 16), 2: (1, 8), 3: (1, 4), 4: (1, 128),
                5: (19, 128), 6: (19, 256)}
GI_NAMES = {0: "1/32", 1: "1/16", 2: "1/8", 3: "1/4", 4: "1/128",
            5: "19/128", 6: "19/256"}
RATE_NAMES = {1: "1/2", 2: "3/5", 3: "2/3", 4: "3/4", 5: "4/5", 6: "5/6",
              7: "1/3", 8: "2/5"}
CONST_NAMES = {1: "QPSK", 2: "16QAM", 3: "64QAM", 4: "256QAM",
               5: "1024QAM", 6: "4096QAM"}
L1_NAMES = {0: "BPSK", 1: "QPSK", 2: "16QAM", 3: "64QAM"}
ETA_MOD = {0: 1, 1: 2, 2: 4, 3: 6}


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def l1_post_cells(eta_mod: int, n_p2: int) -> tuple[int, int]:
    """(N_post, D_L1) — L1-post sizing (dvbt2rate.c:1064-1074)."""
    n_punc_temp = (6 * (KBCH_1_2 - KSIG_POST)) // 5
    n_post_temp = KSIG_POST + NBCH_PARITY + 9000 - n_punc_temp
    if n_p2 == 1:
        n_post = math.ceil(n_post_temp / (2 * eta_mod)) * 2 * eta_mod
    else:
        n_post = math.ceil(n_post_temp / (eta_mod * n_p2)) * eta_mod * n_p2
    d_l1 = n_post // eta_mod + 1840
    return n_post, d_l1


@dataclass(frozen=True)
class T2Budget:
    """One frame budget at a given (C_DATA, N_FC, C_FC) operating point."""
    max_symbols: int
    max_blocks_at_max: int
    symbols: int
    max_blocks: int
    cells: int
    stream: int
    l1: int
    dummy: int
    unmodulated: int


def _budget(n_p2: int, c_p2: int, c_data: int, n_fc: int, c_fc: int,
            max_symbols: int, symbols: int, fecblocks: int, cell_size: int,
            eta_mod: int) -> T2Budget:
    n_post, d_l1 = l1_post_cells(eta_mod, n_p2)

    def cells_for(nsym: int, closing: int) -> int:
        if n_fc == 0:
            return n_p2 * c_p2 + nsym * c_data
        return n_p2 * c_p2 + (nsym - 1) * c_data + closing

    cells_max = cells_for(max_symbols - n_p2, c_fc)
    cells_cfg = cells_for(symbols - n_p2, c_fc)
    cells_nfc = cells_for(symbols - n_p2, n_fc)
    stream = cell_size * fecblocks
    return T2Budget(
        max_symbols=max_symbols,
        max_blocks_at_max=_cdiv(cells_max - d_l1, cell_size),
        symbols=symbols,
        max_blocks=_cdiv(cells_cfg - d_l1, cell_size),
        cells=cells_nfc,
        stream=stream,
        l1=d_l1,
        dummy=cells_nfc - stream - 1840 - n_post // eta_mod - (n_fc - c_fc),
        unmodulated=n_fc - c_fc,
    )


def compute(bandwidth: int, fft_k: int, guard: int, numsymbols: int,
            fecblocks: float, rate: int, constellation: int, framesize: int,
            carriermode: int, pilotpattern: int, l1_mod: int,
            miso: bool = False) -> dict:
    """All quantities dvbt2rate prints, as a dict (floats where C uses
    double).  Args are the raw CLI integers."""
    if bandwidth == 0:
        clock_num, clock_den = 131000000.0, 71.0     # 1.7 MHz channel
    else:
        clock_num, clock_den = bandwidth * 8000000.0, 7.0
    fftsize = fft_k * 1024
    n_p2 = N_P2_TABLE.get(fftsize, 0)
    gi_num, gi_den = GI_FRACTIONS[guard]
    gi = gi_num / gi_den

    kbch_tab = KBCH_NORMAL if framesize == 0 else KBCH_SHORT
    kbch = float(kbch_tab.get(rate, 0))
    cs_tab = CELL_SIZE_NORMAL if framesize == 0 else CELL_SIZE_SHORT
    cell_size = cs_tab.get(constellation, 0)
    eta_mod = ETA_MOD.get(l1_mod, 1)

    symbols = numsymbols + n_p2
    t = 1.0 / (clock_num / clock_den)
    tu = t * fftsize
    ts = tu * (1.0 + gi)
    tf = symbols * ts + 2048.0 * t
    max_symbols = math.floor(0.25 / ts)
    if fftsize == 32768:
        max_symbols = int(max_symbols) // 2 * 2
    max_symbols = int(max_symbols)

    bitrate_norm = (1.0 / tf) * (188.0 / 188.0) * (fecblocks * (kbch - 80.0))
    bitrate_he = (1.0 / tf) * (188.0 / 187.0) * (fecblocks * (kbch - 80.0))

    c_p2 = (C_P2_MISO if miso else C_P2_SISO).get(fftsize, 0)
    c_data, n_fc, c_fc = CELL_TABLE[(fftsize, carriermode == 1)][
        pilotpattern - 1]
    if not miso and (guard, pilotpattern) in FC_SUPPRESSED:
        n_fc, c_fc = 0, 0

    budget = _budget(n_p2, c_p2, c_data, n_fc, c_fc, max_symbols, symbols,
                     int(fecblocks), cell_size, eta_mod)
    tr = TR_CELLS.get(fftsize, 0)
    budget_papr = _budget(
        n_p2, c_p2,
        c_data - tr if c_data else 0,
        n_fc - tr if n_fc else 0,
        c_fc - tr if c_fc else 0,
        max_symbols, symbols, int(fecblocks), cell_size, eta_mod)

    return dict(clock=clock_num / clock_den, tf_ms=tf * 1000.0,
                bitrate_norm=bitrate_norm, bitrate_he=bitrate_he,
                budget=budget, budget_papr=budget_papr)


def format_report(args: list[int | float]) -> str:
    """Byte-identical stdout of ``dvbt2rate <11 args>``."""
    (bandwidth, fft_k, guard, numsymbols, fecblocks, rate, constellation,
     framesize, carriermode, pilotpattern, l1_mod) = args
    r = compute(int(bandwidth), int(fft_k), int(guard), int(numsymbols),
                float(fecblocks), int(rate), int(constellation),
                int(framesize), int(carriermode), int(pilotpattern),
                int(l1_mod))
    out = []
    out.append(f"FFT size = {int(fft_k) * 1024}")
    out.append(f"guard interval = {GI_NAMES.get(int(guard), 'invalid')}")
    out.append(f"number of data symbols = {int(numsymbols)}")
    out.append(f"number of FEC blocks = {int(float(fecblocks))}")
    out.append(f"code rate = {RATE_NAMES.get(int(rate), 'invalid')}")
    out.append(
        f"constellation = {CONST_NAMES.get(int(constellation), 'invalid')}")
    fs = {0: "normal", 1: "short"}.get(int(framesize), "invalid")
    out.append(f"frame size = {fs}")
    cm = {0: "normal", 1: "extended"}.get(int(carriermode), "invalid")
    out.append(f"carrier mode = {cm}")
    pp = (f"PP{int(pilotpattern)}" if 1 <= int(pilotpattern) <= 8
          else "invalid")
    out.append(f"pilot pattern = {pp}")
    out.append(f"L1 constellation = {L1_NAMES.get(int(l1_mod), 'invalid')}")
    out.append("")
    out.append(f"clock rate = {r['clock']:f}, TF = {r['tf_ms']:f} ms")
    out.append(f"Normal mode bitrate = {r['bitrate_norm']:f}")
    out.append(f"High Efficiency mode bitrate = {r['bitrate_he']:f}")
    out.append("")
    for prefix, b in (("", r["budget"]), ("PAPR ", r["budget_papr"])):
        out.append(f"{prefix}max symbols = {b.max_symbols}, "
                   f"max blocks = {b.max_blocks_at_max}")
        out.append(f"symbols = {b.symbols}, max blocks = {b.max_blocks}")
        out.append(f"cells = {b.cells}, stream = {b.stream}, L1 = {b.l1}, "
                   f"dummy = {b.dummy}, unmodulated = {b.unmodulated}")
        if prefix == "":
            out.append("")
    return "\n".join(out) + "\n"


def cli(argv: list[str]) -> int:
    if len(argv) != 11:
        print("usage: dvbt2rate <channel bandwidth> <fft size> "
              "<guard interval> <number of data symbols> "
              "<number of FEC blocks> <code rate> <modulation> <frame size> "
              "<extended carrier> <pilot pattern> <L1 modulation>",
              file=sys.stderr)
        return 255
    sys.stdout.write(format_report(argv))
    return 0
