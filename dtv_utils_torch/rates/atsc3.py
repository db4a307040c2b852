"""ATSC 3.0 bitrate / frame-budget oracle (a copy of
``dtv_utils_tpu/rates/atsc3.py``, pinned by ``tests/test_torch_rates.py``).

Behavioral parity target: the reference atsc3rate.c (full file) — same
14/15 positional args, byte-identical stdout.  Frame math per A/322: 6.912
Msps fixed clock (:164), bootstrap time 3072·4·T_B (:1513-1515), preamble /
data / SBS cell budgets from the shared tables module, L1-Basic+Detail cell
costs (:194-241), HTI PLP sizing with the 2^19-cell TI memory (:1556-1573).
"""

from __future__ import annotations

import math
import sys

from dtv_utils_torch.rates import atsc3_tables as T

TI_MEMORY = 1 << 19

GI_SAMPLES = {1: 192, 2: 384, 3: 512, 4: 768, 5: 1024, 6: 1536, 7: 2048,
              8: 2432, 9: 3072, 10: 3648, 11: 4096, 12: 4864}

# preamble_cells_table row per (fft, guardinterval); 32K GI 9/10 rows depend
# on the pilot pattern (SP8_* uses the dx=8 preamble, atsc3rate.c:884-905)
_GI_ROW_8K = {1: 0, 2: 1, 3: 2, 4: 3, 5: 4, 6: 5, 7: 6}
_GI_ROW_16K = {1: 7, 2: 8, 3: 9, 4: 10, 5: 11, 6: 12, 7: 13, 8: 14, 9: 15,
               10: 16, 11: 17}
_GI_ROW_32K = {1: 18, 2: 19, 3: 20, 4: 21, 5: 22, 6: 23, 7: 24, 8: 25,
               11: 30, 12: 31}

PAPR_CELLS = {8192: 72, 16384: 144, 32768: 288}

KBCH_NORMAL = (8448, 12768, 17088, 21408, 25728, 30048, 34368, 38688, 43008,
               47328, 51648, 55968)
KBCH_SHORT = (1992, 3072, 4152, 5232, 6312, 7392, 8472, 9552, 10632, 11712,
              12792, 13872)
MOD_BITS = {0: 2, 1: 4, 2: 6, 3: 8, 4: 10, 5: 12}
FEC_CELLS_NORMAL = {0: 32400, 1: 16200, 2: 10800, 3: 8100, 4: 6480, 5: 5400}
FEC_CELLS_SHORT = {0: 8100, 1: 4050, 2: 2700, 3: 2025}
L1_BASIC_CELLS = {0: 3820, 1: 934, 2: 484, 3: 259, 4: 163}
L1_DETAIL_CELLS = {0: 2787, 1: 774, 2: 617, 3: 338, 4: 204, 5: 124, 6: 85}

PILOT_NAMES = ("SP3_2", "SP3_4", "SP4_2", "SP4_4", "SP6_2", "SP6_4",
               "SP8_2", "SP8_4", "SP12_2", "SP12_4", "SP16_2", "SP16_4",
               "SP24_2", "SP24_4", "SP32_2", "SP32_4")
CRED_BW = {0: "5.833", 1: "5.752", 2: "5.671", 3: "5.590", 4: "5.509"}


def lookup_cells(fftsize: int, guard: int, pilot: int, cred: int,
                 boost: int) -> dict:
    """(gisamples, first/preamble cells, data/SBS/SBS-data cells, papr)."""
    if fftsize == 16384:
        rows, dtab, stab, sdtab = (_GI_ROW_16K, T.DATA_CELLS_TABLE_16K,
                                   T.SBS_CELLS_TABLE_16K,
                                   T.SBS_DATA_CELLS_TABLE_16K)
        default_row = 7
    elif fftsize == 32768:
        rows, dtab, stab, sdtab = (_GI_ROW_32K, T.DATA_CELLS_TABLE_32K,
                                   T.SBS_CELLS_TABLE_32K,
                                   T.SBS_DATA_CELLS_TABLE_32K)
        default_row = 18
    else:                                   # 8K and the C default path
        rows, dtab, stab, sdtab = (_GI_ROW_8K, T.DATA_CELLS_TABLE_8K,
                                   T.SBS_CELLS_TABLE_8K,
                                   T.SBS_DATA_CELLS_TABLE_8K)
        default_row = 0
    if fftsize == 32768 and guard in (9, 10):
        sp8 = pilot in (6, 7)               # SP8_2 / SP8_4
        row = {9: 26 if sp8 else 27, 10: 28 if sp8 else 29}[guard]
    else:
        row = rows.get(guard, default_row)
    # each FFT size's switch only lists ITS guard cases; anything else hits
    # the C default: gisamples = 192 (e.g. GI 8..12 on 8K, GI 12 on 16K)
    valid = set(rows) | ({9, 10} if fftsize == 32768 else set())
    gisamples = GI_SAMPLES[guard] if guard in valid else 192
    pp = pilot if 0 <= pilot < 16 else 0
    return dict(
        gisamples=gisamples,
        first_preamble_cells=T.PREAMBLE_CELLS_TABLE[row][4],
        preamble_cells=T.PREAMBLE_CELLS_TABLE[row][cred],
        data_cells=dtab[pp][cred],
        sbs_cells=stab[pp][cred],
        sbs_data_cells=sdtab[pp][cred][boost],
        papr_cells=PAPR_CELLS.get(fftsize, 72),
    )


def format_report(argv: list[str]) -> str:
    """Byte-identical stdout of ``atsc3rate <14|15 args>``."""
    fft_k = int(argv[0])
    fftsize = fft_k * 1024
    if fftsize not in (8192, 16384, 32768):
        fftsize_eff = 8192               # C default path keeps printed size
    else:
        fftsize_eff = fftsize
    guard = int(argv[1])
    numpayloadsyms = int(argv[2])
    numpreamblesyms = int(argv[3])
    rate = int(argv[4]) - 2              # CLI uses 2..13 → enum 0..11
    constellation = int(argv[5])
    framesize = int(argv[6])
    pilotpattern = int(argv[7])
    firstsbs = int(argv[8])
    l1b = int(argv[9])
    l1d = int(argv[10])
    cred = int(argv[11])
    pilotboost = int(argv[12])
    paprmode = int(argv[13])
    hti_blocks = int(argv[14]) if len(argv) == 15 else None

    l1cells = L1_BASIC_CELLS.get(l1b - 1, 3820)
    l1cells += L1_DETAIL_CELLS.get(l1d - 1, 3820)
    if framesize == 0:
        kbch = float(KBCH_NORMAL[rate]) if 0 <= rate < 12 else 0.0
        fecsize = 64800.0
        fec_cells = FEC_CELLS_NORMAL.get(constellation, 0)
    elif framesize == 1:
        kbch = float(KBCH_SHORT[rate]) if 0 <= rate < 12 else 0.0
        fecsize = 16200.0
        fec_cells = FEC_CELLS_SHORT.get(constellation, 0)
    else:
        kbch, fecsize, fec_cells = 0.0, 0.0, 0
    mod = MOD_BITS.get(constellation, 2)
    cells = lookup_cells(fftsize_eff, guard, pilotpattern, cred, pilotboost)

    out = []
    fs = {0: "normal", 1: "short"}.get(framesize, "invalid")
    out.append(f"frame size = {fs}")
    out.append(f"code rate = {rate + 2}/15" if 0 <= rate < 12
               else "code rate = invalid")
    cname = {0: "QPSK", 1: "16QAM", 2: "64QAM", 3: "256QAM", 4: "1024QAM",
             5: "4096QAM"}.get(constellation, "invalid")
    out.append(f"constellation = {cname}")
    out.append(f"FFT size = {fftsize}")
    out.append(f"number of data symbols = {numpayloadsyms}")
    out.append(f"number of preamble symbols = {numpreamblesyms}")
    out.append(f"guard interval samples = {cells['gisamples']}")
    pname = (PILOT_NAMES[pilotpattern] if 0 <= pilotpattern < 16
             else "invalid")
    out.append(f"pilot pattern = {pname}")
    out.append("first SBS insertion enabled" if firstsbs
               else "first SBS insertion disabled")
    out.append(f"L1 Basic mode = {l1b}")
    out.append(f"L1 Detail mode = {l1d}")
    out.append(f"bandwidth = {CRED_BW.get(cred, 'invalid')} MHz"
               if cred in CRED_BW else "bandwidth = invalid")
    if 0 <= pilotpattern < 16 and 0 <= pilotboost < 5:
        out.append(
            f"pilot boost = {T.PILOT_BOOST_STR[pilotpattern][pilotboost]}")
    else:
        out.append("pilot boost = invalid")
    out.append("")

    papr_cells = cells["papr_cells"] if paprmode == 1 else 0
    symbols = numpayloadsyms + numpreamblesyms
    clock = 384000.0 * 18.0
    t = 1.0 / clock
    tb = 1.0 / 6144000.0
    ts = (t * (fftsize + cells["gisamples"])) * 1000.0
    tf = symbols * ts + 3072.0 * 4 * tb * 1000.0
    out.append(f"clock rate = {clock / 1e6:f} Msps, symbol time = {ts:f} ms")
    out.append(f"frame time = {tf:f} ms")

    first_preamble_cells = cells["first_preamble_cells"]
    preamble_cells = cells["preamble_cells"]
    total_preamble_cells = (numpreamblesyms - 1) * (
        preamble_cells - papr_cells) if numpreamblesyms > 1 else 0
    if numpreamblesyms == 0:
        first_preamble_cells = 0
        l1cells = 0
    data_cells = cells["data_cells"]
    sbs_cells = cells["sbs_cells"]
    if firstsbs:
        totalcells = (first_preamble_cells + total_preamble_cells
                      + (numpayloadsyms - 2) * (data_cells - papr_cells)
                      + (sbs_cells - papr_cells) * 2)
    else:
        totalcells = (first_preamble_cells + total_preamble_cells
                      + (numpayloadsyms - 1) * (data_cells - papr_cells)
                      + (sbs_cells - papr_cells))
    out.append(f"total cells = {totalcells}")
    sbsnullcells = sbs_cells - cells["sbs_data_cells"]
    out.append(f"L1 cells = {l1cells}")
    out.append(f"1st preamble cells = {first_preamble_cells}")
    if numpreamblesyms != 0:
        if l1cells > first_preamble_cells:
            if numpreamblesyms != 2:
                out.append("**** warning, two preamble symbols required ****")
        elif numpreamblesyms != 1:
            out.append("**** warning, one preamble symbol required ****")
    if firstsbs:
        plpsize = totalcells - l1cells - sbsnullcells * 2
        out.append(f"SBS null cells = {sbsnullcells * 2}")
    else:
        plpsize = totalcells - l1cells - sbsnullcells
        out.append(f"SBS null cells = {sbsnullcells}")
    if hti_blocks is not None:
        hti_plpsize = hti_blocks * fec_cells
        if hti_plpsize % TI_MEMORY:
            ti_blocks = hti_plpsize // TI_MEMORY + 1
        else:
            ti_blocks = hti_plpsize // TI_MEMORY
        import numpy as np
        with np.errstate(divide="ignore"):  # C float division: inf, like ref
            plp_ratio = np.float32(hti_plpsize) / np.float32(plpsize)
        if plp_ratio > 0.9:
            out.append(f"PLP size = {hti_plpsize}, unused cells = "
                       f"{plpsize - hti_plpsize}, minimum TI blocks = "
                       f"{ti_blocks}")
        else:
            out.append(f"PLP size = {hti_plpsize}, unused cells = "
                       f"{plpsize - hti_plpsize}")
        plpsize = hti_plpsize
    else:
        out.append(f"PLP size = {plpsize}")
    fecrate = (kbch - 16) / fecsize if fecsize else math.inf
    bitrate = (1000.0 / tf) * (plpsize * mod * fecrate)
    out.append(f"TS bitrate = {bitrate:.3f}")
    fecrate = kbch / fecsize if fecsize else math.inf
    bitrate = (1000.0 / tf) * (plpsize * mod * fecrate)
    out.append(f"PLP bitrate = {bitrate:.3f}")
    return "\n".join(out) + "\n"


USAGE = (
    "usage: atsc3rate <fft size> <guard interval> <number of data symbols> "
    "<number of preamble symbols> <code rate> <modulation> <frame size> "
    "<pilot pattern> <first SBS> <L1 Basic mode> <L1 Detail mode> "
    "<reduced carriers> <pilot boost> <PAPR mode> <optional HTI blocks>\n"
    "\nfft size = 8, 16, 32\n"
    "\nguard interval = 1/192, 2/384, 3/512, 4/768, 5/1024, 6/1536, 7/2048, "
    "8/2432, 9/3072, 10/3648, 11/4096, 12/3864\n"
    "\nmodulation 0/QPSK, 1/16QAM, 2/64QAM, 3/256QAM\n"
    "\nframe size = 0/normal, 1/short\n"
    "\npilot pattern = 0/SP3_2, 1/SP3_4, 2/SP4_2, 3/SP4_4, 4/SP6_2, 5/SP6_4, "
    "6/SP8_2, 7/SP8_4, 8/SP12_2, 9/SP12_4, 10/SP16_2, 11/SP16_4, 12/SP24_2, "
    "13/SP24_4, 14/SP32_2, 15/SP32_4\n")


def cli(argv: list[str]) -> int:
    if len(argv) not in (14, 15):
        print(USAGE, file=sys.stderr, end="")
        return 255
    sys.stdout.write(format_report(argv))
    return 0
