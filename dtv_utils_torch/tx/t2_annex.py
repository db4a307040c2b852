"""Loadable EN 302 755 annex data with structural validation (a copy of
``dtv_utils_tpu/tx/t2_annex.py`` reading the port's own ``data/t2/``).

The DVB-T2 annex tables that are pure numeric data with no generative rule
(LDPC parity addresses, continual-pilot sets, tone-reservation positions)
cannot be re-derived; where certified values are unavailable the modulator
falls back to structure-exact stand-ins (see tx/dvbt2_tables.py and
PARITY.md).  This module is the drop-in path for the real data: place a
file under ``dtv_utils_torch/data/t2/`` and every consumer picks it up, after
the table passes the structural constraints the standard forces — so a
mis-transcribed table fails loudly instead of silently desyncing.

File formats (plain text, ``#`` comments allowed):

  ldpc_<nldpc>_<num>_<den>.txt   one annex row per line: the parity-bit
                                 accumulator addresses of the first bit of
                                 each 360-bit group (EN 302 755 annex A)
  cp_<fft>.txt                   continual-pilot carrier indices, one per
                                 line (annex table, union of CP groups)
  tr_<fft>.txt                   tone-reservation carrier indices for data
                                 symbols (annex H), one per line
  tr_p2_<fft>.txt                tone-reservation carrier indices for P2
                                 symbols (annex H), one per line
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

DATA_DIR = pathlib.Path(__file__).resolve().parent.parent / "data" / "t2"


def _provenance(path: pathlib.Path) -> str:
    """The '# provenance:' header of a data file (with continuation lines),
    flattened to one line, or '' when absent."""
    lines, active = [], False
    for raw in path.read_text().splitlines():
        if not raw.lstrip().startswith("#"):
            break
        body = raw.lstrip().lstrip("#").strip()
        if body.startswith("provenance:"):
            active = True
            lines.append(body[len("provenance:"):].strip())
        elif active:
            lines.append(body)
    return " ".join(lines)


def table_status(cfg) -> list[dict]:
    """Per-table provenance report for one Dvbt2Config: is each annex
    table the chain would use INSTALLED (data file + its provenance
    header) or a STAND-IN (structure-exact, not standard-compliant)?

    Surfaceable via ``dtv dvbt2-mod --tables`` so a user knows whether the
    IQ they are about to generate is decodable by real receivers
    (dvbt2-blade.py:119-131 pins the gr-dtv chain whose tables are the
    compliance target).  Rows: name, file, state ('installed'|'stand-in'|
    'derived'|'config'), provenance/detail.
    """
    from dtv_utils_torch.core.config import T2Constellation, T2FrameSize
    from dtv_utils_torch.rates.dvbt2 import TR_CELLS

    rows: list[dict] = []

    def add(name: str, fname: str | None, detail_standin: str,
            state_override: str | None = None) -> None:
        if state_override is not None:
            rows.append({"name": name, "file": fname or "-",
                         "state": state_override,
                         "detail": detail_standin})
            return
        path = DATA_DIR / fname
        if path.exists():
            rows.append({"name": name, "file": fname, "state": "installed",
                         "detail": _provenance(path) or "(no provenance "
                         "header)"})
        else:
            rows.append({"name": name, "file": fname, "state": "stand-in",
                         "detail": detail_standin})

    frac = cfg.code_rate.fraction
    add("LDPC parity addresses (annex A)",
        f"ldpc_{cfg.nldpc}_{frac.numerator}_{frac.denominator}.txt",
        "structure-exact IRA stand-in — IQ NOT decodable by standard "
        "receivers")
    if cfg.constellation is not T2Constellation.QPSK:
        nc = {T2Constellation.QAM16: 8, T2Constellation.QAM64: 12,
              T2Constellation.QAM256: 16}[cfg.constellation]
        if (cfg.frame_size is T2FrameSize.SHORT
                and cfg.constellation is T2Constellation.QAM256):
            nc = 8
        add("column twist tc (§6.1.3 tables 9-10)",
            f"twist_{cfg.nldpc}_{nc}.txt", "recalled in-code table")
        if (cfg.frame_size is T2FrameSize.SHORT
                and cfg.constellation is T2Constellation.QAM256):
            add("bit-to-cell demux (§6.2 table 12)",
                "demux_8_16200_qam256.txt", "recalled in-code table")
        else:
            add("bit-to-cell demux (§6.2 table 12)", f"demux_{nc}.txt",
                "recalled in-code table")
    add("continual-pilot set (§9.2.4 annex)", f"cp_{cfg.fft_size}.txt",
        "pseudo-random stand-in set at the exact budget count — pilot "
        "positions NOT standard")
    n_tr = TR_CELLS[cfg.fft_size]
    add(f"tone reservation P2 ({n_tr} cells, annex H)",
        f"tr_p2_{cfg.fft_size}.txt", "strided stand-in positions")
    if cfg.papr_tr:
        add(f"tone reservation data symbols ({n_tr} cells, annex H)",
            f"tr_{cfg.fft_size}.txt", "pseudo-random stand-in positions")
    import math
    ci_width = max(int(math.ceil(math.log2(
        cfg.cells_per_fec_block))), 2) - 1
    add("cell-interleaver LFSR wires (§6.5)",
        f"wires_ci_{ci_width}.txt",
        "derived LFSR structure; wire ordering is a structural stand-in "
        "(loadable: wires_ci_<width>.txt / feedback_ci_<width>.txt)")
    add("freq-interleaver LFSR wires (§8.5)", None,
        "derived LFSR structure via the §6.5 generator; per-FFT wire "
        "orderings share the wires_ci_* loader", state_override="stand-in")
    add("P1 CDS / S1 S2 / scrambling (§9.8)", None,
        "derived from generative rules, certified by Golay-pair property "
        "(tests/test_t2_p1.py)", state_override="derived")
    add("P2 pilot amplitude", "scalar_p2_amplitude.txt",
        "recalled scalar 4/3 (spec value FFT-dependent) — PARITY.md")
    add("L1 operator fields (cell/network/system id, frequency)", None,
        "operator configuration via Dvbt2Config; defaults are "
        "placeholders by design", state_override="config")
    return rows


def _read_rows(path: pathlib.Path) -> list[list[int]]:
    rows = []
    for line in path.read_text().splitlines():
        line = line.split("#", 1)[0].strip().replace(",", " ")
        if line:
            rows.append([int(tok) for tok in line.split()])
    return rows


class AnnexDataError(ValueError):
    """A provided annex data file violates a structural constraint the
    standard forces — refuse to modulate with it."""


@functools.cache
def ldpc_rows(nldpc: int, num: int, den: int, kldpc: int
              ) -> tuple[tuple[int, ...], ...] | None:
    """Annex-A accumulator rows for code rate num/den at frame size nldpc,
    or None when no data file is installed.  kldpc is passed explicitly
    because short-frame codes have Kldpc != Nldpc*num/den (the nominal rate
    names an effective-rate family, EN 302 755 table 6).

    Structural validation: kldpc/360 rows; every address in [0, nldpc -
    kldpc); an IRA profile (a minority of high-degree rows followed by
    degree-3 rows, all rows of one of exactly two distinct degrees).
    """
    path = DATA_DIR / f"ldpc_{nldpc}_{num}_{den}.txt"
    if not path.exists():
        return None
    n_parity = nldpc - kldpc
    rows = _read_rows(path)
    if len(rows) != kldpc // 360:
        raise AnnexDataError(
            f"{path.name}: {len(rows)} rows, expected {kldpc // 360}")
    degrees = sorted({len(r) for r in rows})
    if not (len(degrees) <= 2 and degrees[0] >= 3):
        raise AnnexDataError(f"{path.name}: degree profile {degrees} is not "
                             "an IRA two-level profile")
    for i, r in enumerate(rows):
        if any(a < 0 or a >= n_parity for a in r):
            raise AnnexDataError(
                f"{path.name} row {i}: address outside [0, {n_parity})")
        if len(set(r)) != len(r):
            raise AnnexDataError(f"{path.name} row {i}: repeated address")
    return tuple(tuple(r) for r in rows)


def _read_index_set(path: pathlib.Path, k_max: int) -> np.ndarray | None:
    if not path.exists():
        return None
    vals = [v for row in _read_rows(path) for v in row]
    arr = np.asarray(sorted(vals), dtype=np.int32)
    if len(np.unique(arr)) != len(arr):
        raise AnnexDataError(f"{path.name}: repeated carrier index")
    if len(arr) and (arr[0] < 0 or arr[-1] >= k_max):
        raise AnnexDataError(f"{path.name}: index outside [0, {k_max})")
    return arr


@functools.cache
def continual_pilots(fft: int, k_max: int) -> np.ndarray | None:
    """Continual-pilot carrier set for the FFT size, or None."""
    return _read_index_set(DATA_DIR / f"cp_{fft}.txt", k_max)


@functools.cache
def tr_positions(fft: int, k_max: int, n_tr: int,
                 p2: bool = False) -> np.ndarray | None:
    """Annex-H tone-reservation set (exactly n_tr entries), or None."""
    name = f"tr_p2_{fft}.txt" if p2 else f"tr_{fft}.txt"
    arr = _read_index_set(DATA_DIR / name, k_max)
    if arr is not None and len(arr) != n_tr:
        raise AnnexDataError(
            f"{name}: {len(arr)} entries, expected {n_tr} "
            "(dvbt2rate.c:1108-1196 TR cell count)")
    return arr


@functools.cache
def column_twist(nldpc: int, nc: int) -> tuple[int, ...] | None:
    """§6.1.3 table-9/10 column-twist offsets tc for an Nc-column
    interleaver at frame size nldpc (``twist_<nldpc>_<nc>.txt``: the Nc
    offsets on one or more lines), or None when no file is installed.

    Structural validation: exactly Nc values, each in [0, Nr) where
    Nr = nldpc / Nc."""
    path = DATA_DIR / f"twist_{nldpc}_{nc}.txt"
    if not path.exists():
        return None
    vals = [v for row in _read_rows(path) for v in row]
    nr = nldpc // nc
    if len(vals) != nc:
        raise AnnexDataError(f"{path.name}: {len(vals)} offsets, "
                             f"expected {nc}")
    if any(v < 0 or v >= nr for v in vals):
        raise AnnexDataError(f"{path.name}: offset outside [0, {nr})")
    return tuple(vals)


@functools.cache
def lfsr_wires(tag: str, width: int) -> tuple[int, ...] | None:
    """§6.5/§8.5 LFSR bit-wire permutation (``wires_<tag>.txt``: the
    R'→R bit positions, one per LFSR bit), or None when no file is
    installed.  These per-width orderings are editorial tables with no
    generative rule (the LFSR structure itself is derived in
    tx/dvbt2_tables.py); a file replaces the structural stand-in wires.

    Structural validation: a permutation of 0..width-1."""
    path = DATA_DIR / f"wires_{tag}.txt"
    if not path.exists():
        return None
    vals = [v for row in _read_rows(path) for v in row]
    if sorted(vals) != list(range(width)):
        raise AnnexDataError(
            f"{path.name}: not a permutation of 0..{width - 1}")
    return tuple(vals)


@functools.cache
def lfsr_feedback(tag: str, width: int) -> tuple[int, ...] | None:
    """LFSR feedback tap positions (``feedback_<tag>.txt``: 1-based tap
    indices), or None.  Validation: taps unique, in [1, width]; the
    consumer additionally verifies the resulting sequence is
    maximal-length and falls back loudly if not."""
    path = DATA_DIR / f"feedback_{tag}.txt"
    if not path.exists():
        return None
    vals = [v for row in _read_rows(path) for v in row]
    if len(set(vals)) != len(vals) or any(
            v < 1 or v > width for v in vals):
        raise AnnexDataError(
            f"{path.name}: taps must be unique and within [1, {width}]")
    return tuple(vals)


@functools.cache
def scalar(name: str) -> float | None:
    """Optional recalled-scalar override (``scalar_<name>.txt``: one value,
    either a decimal or a ``num/den`` rational, ``#`` comments allowed) —
    the same provenance-labeled data mechanism as the annex tables, for
    the standalone constants PARITY.md lists (P2 pilot amplitude).
    Returns None when no file is installed."""
    path = DATA_DIR / f"scalar_{name}.txt"
    if not path.exists():
        return None
    toks = []
    for line in path.read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            toks.append(line)
    if len(toks) != 1:
        raise AnnexDataError(f"{path.name}: expected exactly one value")
    tok = toks[0]
    if "/" in tok:
        num, den = tok.split("/")
        return float(num) / float(den)
    return float(tok)


@functools.cache
def demux_map(n_substreams: int, tag: str = "") -> tuple[int, ...] | None:
    """§6.2 table-12 bit-to-substream map (``demux_<nsub>.txt``: for each
    substream d in order, the output bit position y of substream d), or
    None when no file is installed.

    ``tag`` disambiguates combinations that share a substream count but
    not a table (256-QAM short frames use 8 substreams like 16-QAM):
    ``demux_<nsub>_<tag>.txt`` is tried first, then ``demux_<nsub>.txt``
    — except when a tag is given, the untagged file is NOT used as a
    fallback (it describes a different constellation).

    Structural validation: a permutation of 0..n_substreams-1."""
    if tag:
        path = DATA_DIR / f"demux_{n_substreams}_{tag}.txt"
    else:
        path = DATA_DIR / f"demux_{n_substreams}.txt"
    if not path.exists():
        return None
    vals = [v for row in _read_rows(path) for v in row]
    if sorted(vals) != list(range(n_substreams)):
        raise AnnexDataError(
            f"{path.name}: not a permutation of 0..{n_substreams - 1}")
    return tuple(vals)
