"""PAPR + CCDF analyzer for float32 interleaved-IQ files (port of
``dtv_utils_tpu/analysis/papr.py``).

Byte-identical stdout to papr.c: two passes over the file (global power
statistics, then the share of samples above each 1 dB or 0.1 dB level).
The two per-chunk passes run on ``device``; the float64 power sum, the
levels and the report are host code, copied from the reference.

Rounding is papr.c's: power is ``i*i`` and ``q*q`` as separately rounded
float32 products, then a float32 add.  Eager PyTorch issues them as three
separate kernels, so nothing can contract them into an FMA (whose single
rounding flips last-ulp peaks): do not fuse them (``torch.compile``,
``addcmul``, a fused kernel).  Peaks keep papr.c's first occurrence:
``argmax``/``argmin`` return the first extremum.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from dtv_utils_torch.utils.device import resolve_device, split_device_arg

_STAT_KEYS = ("peak", "real_pos", "real_neg", "imag_pos", "imag_neg")
_REF_CHUNK_FLOATS = 16384          # papr.c's CHUNK_SIZE
DEFAULT_CHUNK = 1 << 22            # complex samples per device chunk


def _power_f32(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """i² + q²: two separately rounded float32 products, then the add."""
    ii = i * i
    qq = q * q
    return ii + qq


def _pass1_chunk(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """First-pass statistics of one chunk (raw = interleaved IQ float32,
    even length): (vals float32 [5], idxs int64 [5]) in ``_STAT_KEYS``
    order, indices chunk-local complex indices, left on the device."""
    r = raw.view(-1, 2)
    i, q = r[:, 0], r[:, 1]
    power = _power_f32(i, q)
    vals = torch.stack([power.max(), i.max(), i.min(), q.max(), q.min()])
    idxs = torch.stack([power.argmax(), i.argmax(), i.argmin(), q.argmax(),
                        q.argmin()])
    return vals, idxs


def _pass2_chunk(raw: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Count of samples with power strictly above each level — papr.c's
    ``power > level[i]`` — as int64 [L] on the device.  One compare-and-sum
    per level: no [n, L] intermediate, and NaN power counts nowhere."""
    r = raw.view(-1, 2)
    power = _power_f32(r[:, 0], r[:, 1])
    if levels.numel() == 0:
        return torch.zeros(0, dtype=torch.int64, device=raw.device)
    return torch.stack([(power > lv).sum() for lv in levels])


class PaprStats:
    """Aggregated first-pass statistics (papr.c's semantics).

    Peaks start at 0.0 and update only on a STRICT improvement, so the
    first occurrence wins and all-negative rails report 0.0 @ 0.
    """

    def __init__(self):
        self.n = 0
        self.power_sum = 0.0
        self.peak = 0.0
        self.peak_offset = 0
        self.real_pos = 0.0
        self.real_pos_offset = 0
        self.real_neg = 0.0
        self.real_neg_offset = 0
        self.imag_pos = 0.0
        self.imag_pos_offset = 0
        self.imag_neg = 0.0
        self.imag_neg_offset = 0

    def update(self, chunk_stats: tuple, base: int):
        vals, idxs = (t.cpu() for t in chunk_stats)   # one sync per chunk
        s = dict(zip(_STAT_KEYS, zip(vals.tolist(), idxs.tolist())))
        if s["peak"][0] > self.peak:
            self.peak = s["peak"][0]
            self.peak_offset = base + int(s["peak"][1])
        for rail, cmp in (("real_pos", 1), ("real_neg", -1),
                          ("imag_pos", 1), ("imag_neg", -1)):
            v, idx = s[rail]
            if cmp * v > cmp * getattr(self, rail):
                setattr(self, rail, v)
                setattr(self, rail + "_offset", base + int(idx))

    @property
    def mean_power(self) -> float:
        # empty file: C divides 0.0 by 0 and gets a (negative-signed) NaN
        with np.errstate(invalid="ignore", divide="ignore"):
            return float(np.float64(self.power_sum)
                         / np.float64(self.n if self.n else 0.0))

    @property
    def papr_db(self) -> float:
        # C: float papr = 10 * log10((double)peak / sum): double math, then
        # one rounding to float32 on assignment
        with np.errstate(invalid="ignore", divide="ignore"):
            return float(np.float32(
                10.0 * np.log10(np.float64(self.peak)
                                / np.float64(self.mean_power))))


def _stale_q(path: str) -> np.float32:
    """papr.c's value for an odd trailing float: its i+=2 loop pairs it with
    buffer[length] of the STATIC 16384-float buffer — 0.0 if the file fits
    in one chunk, else the previous chunk's float at that offset."""
    total = os.path.getsize(path) // 4
    if total < _REF_CHUNK_FLOATS:
        return np.float32(0.0)
    idx = (total // _REF_CHUNK_FLOATS - 1) * _REF_CHUNK_FLOATS \
        + total % _REF_CHUNK_FLOATS
    with open(path, "rb") as f:
        f.seek(idx * 4)
        return np.frombuffer(f.read(4), dtype=np.float32)[0]


def _iter_chunks(path: str, chunk_complex: int):
    """Yield (raw_interleaved, base_offset) float32 arrays from a cfile."""
    base = 0
    with open(path, "rb") as f:
        while True:
            raw = np.fromfile(f, dtype=np.float32, count=2 * chunk_complex)
            if raw.size == 0:
                break
            if raw.size % 2:  # trailing half-sample: papr.c pairs it with
                raw = np.concatenate(  # the stale chunk-buffer float
                    [raw, np.asarray([_stale_q(path)], np.float32)])
            yield raw, base
            base += raw.size // 2
            if raw.size < 2 * chunk_complex:
                break


def analyze_file(path: str, chunk_complex: int = DEFAULT_CHUNK, *,
                 device: str | torch.device) -> PaprStats:
    dev = resolve_device(device)
    stats = PaprStats()
    for raw, base in _iter_chunks(path, chunk_complex):
        stats.update(_pass1_chunk(torch.from_numpy(raw).to(dev)), base)
        # The float64 power sum runs on the host: numpy's float32 products
        # round as papr.c's do, and a float64 sum of float32 powers is exact
        # at any realistic file size, so chunking cannot change it.
        sq = raw * raw
        power = sq.reshape(-1, 2).sum(axis=1, dtype=np.float32)  # ii + qq
        stats.power_sum += float(np.sum(power, dtype=np.float64))
        stats.n += raw.size // 2
    return stats


def ccdf_counts(path: str, levels: np.ndarray,
                chunk_complex: int = DEFAULT_CHUNK, *,
                device: str | torch.device) -> np.ndarray:
    dev = resolve_device(device)
    counts = np.zeros(len(levels), dtype=np.int64)
    lv = torch.from_numpy(np.asarray(levels, np.float32)).to(dev)
    for raw, _ in _iter_chunks(path, chunk_complex):
        counts += _pass2_chunk(torch.from_numpy(raw).to(dev), lv).cpu().numpy()
    return counts


def make_levels(mean_power: float, papr_db: float, graph: bool) -> np.ndarray:
    """levels[i] = 10^(step·i/10) · mean, float32 (papr.c's level loops)."""
    if np.isnan(papr_db):
        # empty file: C's (int)nan is INT_MIN, so the level loops never run
        return np.empty(0, dtype=np.float32)
    if graph:
        # papr.c accumulates index += 0.1f in float32, so the rounding error
        # accumulates — replicate exactly
        n = int(np.float32(papr_db) * np.float32(10)) + 1
        idx = np.empty(n, dtype=np.float32)
        acc = np.float32(0.0)
        for i in range(n):
            idx[i] = acc
            acc = acc + np.float32(0.1)
    else:
        n = int(papr_db) + 1
        idx = np.arange(n, dtype=np.float32)
    return (np.power(10.0, (idx / np.float32(10)).astype(np.float64))
            * mean_power).astype(np.float32)


def _cfmt(x: float) -> str:
    """C printf %f, including the x86 quiet-NaN sign: 0.0/0.0 prints -nan."""
    return "-nan" if np.isnan(x) else f"{x:f}"


def format_report(stats: PaprStats, counts: np.ndarray, graph: bool) -> str:
    """Byte-identical stdout of ``papr [-g] <infile>``."""
    out = []
    n = np.float32(stats.n)
    if not graph:
        out.append(f"Peak magnitude = {np.sqrt(stats.peak):f}")
        out.append(f"average power = {_cfmt(stats.mean_power)}, "
                   f"peak power = {stats.peak:f} @ {stats.peak_offset * 8}")
        out.append("")
        out.append(f"Maximum PAPR = {_cfmt(stats.papr_db)}")
        for i, c in enumerate(counts):
            # C: ((float)count/(float)offset) * 100.0 — f32 divide, then
            # promotion to double for the multiply
            pct = float(np.float32(c) / n) * 100.0
            out.append(f"percentage above {i} dB = {pct:0.8f}")
        out.append("")
        out.append(f"peak real positive = {stats.real_pos:f}, "
                   f"peak imaginary positive = {stats.imag_pos:f}")
        out.append(f"peak real negative = {stats.real_neg:f}, "
                   f"peak imaginary negative = {stats.imag_neg:f}")
        out.append("")
        out.append(f"peak real positive @ {stats.real_pos_offset * 8}, "
                   f"peak imaginary positive @ {stats.imag_pos_offset * 8 + 1}")
        out.append(f"peak real negative @ {stats.real_neg_offset * 8}, "
                   f"peak imaginary negative @ {stats.imag_neg_offset * 8 + 1}")
        return "\n".join(out) + "\n"
    for c in counts:
        pct = float(np.float32(c) / n) * 100.0
        out.append(f"{pct:0.8f}")
    return "\n".join(out) + "\n" if out else ""   # no levels -> no output


def report(path: str, graph: bool, chunk_complex: int = DEFAULT_CHUNK, *,
           device: str | torch.device) -> str:
    """Both passes over ``path`` on ``device``; returns papr.c's stdout."""
    stats = analyze_file(path, chunk_complex, device=device)
    levels = make_levels(stats.mean_power, stats.papr_db, graph)
    counts = ccdf_counts(path, levels, chunk_complex, device=device)
    return format_report(stats, counts, graph)


def cli(argv: list[str]) -> int:
    argv, device = split_device_arg(argv)
    graph = False
    if len(argv) not in (1, 2):
        print("usage: papr -g <infile> [--device cuda|cpu]\nOptions:\n"
              "\tg = graph suitable output", file=sys.stderr)
        return 255
    if len(argv) == 2:
        if not argv[0].startswith("-"):
            print("usage: papr -g <infile>", file=sys.stderr)
            return 255
        for ch in argv[0][1:]:
            if ch in "gG":
                graph = True
            else:
                print(f"Unsupported Option: {ch}", file=sys.stderr)
        path = argv[1]
    else:
        path = argv[0]
    try:
        dev = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        print(f"papr: {e}", file=sys.stderr)
        return 255
    try:
        text = report(path, graph, device=dev)
    except FileNotFoundError:
        print(f"Cannot open bitstream file <{path}>", file=sys.stderr)
        return 255
    sys.stdout.write(text)
    return 0
