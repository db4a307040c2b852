"""Published peaks of the card and the work a call needs, counted from the
problem's shapes and never from what an implementation chooses to store.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit; a share is stated with the card's own limit beside it.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks(kind: str) -> dict:
    """The data sheet's peaks of the card named ``kind``."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}")
    return PEAKS[kind]


def viterbi_least_s(steps: int, k: int, llrs: int, kind: str) -> float:
    """Least time of a soft Viterbi decode of ``steps`` trellis steps of a
    constraint-length ``k`` code fed ``llrs`` float32 LLRs: per step and
    state one add-compare-select (two adds and one max, three
    operations), each LLR read once and each decoded bit written once."""
    p = peaks(kind)
    ops = 3 * steps * (1 << (k - 1))
    nbytes = 4 * llrs + steps / 8
    return max(ops / p["fp32_flops"], nbytes / p["hbm_bytes"])
