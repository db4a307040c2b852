"""K=7 convolutional mother code + DVB puncturing (port of
``dtv_utils_tpu/ops/convcode.py``).

A convolutional code is a linear filter over GF(2): with the whole block in
a bit tensor, each output stream is the XOR of a few shifted copies of the
input.  The only state across blocks is the last 6 input bits.

Mother code (EN 300 744 §4.3.3): K=7, G1=171oct (X), G2=133oct (Y).
"""

from __future__ import annotations

import numpy as np
import torch

# Tap positions j (output = XOR of d[i-j]) for the two generators.
G1_TAPS = (0, 1, 2, 3, 6)   # 171 octal = 1111001b
G2_TAPS = (0, 2, 3, 5, 6)   # 133 octal = 1011011b

# EN 300 744 table 3 puncturing patterns: (X pattern, Y pattern) per period.
# Serial output order per step i: X_i (if kept) then Y_i (if kept).
PUNCTURE_PATTERNS: dict[tuple[int, int],
                        tuple[tuple[int, ...], tuple[int, ...]]] = {
    (1, 2): ((1,), (1,)),
    (2, 3): ((1, 0), (1, 1)),
    (3, 4): ((1, 0, 1), (1, 1, 0)),
    (5, 6): ((1, 0, 1, 0, 1), (1, 1, 0, 1, 0)),
    (7, 8): ((1, 0, 0, 0, 1, 0, 1), (1, 1, 1, 1, 0, 1, 0)),
}


def conv_encode(data_bits: torch.Tensor,
                state_bits: torch.Tensor) -> torch.Tensor:
    """Encode a bit block given the 6 bits of preceding stream history.

    data_bits: uint8 [n] in {0,1}; state_bits: uint8 [6], state_bits[j] is
    the input bit at stream position -1-j (most recent first).  Returns
    uint8 [n, 2] with columns (X, Y) per input bit.
    """
    n = data_bits.shape[0]
    d_ext = torch.cat([torch.flip(state_bits, (0,)).to(torch.uint8),
                       data_bits.to(torch.uint8)])
    x = torch.zeros(n, dtype=torch.uint8, device=data_bits.device)
    y = torch.zeros(n, dtype=torch.uint8, device=data_bits.device)
    for j in G1_TAPS:
        x = x ^ d_ext[6 - j:6 - j + n]
    for j in G2_TAPS:
        y = y ^ d_ext[6 - j:6 - j + n]
    return torch.stack([x, y], dim=-1)


def puncture_indices(code_rate: tuple[int, int], n_pairs: int) -> np.ndarray:
    """Gather indices selecting kept bits from the flattened [n_pairs*2]
    serial (X0,Y0,X1,Y1,...) stream.  ``n_pairs`` must be a multiple of the
    puncture period, so block boundaries stay phase-aligned."""
    xp, yp = PUNCTURE_PATTERNS[code_rate]
    period = len(xp)
    if n_pairs % period:
        raise ValueError(f"n_pairs={n_pairs} is not a multiple of the "
                         f"puncture period {period}")
    keep = []
    for i in range(period):
        if xp[i]:
            keep.append(2 * i)
        if yp[i]:
            keep.append(2 * i + 1)
    base = np.asarray(keep, dtype=np.int64)
    reps = n_pairs // period
    return (np.arange(reps, dtype=np.int64)[:, None] * (2 * period)
            + base[None, :]).reshape(-1)
