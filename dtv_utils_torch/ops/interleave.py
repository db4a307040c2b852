"""The Forney convolutional interleaver as one gather (port of
``dtv_utils_tpu/ops/interleave.py``).

Its state is the last ``(I-1)*I*M`` bytes of the input stream, so a block
is interleaved by gathering from ``carry ++ block`` with a static index.
"""

from __future__ import annotations

import numpy as np
import torch


def forney_carry_len(I: int, M: int) -> int:
    return (I - 1) * I * M


def forney_gather_indices(I: int, M: int, n: int) -> np.ndarray:
    """Indices into [carry (len C) ++ block (len n)] giving the interleaved
    block: output position k (branch b = k mod I) carries the input byte at
    stream position k - b*I*M; negative positions fall in the carry.  Needs
    n % I == 0, so every block starts at commutator phase 0."""
    if n % I:
        raise ValueError(f"block of {n} bytes is not a multiple of I={I}")
    C = forney_carry_len(I, M)
    k = np.arange(n, dtype=np.int64)
    return k - (k % I) * I * M + C


def forney_interleave(block: torch.Tensor, carry: torch.Tensor,
                      idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One block: block uint8 [n], carry uint8 [C] (zeros at stream start),
    idx the ``forney_gather_indices`` on the block's device.  Returns
    (out [n], new_carry [C])."""
    C = carry.shape[0]
    ext = torch.cat([carry, block])
    return ext[idx], ext[-C:].clone()
