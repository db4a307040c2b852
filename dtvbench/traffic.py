"""Inputs made from ``--seed``: sub-seeds per purpose, transport-stream
blocks, and the seeded choice of which answers are checked.

The TS blocks are what ``dtv_utils_torch/bench.py`` makes (``_ts_block``:
uniform payload bytes, 0x47 every 188 bytes), drawn here by a
``torch.Generator`` on the device in one call.
"""

from __future__ import annotations

import hashlib
import random

import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose, from any whole ``seed``."""
    h = hashlib.sha256(f"{seed}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def ts_blocks(n: int, block_bytes: int, seed: int, purpose: str,
              device) -> torch.Tensor:
    """uint8 [n, block_bytes]: seeded payload, the rows one stream, with
    a sync byte 0x47 at every 188th byte of it, counted from the first
    row's start.  A block need not hold whole packets (a DVB-T2 frame's
    TS does not); where it does, every row starts with a sync byte."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, purpose))
    ts = torch.randint(0, 256, (n, block_bytes), generator=g,
                       dtype=torch.uint8, device=device)
    ts.view(-1)[::188] = 0x47
    return ts


class Sample:
    """A seeded uniform sample of at most ``k`` of a run's calls, whose
    count is not known beforehand (reservoir sampling): ``offer(i)``
    says whether call i enters the sample, and which place it takes."""

    def __init__(self, k: int, seed: int, purpose: str):
        self.k = k
        self.seen = 0
        self.rng = random.Random(sub_seed(seed, purpose))

    def offer(self) -> int | None:
        self.seen += 1
        if self.seen <= self.k:
            return self.seen - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None
