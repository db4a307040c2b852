"""The seeded TS blocks: sync bytes at every 188th byte of the stream,
counted from the first row's start.  For blocks of whole packets (a
DVB-T superframe, a J.83B superblock) every tensor is byte for byte what
the rule of one sync byte per 188 bytes of each row made, at a capture's
two rows and at a pool's twelve; for blocks that are not (a BBC DVB-T2
frame's 1,084,740 bytes), only the stream's multiples of 188 hold a
forced 0x47.
"""

from __future__ import annotations

import pytest
import torch

from dtvbench import traffic
from dtvbench.standards import dvbt, j83b

SEEDS = (7, 2**31 + 1, 2**40 + 5)
T2_FRAME_BYTES = 1084740


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def _draw(n: int, block_bytes: int, seed: int, purpose: str,
          device) -> torch.Tensor:
    """The payload before any sync byte is forced."""
    g = torch.Generator(device=device)
    g.manual_seed(traffic.sub_seed(seed, purpose))
    return torch.randint(0, 256, (n, block_bytes), generator=g,
                         dtype=torch.uint8, device=device)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [2, 12])
@pytest.mark.parametrize("block_bytes", [dvbt.BLOCK_BYTES, j83b.BLOCK_BYTES])
def test_whole_packet_blocks_keep_the_per_row_rule(block_bytes, n, seed,
                                                    device):
    assert block_bytes % 188 == 0
    per_row = _draw(n, block_bytes, seed, "pool", device)
    per_row[:, ::188] = 0x47
    got = traffic.ts_blocks(n, block_bytes, seed, "pool", device)
    assert torch.equal(got, per_row)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2])
def test_sync_bytes_follow_the_stream(n, seed, device):
    raw = _draw(n, T2_FRAME_BYTES, seed, "capture", device).view(-1)
    got = traffic.ts_blocks(n, T2_FRAME_BYTES, seed, "capture",
                            device).view(-1)
    forced = torch.zeros_like(got, dtype=torch.bool)
    forced[::188] = True
    assert bool((got[forced] == 0x47).all())
    assert torch.equal(got[~forced], raw[~forced])
