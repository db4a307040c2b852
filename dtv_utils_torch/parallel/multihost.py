"""Multi-process execution over ``torch.distributed`` (port of
``dtv_utils_tpu/parallel/multihost.py``).

The sequence sharding of ``parallel/stream.py`` spans processes unchanged:
rank r holds the contiguous time-blocks [r·L, (r+1)·L), and the only
traffic between ranks is the all-gathered halo.  TS ingest is striped per
rank: each rank reads only its own byte range of the input
(``host_block_range``) and uploads it to its own device
(``make_local_blocks``); no rank ever holds the full stream.  There is no
global array in torch, so where the reference assembles one
(``make_global_blocks``), each rank keeps its stripe as a local tensor, and
``local_output`` hands the rank's output onward with its first block index.

Nothing here reads the environment: ``initialize`` takes the rendezvous
address (``tcp://host:port`` or ``file:///path``), the world size and the
rank from its caller.  CUDA ranks use NCCL, one device each; CPU ranks use
gloo.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dtv_utils_torch.parallel.stream import _BACKENDS, _require_group
from dtv_utils_torch.utils.device import resolve_device


def initialize(init_method: str, world_size: int, rank: int, *,
               device="cuda") -> torch.device:
    """Join the process group: NCCL with ``torch.cuda.set_device`` for a
    CUDA ``device``, gloo for ``"cpu"``.  Returns the resolved device.
    Asking for CUDA without a card raises (no fallback to gloo)."""
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(_BACKENDS[dev.type], init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return dev


def host_block_range(n_blocks: int, group=None) -> tuple[int, int]:
    """[start, stop) of the global time-blocks this rank must ingest
    (``group`` None: the default group)."""
    _require_group()
    world = dist.get_world_size(group)
    if n_blocks % world:
        raise ValueError(f"{n_blocks} blocks do not split over {world} ranks")
    per = n_blocks // world
    rank = dist.get_rank(group)
    return rank * per, (rank + 1) * per


def make_local_blocks(local_blocks: np.ndarray, n_blocks: int, *,
                      device, group=None) -> torch.Tensor:
    """This rank's stripe ([stop − start, block_bytes] host uint8, the
    blocks ``host_block_range`` names) uploaded to ``device``: the
    counterpart of the reference's ``make_global_blocks``."""
    start, stop = host_block_range(n_blocks, group)
    if local_blocks.ndim != 2 or local_blocks.shape[0] != stop - start:
        raise ValueError(f"this rank holds blocks [{start}, {stop}), got "
                         f"an array of shape {local_blocks.shape}")
    return torch.from_numpy(np.ascontiguousarray(
        local_blocks, dtype=np.uint8)).to(resolve_device(device))


def local_output(out: torch.Tensor, group=None) -> tuple[int, np.ndarray]:
    """(first global block, host copy) of this rank's output ``out``
    [L, ...], one entry per local block: each rank hands its own stripe of
    IQ onward without gathering the stream."""
    _require_group()
    return dist.get_rank(group) * out.shape[0], out.cpu().numpy()
