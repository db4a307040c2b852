"""Batched and sequence-sharded modulation (port of
``dtv_utils_tpu/parallel/stream.py``).

The time axis is cut in contiguous blocks (superframes, T2 frames or
superblocks).  On one device a call on L consecutive blocks needs no
per-block state: every coupling of the three chains is continuous across
block boundaries, so the chains' stage functions run each stage once over
the L blocks as one stream (``tx/dvbt.py``, ``tx/dvbt2.py``,
``tx/j83b.py``), and the batched modulators here only find the state at
the call's first block.  For a call that continues a stream that state is
a pure function of the previous block's raw TS tail:

  * DVB-T: dispersal packet phase = (block_idx * packets_per_block) mod 8;
    the outer interleaver carry and the conv-coder memory are recomputed
    from the last HALO_PACKETS packets (``derive_state``);
  * DVB-T2: packet phase = (frame_idx * payload_bytes) mod 188, and the
    CRC-8 window is the last 187 raw bytes;
  * J.83B: the interleaver carry is recomputed from the last
    J83B_HALO_PACKETS packets (``derive_j83b_ilv_carry``) and the trellis
    memories are constants at superblock boundaries
    (``_j83b_conv_consts``); the precoder quadrant and the filter history
    are not functions of the raw tail, see ``sharded_j83b_modulator``.

The one-device batched modulators are captured calls, as the reference's
are jitted: ``batched_dvbt_modulator`` and ``_batched_dvbt2_modulator``
return a ``utils/graph.Jit`` of the eager ``modulate_dvbt_blocks`` /
``modulate_dvbt2_blocks``, one CUDA graph per batch size on the card.
Their block index ``start_idx`` is a device scalar, a 0-d int32 tensor (a
Python int is turned into one), and every use of it is on the device: a
block-0 state is picked by ``torch.where``, and every product of an index
with a block size is taken in int64, so no phase wraps however long the
stream (the reference computes ``global_idx * blk`` in int32, which wraps
at DVB-T2 BBC's frame 1980).  The sharded modulators call the eager
functions: their collectives cannot be captured.

Across processes the ``torch.distributed`` process group plays the part of
the reference's mesh axis ``seq``: rank r holds global blocks
[r·L, (r+1)·L), and the one-hop ``ppermute`` of the reference becomes an
``all_gather`` (list form) from which rank r takes rank r−1's piece.
There is no ``Mesh`` in torch and nothing here builds one: every function
takes a process ``group`` (None: the default group), and ``make_mesh``
only returns that group, for the reference's exported names.
The group's backend must match the device of the blocks, NCCL for CUDA and
gloo for the CPU; a sharded function raises without an initialized group.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from dtv_utils_torch.core import bits as bitops
from dtv_utils_torch.core.config import DvbtConfig, Dvbt2Config, J83bConfig
from dtv_utils_torch.ops.fir import HIST
from dtv_utils_torch.ops.interleave import forney_carry_len
from dtv_utils_torch.ops.rs import DVBT_RS
from dtv_utils_torch.tx import dvbt as txd
from dtv_utils_torch.tx import dvbt2 as txt2
from dtv_utils_torch.tx import j83b as txq
from dtv_utils_torch.utils.device import resolve_device
from dtv_utils_torch.utils.graph import Jit

HALO_PACKETS = 12      # 12·204 = 2448 ≥ 2244-byte interleaver carry
T2_HALO_BYTES = 187    # the DVB-T2 CRC-8 window

J83B_HALO_PACKETS = 427
"""J.83B halo: 427 packets = lcm alignment of TS packets (1504 bits),
7-bit symbolization, and RS(128,122) codewords (854 bits) — 427·1504 =
642,208 bits = 752 whole codewords = 96,256 RS output symbols, which covers
the (I−1)·I·J = 65,024-symbol Forney interleaver reach.  A superblock is
exactly 15 such units (6405 = 15·427)."""

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(group=None):
    """The process group that stands for the reference's ``seq`` mesh
    axis: ``group``, or the default group.  Raises without one.  Kept only
    so that ``parallel.__all__`` names what the reference's does; the
    port's own functions take ``group`` (None: the default group)."""
    _require_group()
    return group if group is not None else dist.group.WORLD


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group is "
                           "initialized (multihost.initialize); the "
                           "one-device path is the batched modulator")


def _check_backend(group, device: torch.device) -> None:
    want = _BACKENDS[device.type]
    got = dist.get_backend(group)
    if got != want:
        raise RuntimeError(f"process group backend {got!r} does not serve "
                           f"{device.type} tensors: need {want!r}")


def _gather_prev(piece: torch.Tensor, group) -> torch.Tensor | None:
    """Every rank sends ``piece``; returns rank r−1's (None on rank 0,
    whose own piece the ring would send to the last rank and which it
    discards, as the reference does)."""
    pieces = [torch.empty_like(piece)
              for _ in range(dist.get_world_size(group))]
    dist.all_gather(pieces, piece.contiguous(), group=group)
    rank = dist.get_rank(group)
    return pieces[rank - 1] if rank else None


def _check_blocks(blocks: torch.Tensor, blk: int,
                  device: torch.device | None = None) -> int:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 \
            or blocks.shape[1] != blk or not blocks.shape[0]:
        raise ValueError(f"need uint8 blocks [L, {blk}], got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if device is not None and blocks.device != device:
        raise ValueError(f"blocks on {blocks.device}, not on {device}")
    return blocks.shape[0]


def block_index(idx: int | torch.Tensor, device: torch.device
                ) -> torch.Tensor:
    """A block index as the 0-d int32 tensor on ``device`` that the
    batched modulators take: a Python int becomes one by a fill on the
    device (no host-to-device copy, no sync)."""
    if isinstance(idx, torch.Tensor):
        if idx.dim() or idx.dtype != torch.int32 or idx.device != device:
            raise ValueError(f"start_idx must be a 0-d int32 tensor on "
                             f"{device}, got {idx.dtype} {tuple(idx.shape)} "
                             f"on {idx.device}")
        return idx
    if not 0 <= idx < 2**31:
        raise ValueError(f"block index {idx} outside int32")
    return torch.full((), idx, dtype=torch.int32, device=device)


def _tail(prev_tail: torch.Tensor | None, n: int,
          device: torch.device) -> torch.Tensor:
    """``prev_tail``, or n zero bytes where there is none (block 0)."""
    if prev_tail is None:
        return torch.zeros(n, dtype=torch.uint8, device=device)
    if prev_tail.shape != (n,) or prev_tail.dtype != torch.uint8:
        raise ValueError(f"prev_tail must be uint8 [{n}], got "
                         f"{prev_tail.dtype} {tuple(prev_tail.shape)}")
    return prev_tail


@functools.cache
def _jit_blocks(fn, cfg, device: torch.device) -> Jit:
    """The captured form of a batched call, one per (call, config,
    device): every runner made for them shares its graphs."""
    return Jit(functools.partial(fn, cfg), device=device)


# ---------------------------------------------------------------------------
# DVB-T
# ---------------------------------------------------------------------------

def derive_state(cfg: DvbtConfig, prev_tail: torch.Tensor,
                 block_idx: int | torch.Tensor) -> txd.DvbtState:
    """The stream state at the start of superframe ``block_idx`` (global,
    >= 1; an int, or a 0-d int32 tensor on ``prev_tail.device``) from the
    previous superframe's last HALO_PACKETS packets of raw TS bytes, uint8
    [HALO_PACKETS*188], on ``prev_tail.device``.  For block 0 the stream
    starts from ``init_state`` instead."""
    if not isinstance(block_idx, torch.Tensor) and block_idx < 1:
        raise ValueError(f"block_idx {block_idx}: block 0 starts from "
                         "init_state")
    n_pkt = cfg.rs_blocks_per_superframe
    dev = prev_tail.device
    pkt = block_index(block_idx, dev).to(torch.int64) * n_pkt
    halo_phase = (pkt - HALO_PACKETS) % 8
    row = txd.dispersal_rows(HALO_PACKETS, dev).index_select(
        0, halo_phase.reshape(1))[0]
    rs_tail = DVBT_RS().encode_bytes(
        (prev_tail ^ row).reshape(HALO_PACKETS, 188)).reshape(-1)
    C = forney_carry_len(txd.OUTER_I, txd.OUTER_M)
    # The last outer-interleaved byte of the previous block is its RS byte
    # n-1-(11*204) = n-2245 (branch 11 of the Forney commutator), which sits
    # at index 2448-2245 = 203 inside this tail; conv state = its bits,
    # most recent (LSB) first.
    last_byte = rs_tail[HALO_PACKETS * 204 - C - 1]
    shifts = torch.arange(6, dtype=torch.uint8, device=dev)
    return txd.DvbtState(
        packet_phase=(pkt % 8).to(torch.int32),
        outer_carry=rs_tail[-C:].clone(),
        conv_state=(last_byte >> shifts) & 1)


def modulate_dvbt_blocks(cfg: DvbtConfig, ts_blocks: torch.Tensor,
                         prev_tail: torch.Tensor,
                         start_idx: torch.Tensor) -> torch.Tensor:
    """The eager batched DVB-T call: ``ts_blocks`` uint8 [B, blk], the
    consecutive superframes start_idx … start_idx+B−1 of a stream, in one
    pass of the chain → IQ complex64 [B, samples_per_superframe].  The
    state at the first block is derived from ``prev_tail`` (uint8
    [HALO_PACKETS*188], the last bytes of superframe start_idx−1) and
    replaced by ``init_state`` where ``start_idx`` (a 0-d int32 tensor, see
    ``block_index``) is 0, by ``torch.where`` on the device."""
    dev = ts_blocks.device
    derived = derive_state(cfg, prev_tail, start_idx)
    init = txd.init_state(cfg, device=dev)
    state = txd.DvbtState(**{
        f.name: torch.where(start_idx == 0, getattr(init, f.name),
                            getattr(derived, f.name))
        for f in dataclasses.fields(init)})
    iq, _ = txd.modulate_superframe(cfg, ts_blocks.reshape(-1), state)
    return iq.reshape(ts_blocks.shape[0], -1)


def batched_dvbt_modulator(cfg: DvbtConfig, *, device="cuda"):
    """One-device batched modulator, the counterpart of the reference's
    jitted one: ``fn(ts_blocks, prev_tail, start_idx)`` runs
    ``modulate_dvbt_blocks`` as one captured CUDA graph per batch size on
    ``device`` (eager through the same static buffers on the CPU) and
    returns IQ complex64 [B, samples_per_superframe] that is the caller's.
    ``start_idx`` is a 0-d int32 tensor on ``device`` or an int;
    ``prev_tail`` is read only where start_idx > 0 (None: zeros)."""
    dev = resolve_device(device)
    blk = cfg.ts_bytes_per_superframe
    call = _jit_blocks(modulate_dvbt_blocks, cfg, dev)

    def run(ts_blocks: torch.Tensor, prev_tail: torch.Tensor | None,
            start_idx: int | torch.Tensor) -> torch.Tensor:
        _check_blocks(ts_blocks, blk, dev)
        return call(ts_blocks, _tail(prev_tail, HALO_PACKETS * 188, dev),
                    block_index(start_idx, dev))

    return run


def sharded_dvbt_modulator(cfg: DvbtConfig, group=None):
    """``fn(local_blocks)``: rank r's superframes [r·L, (r+1)·L) of a
    stream that starts at global block 0, uint8 [L, blk] on the rank's
    device (every rank holds the same L) → its IQ complex64 [L, samples].
    One all-gather of each rank's last HALO_PACKETS packets carries the
    state across ranks."""
    _require_group()
    halo = HALO_PACKETS * 188

    def run(local_blocks: torch.Tensor) -> torch.Tensor:
        L = _check_blocks(local_blocks, cfg.ts_bytes_per_superframe)
        dev = local_blocks.device
        _check_backend(group, dev)
        prev = _gather_prev(local_blocks[-1, -halo:], group)
        return modulate_dvbt_blocks(
            cfg, local_blocks, _tail(prev, halo, dev),
            block_index(dist.get_rank(group) * L, dev))

    return run


# ---------------------------------------------------------------------------
# DVB-T2
# ---------------------------------------------------------------------------

def _dvbt2_state(cfg: Dvbt2Config, prev_tail: torch.Tensor,
                 frame_idx: int | torch.Tensor, device: torch.device
                 ) -> txt2.Dvbt2State:
    """The state at the start of T2 frame ``frame_idx`` of a stream (an
    int or a 0-d int32 tensor on ``device``): the packet phase
    (frame_idx * payload_bytes) mod 188, taken in int64 on the device, and
    the previous frame's last 187 raw bytes, zeros for frame 0 (picked by
    ``torch.where``)."""
    idx = block_index(frame_idx, device)
    phase = idx.to(torch.int64) * cfg.payload_bytes_per_frame % 188
    return txt2.Dvbt2State(packet_phase=phase.to(torch.int32),
                           prev_tail=torch.where(idx == 0, 0, prev_tail))


def modulate_dvbt2_blocks(cfg: Dvbt2Config, ts_frames: torch.Tensor,
                          prev_tail: torch.Tensor,
                          start_idx: torch.Tensor) -> torch.Tensor:
    """The eager batched DVB-T2 call: ``ts_frames`` uint8 [B,
    payload_bytes], frames start_idx … start_idx+B−1 of a stream (a 0-d
    int32 tensor, see ``block_index``), in one pass of the chain → IQ
    complex64 [B, samples_per_frame]; ``prev_tail`` uint8 [187] is read
    only where start_idx > 0."""
    state = _dvbt2_state(cfg, prev_tail, start_idx, ts_frames.device)
    iq, _ = txt2.modulate_frame(cfg, ts_frames.reshape(-1), state)
    return iq.reshape(ts_frames.shape[0], -1)


def _batched_dvbt2_modulator(cfg: Dvbt2Config, *, device="cuda"):
    """DVB-T2 counterpart of ``batched_dvbt_modulator``: ``fn(ts_frames
    uint8 [B, payload_bytes], prev_tail uint8 [187] or None, start_idx)``
    → IQ complex64 [B, samples_per_frame], ``modulate_dvbt2_blocks`` as
    one captured CUDA graph per batch size (bench.py's 4-frame launch is
    B = 4)."""
    dev = resolve_device(device)
    call = _jit_blocks(modulate_dvbt2_blocks, cfg, dev)

    def run(ts_frames: torch.Tensor, prev_tail: torch.Tensor | None,
            start_idx: int | torch.Tensor) -> torch.Tensor:
        _check_blocks(ts_frames, cfg.payload_bytes_per_frame, dev)
        return call(ts_frames, _tail(prev_tail, T2_HALO_BYTES, dev),
                    block_index(start_idx, dev))

    return run


def sharded_dvbt2_modulator(cfg: Dvbt2Config, group=None):
    """``fn(local_frames uint8 [L, payload_bytes])`` → rank r's IQ
    complex64 [L, samples_per_frame] for frames [r·L, (r+1)·L); the halo is
    an all-gather of each rank's last 187 raw bytes."""
    _require_group()

    def run(local_frames: torch.Tensor) -> torch.Tensor:
        L = _check_blocks(local_frames, cfg.payload_bytes_per_frame)
        dev = local_frames.device
        _check_backend(group, dev)
        prev = _gather_prev(local_frames[-1, -T2_HALO_BYTES:], group)
        return modulate_dvbt2_blocks(
            cfg, local_frames, _tail(prev, T2_HALO_BYTES, dev),
            block_index(dist.get_rank(group) * L, dev))

    return run


# ---------------------------------------------------------------------------
# J.83B
# ---------------------------------------------------------------------------

@functools.cache
def _j83b_conv_consts() -> tuple[np.ndarray, np.ndarray]:
    """Trellis coder memories at every superblock boundary are CONSTANTS:
    the final 28-bit trellis group of a superblock lies entirely inside the
    (constant) 42-bit FSYNC trailer — frame bits % 28 = 14, so groups align
    at 2-frame granularity and the last group is FSYNC bits 14..41.  The
    feed-forward K=5 coder memory is just its last 4 input bits, most
    recent first."""
    grp = txq._fsync_bits()[-28:]
    a, b = grp[0::2], grp[1::2]
    return (np.ascontiguousarray(a[10:][::-1]),
            np.ascontiguousarray(b[10:][::-1]))


@functools.cache
def _j83b_conv_device(device: torch.device
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_j83b_conv_consts`` on ``device``, uploaded once."""
    return tuple(torch.from_numpy(m).to(device) for m in _j83b_conv_consts())


def derive_j83b_ilv_carry(prev_tail: torch.Tensor) -> torch.Tensor:
    """The Forney interleaver carry entering a superblock, int32 [65,024],
    from the previous superblock's last J83B_HALO_PACKETS packets of raw
    TS bytes: framing → 7-bit symbolization → RS — all boundaries align
    (see J83B_HALO_PACKETS), and the carry is the last 65,024 RS output
    symbols."""
    framed = txq.transport_framing(
        prev_tail.reshape(J83B_HALO_PACKETS, 188)).reshape(-1)
    syms = bitops.bits_to_words(bitops.bytes_to_bits(framed), 7)
    cw = txq.rs_encode(syms.reshape(-1, txq.RS_K)).reshape(-1)
    C = (txq.ILV_I - 1) * txq.ILV_I * txq.ILV_J
    return cw[-C:].to(torch.int32)


def _rotate_quadrants(cells: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Rail-major cells [2, n] times (−j)^k for an int32 0-d ``k`` on the
    device: a rail swap and sign flips picked by ``torch.where``, exact in
    float32 with or without TF32 (no product is formed)."""
    x, y = cells[0], cells[1]
    swap = (k & 1).bool()
    re = torch.where(swap, y, x)              # k: 0 → x, 1 → y, 2 → -x, 3 → -y
    im = torch.where(swap, x, y)              # k: 0 → y, 1 → -x, 2 → -y, 3 → x
    neg_re = ((k >> 1) & 1).bool()
    neg_im = ((k ^ (k >> 1)) & 1).bool()
    return torch.stack([torch.where(neg_re, -re, re),
                        torch.where(neg_im, -im, im)])


def sharded_j83b_modulator(cfg: J83bConfig, group=None):
    """``fn(local_blocks uint8 [L, SUPERBLOCK_BYTES])`` → rank r's IQ
    float32 [L, 2, 2·SUPERBLOCK_SYMBOLS] (rails per superblock, a view of
    the one FIR output) for superblocks [r·L, (r+1)·L), bit-identical to
    ``modulate_stream``.

    The rank's L superblocks run as one stream.  At the rank's first block:
      * interleaver carry — recomputed from an all-gather of each rank's
        427-packet raw tail (``derive_j83b_ilv_carry``);
      * trellis coder memories — constants (``_j83b_conv_consts``), zeros
        for the stream's block 0;
      * differential precoder — the rank encodes with q0 = 0 and
        all-gathers its quadrant total (one int32); advancing the precoder
        by Δ quadrants turns every cell by (−j)^Δ (the constellation's
        rotation symmetry, tests/test_j83b_invariants.py), so the rank
        turns its cells by the exclusive prefix of the earlier ranks'
        totals — one offset per rank, its blocks being continuous;
      * RRC history — an all-gather of each rank's last 49 turned cells.
    """
    _require_group()
    halo = J83B_HALO_PACKETS * 188
    taps = txq.rrc_taps(cfg)

    def run(local_blocks: torch.Tensor) -> torch.Tensor:
        L = _check_blocks(local_blocks, txq.SUPERBLOCK_BYTES)
        dev = local_blocks.device
        _check_backend(group, dev)
        prev = _gather_prev(local_blocks[-1, -halo:], group)
        state = txq.init_state(cfg, device=dev)
        if prev is not None:
            state.ilv_carry = derive_j83b_ilv_carry(prev)
            state.conv_a, state.conv_b = _j83b_conv_device(dev)
        cells, state = txq.encode_to_cells(cfg, local_blocks.reshape(-1),
                                           state)
        w, z = state.diff_state.to(torch.int32)
        q_total = ((w << 1) | (w ^ z)).reshape(1)
        totals = [torch.empty_like(q_total)
                  for _ in range(dist.get_world_size(group))]
        dist.all_gather(totals, q_total, group=group)
        rank = dist.get_rank(group)
        if rank:
            offset = torch.cat(totals[:rank]).sum(dtype=torch.int32) & 3
            cells = _rotate_quadrants(cells, offset)
        hist = _gather_prev(cells[:, -HIST:], group)
        if hist is None:
            hist = torch.zeros((2, HIST), dtype=torch.float32, device=dev)
        iq, _ = txq.rrc_interpolate(cells, hist, taps)
        return iq.reshape(2, L, -1).transpose(0, 1)

    return run
