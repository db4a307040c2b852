"""ITU-T J.83 Annex B (SCTE 07) 64-QAM cable modulator in PyTorch.

Port of ``dtv_utils_tpu/tx/j83b.py``, stage for stage and bit for bit:
transport framing → 7-bit symbolization → RS(128,122) over GF(128) →
(I=128, J=4) convolutional interleaver → GF(128) randomizer → frame sync →
trellis-coded modulation → 64-QAM map → RRC interpolate-by-2, over a
"superblock" of 188 FEC frames (6405 TS packets in, 1,806,210 symbols,
3,612,420 complex samples out).  A call takes one superblock or L
consecutive ones: every state coupling (the interleaver carry, the coder
memories, the precoder's running quadrant, the filter history) is
continuous across superblocks, so each stage runs once over the L
superblocks as one stream, with the launches of a one-superblock call and
one FIR launch.

The chain runs eagerly on the device of its input.  GF(2)-linear stages are
float32 matrix products (``core/galois.gf2_matmul``), the interleaver is one
cached gather, the precoder a cumsum, and the RRC filter is the
hand-written CUDA kernel behind ``ops/fir.polyphase_interp2_split`` (its
plain PyTorch version on the CPU).  Host tables are NumPy copies of the
reference's builders, pinned to them by ``tests/test_torch_core.py``; each
is uploaded once per device.  Constants marked PARITY-RISK in the reference
(PARITY.md) are the same here.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np
import torch

from dtv_utils_torch.core import bits as bitops
from dtv_utils_torch.core import cplx
from dtv_utils_torch.core.config import J83bConfig
from dtv_utils_torch.core.galois import GF128, gf2_matmul, gf2_poly_mod_matrix
from dtv_utils_torch.ops.fir import HIST, polyphase_interp2_split
from dtv_utils_torch.ops.rs import RsBitEncoder
from dtv_utils_torch.utils.device import resolve_device
from dtv_utils_torch.utils.graph import Jit
from dtv_utils_torch.utils.trace import span, wait

# ---------------------------------------------------------------------------
# Frame constants (64-QAM mode)
# ---------------------------------------------------------------------------
RS_N, RS_K = 128, 122
BLOCKS_PER_FRAME = 60                  # RS blocks per FEC frame
FRAME_SYMBOLS = BLOCKS_PER_FRAME * RS_N          # 7680 7-bit symbols
FSYNC_BITS = 42
FRAME_BITS = FRAME_SYMBOLS * 7 + FSYNC_BITS      # 53802
FRAMES_PER_SUPERBLOCK = 188
PACKETS_PER_SUPERBLOCK = 6405          # = 188 frames of TS bytes
TRELLIS_GROUP_IN, TRELLIS_GROUP_OUT = 28, 30
SUPERBLOCK_BYTES = PACKETS_PER_SUPERBLOCK * 188
SUPERBLOCK_SYMBOLS = FRAMES_PER_SUPERBLOCK * FRAME_BITS // TRELLIS_GROUP_IN * 5

# 42-bit frame sync trailer: 38-bit sync pattern + 4-bit control word
# (6 ⇒ I=128, J=4).  PARITY-RISK in the reference, copied unchanged.
FSYNC_SYNC_PATTERN = 0x2CA2C92CA >> 4      # 38 bits
CONTROL_WORD = 6
FSYNC_WORD = (FSYNC_SYNC_PATTERN << 4) | CONTROL_WORD  # 42 bits

# interleaver: branch b delays b*J symbols, commutated over I branches
ILV_I, ILV_J = 128, 4

# trellis binary convolutional generators, octal 25 / 37 (K=5, 16-state)
G1_TAPS = (0, 2, 4)        # 25oct = 10101b
G2_TAPS = (0, 1, 2, 3, 4)  # 37oct = 11111b
# rate-4/5 puncture: 4 input steps → 5 kept of 8 (PARITY-RISK)
PUNCT_X = (1, 0, 0, 1)
PUNCT_Y = (1, 1, 1, 0)
# positions kept from each 8-bit (x0 y0 x1 y1 ... x3 y3) period
PUNCT_KEEP = tuple(k for i in range(4)
                   for k, on in ((2 * i, PUNCT_X[i]), (2 * i + 1, PUNCT_Y[i]))
                   if on)

# 64-QAM constellation LUT, exactly the literal the reference passes to
# chunks_to_symbols (qam-blade.py:57); index = 6-bit trellis output word
CONSTELLATION_64 = np.array([
    1+1j, 1-1j, 1-3j, -3-1j, -3+1j, 1+3j, -3-3j, -3+3j,
    -1+1j, -1-1j, 3+1j, -1+3j, -1-3j, 3-1j, 3-3j, 3+3j,
    5+1j, 1-5j, 1-7j, -7-1j, -3+5j, 5+3j, -7-3j, -3+7j,
    -1+5j, -5-1j, 7+1j, -1+7j, -5-3j, 3-5j, 3-7j, 7+3j,
    1+5j, 5-1j, 5-3j, -3-5j, -7+1j, 1+7j, -3-7j, -7+3j,
    -5+1j, -1-5j, 3+5j, -5+3j, -1-7j, 7-1j, 7-3j, 3+7j,
    5+5j, 5-5j, 5-7j, -7-5j, -7+5j, 5+7j, -7-7j, -7+7j,
    -5+5j, -5-5j, 7+5j, -5+7j, -5-7j, 7-5j, 7-7j, 7+7j,
], dtype=np.complex64)

# rail-major LUT (float32 [2, 64]): indexing with words gives cells [2, n]
CONSTELLATION_64_RAILS = np.ascontiguousarray(
    np.stack([CONSTELLATION_64.real, CONSTELLATION_64.imag]), dtype=np.float32)


# ---------------------------------------------------------------------------
# Host-side tables (copies of the reference's builders)
# ---------------------------------------------------------------------------

@functools.cache
def _rs() -> RsBitEncoder:
    """(127,122) RS over GF(128), g(x) = Π_{i=1..5}(x + α^i), singly
    extended to (128,122) with an overall GF-sum parity symbol."""
    return RsBitEncoder(GF128, k_sym=RS_K, nroots=5, first_root=1)


@functools.cache
def _ext_sum_matrix() -> np.ndarray:
    """GF(2) matrix [127*7, 7]: extension symbol = GF-sum (XOR) of all 127
    symbols — per-bitplane XOR, i.e. a parity matrix with identity blocks."""
    m = np.zeros((127 * 7, 7), dtype=np.uint8)
    for s in range(127):
        m[s * 7:(s + 1) * 7] = np.eye(7, dtype=np.uint8)
    return m


@functools.cache
def _randomizer_frame() -> np.ndarray:
    """Per-frame randomizer sequence: 7680 GF(128) symbols from the degree-3
    LFSR over GF(128) x³ + x + α³, reseeded to all-ones each FSYNC."""
    gf = GF128
    alpha3 = gf.pow_alpha(3)
    state = [1, 1, 1]
    out = np.empty(FRAME_SYMBOLS, dtype=np.int64)
    for i in range(FRAME_SYMBOLS):
        out[i] = state[2]
        fb = int(gf.mul(state[2], alpha3)) ^ state[1]
        state = [fb, state[0], state[1]]
    return out


@functools.cache
def _framing_crc_matrix() -> np.ndarray:
    """GF(2) matrix [187*8, 8] for the transport-framing parity checksum
    that replaces the MPEG sync byte (poly x⁸+x⁷+x⁶+x⁴+x²+1)."""
    g = np.zeros(9, dtype=np.uint8)
    for p in (0, 2, 4, 6, 7, 8):
        g[p] = 1
    return gf2_poly_mod_matrix(g, 187 * 8)


def _fsync_bits() -> np.ndarray:
    w = np.zeros(FSYNC_BITS, dtype=np.uint8)
    for i in range(FSYNC_BITS):
        w[i] = (FSYNC_WORD >> (FSYNC_BITS - 1 - i)) & 1
    return w


@functools.cache
def rrc_taps(cfg: J83bConfig) -> np.ndarray:
    """GNU Radio firdes.root_raised_cosine(0.14, fs, fs/2, 0.18, 100)
    (qam-blade.py:59): RRC impulse response in float64, scaled so the taps
    sum to the gain, then cast to float32.  Read-only (cached)."""
    gain, ntaps, alpha = 0.14, cfg.rrc_ntaps, cfg.rrc_rolloff
    fs = float(cfg.sample_rate)
    sym = fs / 2.0
    spb = fs / sym                                   # samples per symbol = 2
    taps = np.zeros(ntaps)
    for i in range(ntaps):
        t = (i - ntaps / 2.0) / spb
        den = 1.0 - (4.0 * alpha * t) ** 2
        if abs(t) < 1e-12:
            taps[i] = 1.0 - alpha + 4.0 * alpha / np.pi
        elif abs(den) < 1e-9:
            taps[i] = (alpha / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * alpha))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * alpha)))
        else:
            taps[i] = (np.sin(np.pi * t * (1.0 - alpha))
                       + 4.0 * alpha * t * np.cos(np.pi * t * (1.0 + alpha))
                       ) / (np.pi * t * den)
    out = (gain * taps / np.sum(taps)).astype(np.float32)
    out.flags.writeable = False
    return out


# Per-device constants, uploaded once per device: without the cache every
# superblock would pay a host-to-device copy of each (the randomizer tile
# alone is 1.44 M int32).
_HOST_TABLES = {
    "crc": lambda: _framing_crc_matrix().astype(np.float32),
    "ext_sum": lambda: _ext_sum_matrix()[: 127 * 7].astype(np.float32),
    "randomizer": lambda: np.tile(_randomizer_frame(),
                                  FRAMES_PER_SUPERBLOCK).astype(np.int32),
    "fsync": lambda: np.tile(_fsync_bits(), (FRAMES_PER_SUPERBLOCK, 1)),
    "lut": lambda: CONSTELLATION_64_RAILS,
    "punct_keep": lambda: np.asarray(PUNCT_KEEP, dtype=np.int64),
}


@functools.cache
def _device_table(name: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(_HOST_TABLES[name]())).to(
        device)


@functools.cache
def _ilv_index(n: int, C: int, device: torch.device) -> torch.Tensor:
    """Gather index [n] into carry ++ symbols for the interleaver shear:
    out[r*I + b] = ext[(r + C/I - J*b)*I + b]."""
    r = np.arange(n // ILV_I, dtype=np.int64)[:, None]
    b = np.arange(ILV_I, dtype=np.int64)[None, :]
    idx = (r + C // ILV_I - ILV_J * b) * ILV_I + b
    return torch.from_numpy(idx.reshape(-1)).to(device)


# ---------------------------------------------------------------------------
# Stream state
# ---------------------------------------------------------------------------

@dataclass
class J83bState:
    ilv_carry: torch.Tensor    # int32 [(I-1)*I*J] interleaver tail symbols
    conv_a: torch.Tensor       # uint8 [4] encoder A memory (most recent first)
    conv_b: torch.Tensor       # uint8 [4] encoder B memory
    diff_state: torch.Tensor   # uint8 [2] differential precoder (W, Z)
    rrc_tail: torch.Tensor     # float32 [2, 49] filter history (rail-major)


_STATE_LAYOUT = {
    "ilv_carry": (((ILV_I - 1) * ILV_I * ILV_J,), torch.int32),
    "conv_a": ((4,), torch.uint8),
    "conv_b": ((4,), torch.uint8),
    "diff_state": ((2,), torch.uint8),
    "rrc_tail": ((2, HIST), torch.float32),
}


def init_state(cfg: J83bConfig | None = None, *,
               device: str | torch.device) -> J83bState:
    dev = resolve_device(device)
    return J83bState(**{name: torch.zeros(shape, dtype=dtype, device=dev)
                        for name, (shape, dtype) in _STATE_LAYOUT.items()})


def state_from_numpy(d: Mapping[str, np.ndarray], *,
                     device: str | torch.device) -> J83bState:
    """Build the port's state from host arrays, one per field — e.g.
    ``{f: np.asarray(getattr(jax_state, f)) for f in fields}`` of the
    reference's ``J83bState`` — so a stream can change hands mid-way.
    Shapes and dtypes must match exactly."""
    dev = resolve_device(device)
    out = {}
    for name, (shape, dtype) in _STATE_LAYOUT.items():
        t = torch.from_numpy(np.array(d[name]))
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"state field {name}: need {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        out[name] = t.to(dev)
    return J83bState(**out)


def state_to_numpy(s: J83bState) -> dict[str, np.ndarray]:
    """Host copies of every state field, keyed by field name."""
    return {f.name: getattr(s, f.name).cpu().numpy() for f in fields(s)}


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def transport_framing(ts: torch.Tensor) -> torch.Tensor:
    """[n_pkt, 188] uint8 → same, sync byte replaced by parity checksum."""
    payload = ts[:, 1:]
    crc_bits = gf2_matmul(bitops.bytes_to_bits(payload),
                          _device_table("crc", ts.device))
    crc = bitops.bits_to_bytes(crc_bits)             # [n_pkt, 1]
    return torch.cat([crc, payload], dim=1)


def rs_encode(symbols7: torch.Tensor) -> torch.Tensor:
    """[n_blocks, 122] int32 7-bit symbols → [n_blocks, 128] codewords."""
    msg_bits = bitops.words_to_bits(symbols7, 7)
    par_bits = _rs().parity_bits(msg_bits)           # [n, 5*7]
    cw126_bits = torch.cat([msg_bits, par_bits], dim=-1)
    ext_bits = gf2_matmul(cw126_bits,
                          _device_table("ext_sum", symbols7.device))
    cw_bits = torch.cat([cw126_bits, ext_bits], dim=-1)
    return bitops.bits_to_words(cw_bits, 7)


def interleave(symbols: torch.Tensor, carry: torch.Tensor,
               blocks: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Forney (I=128, J=4) over 7-bit symbols: out[k]=in[k - (k%I)*I*J].

    With ext = carry ++ symbols viewed [*, I], the output is the column
    shear out2d[r, b] = ext2d[r + C/I - J*b, b] (C = carry length), done as
    one gather with an index cached per (n, C, device) for a block of n
    symbols.  ``symbols`` holds ``blocks`` such blocks; block l gathers at
    the same index from the window ext[l*n : l*n + C + n], the windows
    being one overlapping view.  Every branch start C/I - J*b must be
    >= 0: a negative index would silently wrap to the end of ext, so both
    conditions are checked."""
    n = symbols.shape[0] // blocks
    C = carry.shape[0]
    if n * blocks != symbols.shape[0] or n % ILV_I \
            or C % (ILV_I * ILV_J):
        raise ValueError(f"need {blocks} blocks of n % {ILV_I} == 0 and "
                         f"C % {ILV_I * ILV_J} == 0, got "
                         f"{symbols.shape[0]} symbols, C={C}")
    if C // ILV_I < ILV_J * (ILV_I - 1):
        raise ValueError(f"carry of {C} symbols is shorter than the "
                         f"{ILV_I * ILV_J * (ILV_I - 1)} the deepest branch "
                         "reaches back")
    ext = torch.cat([carry, symbols])
    out = ext.unfold(0, C + n, n)[:, _ilv_index(n, C, ext.device)]
    return out.reshape(-1), ext[-C:].clone()


def conv_encode_45(bits: torch.Tensor,
                   state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rate-4/5 punctured binary conv code over one substream.

    bits: uint8 [n] (n % 4 == 0) → kept output bits [n//4*5], new state.
    """
    n = bits.shape[0]
    ext = torch.cat([torch.flip(state, (0,)).to(torch.uint8), bits])
    x = torch.zeros(n, dtype=torch.uint8, device=bits.device)
    y = torch.zeros(n, dtype=torch.uint8, device=bits.device)
    for j in G1_TAPS:
        x = x ^ ext[4 - j: 4 - j + n]
    for j in G2_TAPS:
        y = y ^ ext[4 - j: 4 - j + n]
    xy = torch.stack([x, y], dim=-1).reshape(-1, 8)  # per 4-step period
    out = xy.index_select(1, _device_table("punct_keep", bits.device))
    return out.reshape(-1), torch.flip(bits[-4:], (0,))


def trellis_encode(bits: torch.Tensor, conv_a: torch.Tensor,
                   conv_b: torch.Tensor, diff_state: torch.Tensor):
    """TCM: serial bits [n] (n % 28 == 0) → 6-bit symbol words int32
    [n//28*5], plus the new conv_a, conv_b and diff_state.

    28 bits split alternately into A (even positions) and B (odd); within
    each 14-bit substream the first 10 bits are uncoded (2 per symbol), the
    last 4 feed the rate-4/5 coder.  Word = [uA, uB, qGrayHi, cA, cB,
    qGrayLo] (MSB..LSB), as the reference pins it.
    """
    g = bits.reshape(-1, TRELLIS_GROUP_IN)
    n_grp = g.shape[0]
    a = g[:, 0::2]                                   # [n_grp, 14]
    b = g[:, 1::2]
    ua, ca_in = a[:, :10], a[:, 10:]
    ub, cb_in = b[:, :10], b[:, 10:]
    ca, conv_a = conv_encode_45(ca_in.reshape(-1), conv_a)
    cb, conv_b = conv_encode_45(cb_in.reshape(-1), conv_b)
    # uncoded bits per symbol: A gives (w, u) and B gives (z, v)
    ua = ua.reshape(n_grp, 5, 2)
    ub = ub.reshape(n_grp, 5, 2)
    w, u = ua[..., 0].reshape(-1), ua[..., 1].reshape(-1)
    z, v = ub[..., 0].reshape(-1), ub[..., 1].reshape(-1)
    # 90°-invariance differential precoder: the Gray-coded quadrant (w, z)
    # is a running sum of increments mod 4 — a cumsum (int32 stated: torch
    # would promote an int32 cumsum to int64).
    #   gray (w,z): 00→0, 01→1, 11→2, 10→3
    q_in = (w.to(torch.int32) << 1) | (w ^ z).to(torch.int32)
    d = diff_state.to(torch.int32)
    q0 = (d[0] << 1) | (d[0] ^ d[1])
    q_out = (torch.cumsum(q_in, 0, dtype=torch.int32) + q0) & 3
    W = (q_out >> 1).to(torch.uint8)                  # Gray hi → b3
    Z = W ^ (q_out & 1).to(torch.uint8)               # Gray lo → b0
    new_diff = torch.stack([W[-1], Z[-1]])
    words = ((u.to(torch.int32) << 5) | (v.to(torch.int32) << 4)
             | (W.to(torch.int32) << 3)
             | (ca.to(torch.int32) << 2)
             | (cb.to(torch.int32) << 1)
             | Z.to(torch.int32))
    return words, conv_a, conv_b, new_diff


def rrc_interpolate(cells: torch.Tensor, tail: torch.Tensor,
                    taps: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """Interpolate-by-2 polyphase RRC: rail-major IQ [2, n] → [2, 2n] +
    history [2, 49].  The FIR runs on the device of ``cells``: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor.  The
    kernel reads ``tail`` and ``cells`` where they lie (the reference
    concatenates them first); the new history is the last 49 samples of
    tail ++ cells, copied so that it does not keep ``cells`` alive."""
    n = cells.shape[1]
    out = polyphase_interp2_split(tail, cells, taps)     # [2, 2n]
    if n >= HIST:
        return out, cells[:, n - HIST:].clone()
    return out, torch.cat([tail[:, n:], cells], dim=1)


# ---------------------------------------------------------------------------
# Chain
# ---------------------------------------------------------------------------

def encode_to_cells(cfg: J83bConfig, ts: torch.Tensor,
                    state: J83bState) -> tuple[torch.Tensor, J83bState]:
    """Stages framing … 64-QAM map: ts uint8 [L*6405*188] of L
    superblocks → rail-major IQ cells float32 [2, L*1,806,210] + the state
    after the last (rrc_tail unchanged here)."""
    del cfg
    dev = ts.device
    if ts.dim() != 1 or not ts.shape[0] or ts.shape[0] % SUPERBLOCK_BYTES:
        raise ValueError(f"need a 1-d multiple of {SUPERBLOCK_BYTES} TS "
                         f"bytes, got {tuple(ts.shape)}")
    n_sb = ts.shape[0] // SUPERBLOCK_BYTES
    framed = transport_framing(ts.reshape(-1, 188)).reshape(-1)

    # 7-bit symbolization (MSB-first across byte boundaries)
    bits = bitops.bytes_to_bits(framed)
    info_syms = bitops.bits_to_words(bits.reshape(-1, 7), 7).reshape(-1)

    # RS(128,122) extended
    cw = rs_encode(info_syms.reshape(-1, RS_K)).reshape(-1)

    # convolutional interleaver over symbols
    inter, ilv_carry = interleave(cw, state.ilv_carry, n_sb)

    # randomizer (GF add = XOR), identical sequence every frame
    randomized = inter.reshape(n_sb, -1) ^ _device_table("randomizer", dev)

    # frame sync insertion: per frame, 53760 payload bits + 42 sync bits
    pay_bits = bitops.words_to_bits(
        randomized.reshape(n_sb, FRAMES_PER_SUPERBLOCK, FRAME_SYMBOLS), 7)
    fsync = _device_table("fsync", dev).expand(n_sb, -1, -1)
    frame_bits = torch.cat([pay_bits, fsync], dim=2).reshape(-1)

    # trellis-coded modulation → 6-bit words → constellation
    words, conv_a, conv_b, diff = trellis_encode(
        frame_bits, state.conv_a, state.conv_b, state.diff_state)
    cells = _device_table("lut", dev).index_select(1, words)
    return cells, J83bState(ilv_carry=ilv_carry, conv_a=conv_a,
                            conv_b=conv_b, diff_state=diff,
                            rrc_tail=state.rrc_tail)


def modulate_superblock(cfg: J83bConfig, ts: torch.Tensor,
                        state: J83bState) -> tuple[torch.Tensor, J83bState]:
    """188 FEC frames per superblock: ts uint8 [L*6405*188] of L
    superblocks → rail-major IQ float32 [2, L*3,612,420] in one FIR launch
    (``cplx.rails_to_np`` converts to host complex64)."""
    cells, state = encode_to_cells(cfg, ts, state)
    iq, rrc_tail = rrc_interpolate(cells, state.rrc_tail, rrc_taps(cfg))
    return iq, J83bState(ilv_carry=state.ilv_carry, conv_a=state.conv_a,
                         conv_b=state.conv_b, diff_state=state.diff_state,
                         rrc_tail=rrc_tail)


@functools.cache
def _jit_modulator(cfg: J83bConfig, device: torch.device) -> Jit:
    return Jit(functools.partial(modulate_superblock, cfg), device=device)


def jit_modulator(cfg: J83bConfig, *, device: str | torch.device = "cuda"
                  ) -> Jit:
    """``fn(ts, state) -> (iq, state)``: ``modulate_superblock`` as one
    captured CUDA graph per input length on ``device``, the FIR kernel
    launched inside it (``utils/graph``; eager through the same static
    buffers on the CPU), the counterpart of the reference's
    ``jit_modulator``.  The results are the caller's."""
    return _jit_modulator(cfg, resolve_device(device))


@span("dtv.tx.stream")
def modulate_stream(cfg: J83bConfig, ts: np.ndarray,
                    state: J83bState | None = None, *,
                    device: str | torch.device):
    """Modulate whole superblocks of host TS bytes on ``device``, one
    ``jit_modulator`` call each; returns host complex64 IQ and the final
    state (on ``device``)."""
    dev = resolve_device(device)
    blk = SUPERBLOCK_BYTES
    if len(ts) % blk:
        raise ValueError(f"need a multiple of {blk} TS bytes, got {len(ts)}")
    if state is None:
        state = init_state(cfg, device=dev)
    elif state.ilv_carry.device != dev:
        raise ValueError(f"state lives on {state.ilv_carry.device}, "
                         f"not on {dev}")
    host = torch.from_numpy(np.ascontiguousarray(ts, dtype=np.uint8))
    fn = jit_modulator(cfg, device=dev)
    out = []
    for i in range(len(ts) // blk):
        with span("dtv.stream.copy_in"):
            block = host[i * blk:(i + 1) * blk].to(dev)
        iq, state = fn(block, state)
        wait(dev)
        with span("dtv.stream.copy_out"):
            out.append(cplx.rails_to_np(iq))
    with span("dtv.stream.host"):
        out = np.concatenate(out) if out else np.empty(0, np.complex64)
    return out, state
