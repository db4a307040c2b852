"""DVB-T modulator (EN 300 744) in PyTorch.

Port of ``dtv_utils_tpu/tx/dvbt.py``, stage for stage and bit for bit up to
the carrier grid: energy dispersal → RS(204,188) → Forney outer interleaver
(I=12, M=17) → K=7 punctured convolutional coder → bit / symbol inner
interleavers → QAM map → pilots/TPS → unnormalized IFFT → cyclic prefix →
×0.0022097087, over one or more consecutive superframes (272 OFDM symbols
each) per call.

The chain runs eagerly on the device of its input, with no host sync.  The
dispersal is an XOR with a mask row picked on the device, the interleavers
are cached gathers, and the inner coder, puncturing, demux and bit
interleaver compose to one GF(2) generator-matrix product
(``core/galois.gf2_matmul``, float32: exact for 0/1 inputs, TF32 or not).
Cells are complex64: ``torch.view_as_real`` of the carrier grid has the
same bytes as the reference's float32 ``[272, K, 2]``.  The IFFT is
``ops/cfft`` (cuFFT on the card).  Host tables are NumPy copies of the
reference's ``_plan``, uploaded once per device.

Every state coupling of the chain (the dispersal phase, the Forney carry,
the coder memory) is continuous across superframe boundaries, so a call on
L consecutive superframes runs each stage once over the L superframes as one
stream, with the same launches as a call on one: one superframe is the
L = 1 case of the same code.  The tables that grow with L (the dispersal
rows, the Forney index) are cached per length.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from dtv_utils_torch.core import bits as bitops
from dtv_utils_torch.core.config import DvbtConfig
from dtv_utils_torch.core.galois import gf2_matmul
from dtv_utils_torch.core.prbs import dvbt_dispersal_mask
from dtv_utils_torch.ops import cfft
from dtv_utils_torch.ops.convcode import G1_TAPS, G2_TAPS, PUNCTURE_PATTERNS
from dtv_utils_torch.ops.interleave import (forney_carry_len,
                                            forney_gather_indices,
                                            forney_interleave)
from dtv_utils_torch.ops.rs import DVBT_RS
from dtv_utils_torch.tx import dvbt_tables as T
from dtv_utils_torch.utils.device import resolve_device
from dtv_utils_torch.utils.graph import Jit

OUTPUT_SCALE = 0.0022097087      # the reference's output scale, every mode
OUTER_I, OUTER_M = 12, 17        # Forney outer interleaver


# ---------------------------------------------------------------------------
# Stream state
# ---------------------------------------------------------------------------

@dataclass
class DvbtState:
    """Carry-state between consecutive superframes."""
    packet_phase: torch.Tensor  # int32 0-d: packets into the 8-pkt PRBS group
    outer_carry: torch.Tensor   # uint8 [2244]: Forney interleaver tail
    conv_state: torch.Tensor    # uint8 [6]: last 6 interleaved-stream bits


_STATE_LAYOUT = {
    "packet_phase": ((), torch.int32),
    "outer_carry": ((forney_carry_len(OUTER_I, OUTER_M),), torch.uint8),
    "conv_state": ((6,), torch.uint8),
}


def init_state(cfg: DvbtConfig | None = None, *,
               device: str | torch.device) -> DvbtState:
    dev = resolve_device(device)
    return DvbtState(**{name: torch.zeros(shape, dtype=dtype, device=dev)
                        for name, (shape, dtype) in _STATE_LAYOUT.items()})


def state_from_numpy(d: Mapping[str, np.ndarray], *,
                     device: str | torch.device) -> DvbtState:
    """Build the port's state from host arrays, one per field — e.g. the
    fields of the reference's ``DvbtState`` as NumPy arrays — so a stream
    can change hands mid-way.  Shapes and dtypes must match exactly."""
    dev = resolve_device(device)
    out = {}
    for name, (shape, dtype) in _STATE_LAYOUT.items():
        t = torch.from_numpy(np.array(d[name]))
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"state field {name}: need {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        out[name] = t.to(dev)
    return DvbtState(**out)


def state_to_numpy(s: DvbtState) -> dict[str, np.ndarray]:
    """Host copies of every state field, keyed by field name."""
    return {f.name: getattr(s, f.name).cpu().numpy() for f in fields(s)}


# ---------------------------------------------------------------------------
# Static tables
# ---------------------------------------------------------------------------

@functools.cache
def _plan(cfg: DvbtConfig) -> dict:
    """All static tables for one config (host NumPy, cached): a copy of the
    reference's ``_plan``, same keys, shapes and dtypes."""
    v = cfg.constellation.bits_per_symbol
    # dispersal mask for every possible packet phase (8 rows)
    masks = dispersal_rows(cfg.rs_blocks_per_superframe,
                           torch.device("cpu")).numpy().copy()
    # puncture: per-period column selector (serial order: X_i then Y_i)
    xp, yp = PUNCTURE_PATTERNS[cfg.code_rate.value]
    keep_cols = []
    for i in range(len(xp)):
        if xp[i]:
            keep_cols.append(2 * i)
        if yp[i]:
            keep_cols.append(2 * i + 1)
    even_idx, odd_idx = T.symbol_interleaver_gather(cfg.mode)
    lut = np.stack([T.constellation_lut(cfg.constellation).real,
                    T.constellation_lut(cfg.constellation).imag],
                   axis=-1).astype(np.float32)
    plan_c = T.carrier_plan(cfg)
    demux_pos = np.argsort(np.asarray(T.DEMUX[v]))

    # ---- inner coding as ONE generator-matrix product -------------------
    # Conv-encode + puncture + demux + bit-interleaver roll compose to a
    # GF(2)-linear, periodic map from input bits to cell bit-planes: over a
    # period of P cells, cells = (window @ B) mod 2 for a small binary B.
    # P = lcm(126, K/gcd(v,K)).
    per = len(xp)
    n_keep = len(keep_cols)
    g = int(np.gcd(v, n_keep))
    R = n_keep // g
    n_cells = cfg.cells_per_superframe
    P = int(np.lcm(T.BIT_ILV_BLOCK, R))
    assert n_cells % P == 0 and (v * P) % n_keep == 0, (n_cells, P)
    S_bits = per * (v * P // n_keep)
    max_c = 0
    entries = []     # (c, column) pairs with column = u*v + e
    for u in range(P):
        blk_base = (u // T.BIT_ILV_BLOCK) * T.BIT_ILV_BLOCK
        for e in range(v):
            # H_e roll baked in: plane e of cell u reads demuxed stream cell
            u2 = blk_base + ((u % T.BIT_ILV_BLOCK) + T.BIT_ILV_OFFSETS[e]) \
                % T.BIT_ILV_BLOCK
            s0 = v * u2 + int(demux_pos[e])
            col = keep_cols[s0 % n_keep]
            step, which = col // 2, col % 2
            base_bit = per * (s0 // n_keep) + step
            taps = G1_TAPS if which == 0 else G2_TAPS
            for j in taps:
                c = 6 + base_bit - j
                max_c = max(max_c, c)
                entries.append((c, u * v + e))
    W = max_c + 1
    assert W - S_bits < S_bits   # window overlap fits one extra row
    B = np.zeros((W, P * v), dtype=np.int8)
    for c, colm in entries:
        B[c, colm] ^= 1

    # ---- composed symbol-interleave + pilot/TPS gather ------------------
    # carriers[l, k] = lut[words[l, comp_idx[l%4, k]]] on data positions,
    # else static_vals[l, k].
    n_data = plan_c.n_data
    comp_idx = np.zeros((4, cfg.mode.carriers), dtype=np.int32)
    data_mask = np.zeros((4, cfg.mode.carriers), dtype=bool)
    perms = (even_idx, odd_idx)
    for ph in range(4):
        gi = plan_c.gidx[ph]
        m = gi < n_data
        data_mask[ph] = m
        comp_idx[ph][m] = perms[ph % 2][gi[m]]
    static_vals = np.zeros(
        (cfg.symbols_per_superframe, cfg.mode.carriers, 2), np.float32)
    for l in range(cfg.symbols_per_superframe):
        ph = l % 4
        sv = plan_c.static_cells[l][plan_c.gidx[ph][~data_mask[ph]] - n_data]
        static_vals[l][~data_mask[ph], 0] = sv.real
        static_vals[l][~data_mask[ph], 1] = sv.imag

    return dict(masks=masks, gen_B=B, gen_P=P, gen_S=S_bits, gen_W=W,
                lut=lut, comp_idx=comp_idx, data_mask=data_mask,
                static_vals=static_vals)


@functools.cache
def _device_plan(cfg: DvbtConfig, device: torch.device) -> dict:
    """``_plan`` on ``device``, in the dtypes the chain consumes; uploaded
    once per (config, device)."""
    p = _plan(cfg)
    n_sym = cfg.symbols_per_superframe

    def up(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    mask_sym = np.tile(p["data_mask"], (n_sym // 4, 1))      # [272, K]
    return dict(
        gen_B=up(p["gen_B"], torch.float32),
        lut=torch.view_as_complex(up(p["lut"])),              # complex64 [2^v]
        comp_idx=up(p["comp_idx"], torch.int64),              # [4, K]
        data_mask=up(mask_sym),                               # bool [272, K]
        static_vals=torch.view_as_complex(up(p["static_vals"])),
    )


@functools.lru_cache(maxsize=8)
def dispersal_rows(n_pkt: int, device: torch.device) -> torch.Tensor:
    """uint8 [8, n_pkt*188]: row ph is the dispersal mask of ``n_pkt``
    packets that start at packet phase ph (``_plan``'s ``masks`` at one
    superframe).  The rows are overlapping views of one tiled mask, so the
    table costs ``n_pkt*188 + 7*188`` bytes per length and device; the
    cache keeps the last 8 (length, device) pairs."""
    mask, _ = dvbt_dispersal_mask()
    total = n_pkt * 188
    base = np.tile(mask, (total + 7 * 188) // len(mask) + 1)
    base = torch.from_numpy(base[:total + 7 * 188]).to(device)
    return base.as_strided((8, total), (188, 1))


@functools.cache
def _forney_index(cfg: DvbtConfig, device: torch.device) -> torch.Tensor:
    """The outer interleaver's gather index of one superframe; a call on L
    superframes reuses it for each (``forney_interleave``)."""
    return torch.from_numpy(forney_gather_indices(
        OUTER_I, OUTER_M, cfg.rs_blocks_per_superframe * 204)).to(device)


# ---------------------------------------------------------------------------
# Chain
# ---------------------------------------------------------------------------

def _check_superframes(cfg: DvbtConfig, ts: torch.Tensor) -> None:
    blk = cfg.ts_bytes_per_superframe
    if ts.dim() != 1 or not ts.shape[0] or ts.shape[0] % blk:
        raise ValueError(f"need a 1-d multiple of {blk} TS bytes, got "
                         f"{tuple(ts.shape)}")


def disperse(cfg: DvbtConfig, ts: torch.Tensor,
             packet_phase: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1, energy dispersal over whole packets: XOR with the mask row
    of the current packet phase, selected on the device (no host sync).
    Returns the dispersed bytes and the next phase (int32 0-d)."""
    del cfg
    n_pkt = ts.shape[0] // 188
    rows = dispersal_rows(n_pkt, ts.device)
    row = rows.index_select(0, (packet_phase % 8).reshape(1))
    return ts ^ row[0], (packet_phase + n_pkt % 8) % 8


def outer_interleave(cfg: DvbtConfig, coded: torch.Tensor,
                     carry: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 3, the Forney outer interleaver: one gather from
    carry ++ block, over any whole number of superframes.  Every branch
    start C/12 - 17b must be >= 0, so the carry must reach back I*M*(I-1)
    bytes."""
    C = carry.shape[0]
    if C // OUTER_I < OUTER_M * (OUTER_I - 1):
        raise ValueError(f"outer carry of {C} bytes is shorter than the "
                         f"{OUTER_I * OUTER_M * (OUTER_I - 1)} the deepest "
                         "branch reaches back")
    return forney_interleave(coded, carry, _forney_index(cfg, coded.device))


def inner_code(cfg: DvbtConfig, outer: torch.Tensor,
               conv_state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stages 4+5, conv coder + puncture + demux + bit interleave as ONE
    GF(2) product: cell bit-planes = (windows @ B) & 1, with windows the
    bit stream viewed as overlapping [M, W] rows (a zero pad and two
    reshapes).  ``outer`` holds whole superframes.  Returns cell words
    int32 [n_cells] (bit-plane 0 = MSB) and the next coder state."""
    pg = _plan(cfg)
    dbits = bitops.bytes_to_bits(outer)
    new_conv_state = torch.flip(dbits[-6:], (0,))       # most recent first
    P, S, W = pg["gen_P"], pg["gen_S"], pg["gen_W"]
    M = dbits.shape[0] // S                               # periods of P cells
    d_ext = torch.cat([torch.flip(conv_state, (0,)), dbits]).to(torch.float32)
    A = F.pad(d_ext, (0, S * (M + 1) - d_ext.shape[0]))
    head = A[:S * M].reshape(M, S)
    tail = A[S:S * (M + 1)].reshape(M, S)[:, :W - S]
    windows = torch.cat([head, tail], dim=1)            # [M, W] float32
    planes = gf2_matmul(windows,
                        _device_plan(cfg, outer.device)["gen_B"])
    words = bitops.bits_to_words(planes, cfg.constellation.bits_per_symbol)
    return words.reshape(-1), new_conv_state


def assemble_carriers(cfg: DvbtConfig, words: torch.Tensor) -> torch.Tensor:
    """Stages 6-8, symbol interleave + QAM map + pilots/TPS: one gather per
    pilot phase, the LUT, then the static pilot/TPS values where no data
    goes (272 = 68·4 symbols, so the pilot phase and the TPS rows repeat
    per superframe).  words int32 [L*n_cells] → carriers complex64
    [L*272, K]."""
    p = _device_plan(cfg, words.device)
    n_sym = cfg.symbols_per_superframe
    K = cfg.mode.carriers
    words4 = words.reshape(-1, 4, cfg.mode.data_carriers)
    idx = p["comp_idx"].expand(words4.shape[0], -1, -1)  # [L*n_sym/4, 4, K]
    gathered = torch.gather(words4, 2, idx)              # int32
    data_part = p["lut"].index_select(0, gathered.reshape(-1)).reshape(
        -1, n_sym, K)                                   # complex64 [L, 272, K]
    return torch.where(p["data_mask"], data_part,
                       p["static_vals"]).reshape(-1, K)


def encode_to_carriers(cfg: DvbtConfig, ts: torch.Tensor,
                       state: DvbtState) -> tuple[torch.Tensor, DvbtState]:
    """Stages 1-8 (dispersal … pilot/TPS assembly): ts uint8
    [L * ts_bytes_per_superframe], L consecutive superframes → carrier grid
    complex64 [L*272, K] + the state after the last, all on ``ts.device``."""
    _check_superframes(cfg, ts)
    dispersed, phase = disperse(cfg, ts, state.packet_phase)
    coded = DVBT_RS().encode_bytes(dispersed.reshape(-1, 188)).reshape(-1)
    outer, outer_carry = outer_interleave(cfg, coded, state.outer_carry)
    words, conv_state = inner_code(cfg, outer, state.conv_state)
    return assemble_carriers(cfg, words), DvbtState(
        packet_phase=phase, outer_carry=outer_carry, conv_state=conv_state)


def carriers_to_iq(cfg: DvbtConfig, carriers: torch.Tensor) -> torch.Tensor:
    """Stages 9-10: carrier grid complex64 [n_sym, K] → IQ complex64
    [n_sym * (fft + guard)]: centre, ifftshift, unnormalized IFFT, cyclic
    prefix, ×OUTPUT_SCALE."""
    fft = cfg.fft_size
    gi = cfg.guard_samples
    K = cfg.mode.carriers
    n_sym = carriers.shape[0]
    # zeros_on_left = ceil((fft-K)/2), as gr-dtv lays the carriers out
    left = (fft - K + 1) // 2
    spec = torch.zeros((n_sym, fft), dtype=torch.complex64,
                       device=carriers.device)
    spec[:, left:left + K] = carriers
    time = cfft.ifft_unnormalized(cfft.ifftshift(spec))
    sym_out = torch.cat([time[:, fft - gi:], time], dim=1)
    return (sym_out * OUTPUT_SCALE).reshape(-1)


def modulate_superframe(cfg: DvbtConfig, ts: torch.Tensor,
                        state: DvbtState) -> tuple[torch.Tensor, DvbtState]:
    """One superframe, or L consecutive ones: ts uint8
    [L * ts_bytes_per_superframe] → IQ complex64 [L * 272 * (fft + guard)]
    on ``ts.device``, plus the stream state after the last."""
    carriers, new_state = encode_to_carriers(cfg, ts, state)
    return carriers_to_iq(cfg, carriers), new_state


@functools.cache
def _jit_modulator(cfg: DvbtConfig, device: torch.device) -> Jit:
    return Jit(functools.partial(modulate_superframe, cfg), device=device)


def jit_modulator(cfg: DvbtConfig, *, device: str | torch.device = "cuda"
                  ) -> Jit:
    """``fn(ts, state) -> (iq, state)``: ``modulate_superframe`` as one
    captured CUDA graph per input length on ``device`` (``utils/graph``;
    eager through the same static buffers on the CPU), the counterpart of
    the reference's ``jit_modulator``.  The results are the caller's."""
    return _jit_modulator(cfg, resolve_device(device))


def modulate_stream(cfg: DvbtConfig, ts: np.ndarray,
                    state: DvbtState | None = None, *,
                    device: str | torch.device
                    ) -> tuple[np.ndarray, DvbtState]:
    """Modulate whole superframes of host TS bytes on ``device``, one
    ``jit_modulator`` call each; returns host complex64 IQ and the final
    state (on ``device``)."""
    dev = resolve_device(device)
    blk = cfg.ts_bytes_per_superframe
    if len(ts) % blk:
        raise ValueError(f"need a multiple of {blk} TS bytes, got {len(ts)}")
    if state is None:
        state = init_state(cfg, device=dev)
    elif state.outer_carry.device != dev:
        raise ValueError(f"state lives on {state.outer_carry.device}, "
                         f"not on {dev}")
    host = torch.from_numpy(np.ascontiguousarray(ts, dtype=np.uint8))
    fn = jit_modulator(cfg, device=dev)
    out = []
    for i in range(len(ts) // blk):
        iq, state = fn(host[i * blk:(i + 1) * blk].to(dev), state)
        out.append(iq.cpu().numpy())
    return (np.concatenate(out) if out else np.empty(0, np.complex64)), state
