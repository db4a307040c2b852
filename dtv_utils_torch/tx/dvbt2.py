"""DVB-T2 modulator (EN 302 755) in PyTorch.

Port of ``dtv_utils_tpu/tx/dvbt2.py``, stage for stage and bit for bit up
to the carrier grid, over one T2 frame per call: mode adaptation (sync-byte
CRC-8, BB headers) → BB scrambler → BCH → LDPC → bit interleaver + demux →
(rotated) QAM → cell and time interleavers → frame mapping (L1, dummy
cells, frequency interleaver, pilots) → unnormalized IFFT → [tone
reservation] → cyclic prefix → P1.  A call takes one frame or L
consecutive frames: the stream state (the packet phase and the CRC-8
window) is continuous across frames, so mode adaptation runs once over the
L frames' bytes, the FEC and mapping stages are row-wise over their
L·blocks FEC blocks, and the frame gather and the back end treat the L
frames as a batch: a call makes the launches of a one-frame call.

The chain runs eagerly on the device of its input, with no host sync: the
packet phase stays a 0-d tensor, and the offset it sets becomes a device
index (``first + arange``) that a gather reads with and ``index_copy``
writes with.  The GF(2) products (CRC-8, BCH, the LDPC accumulator's column
selector) are float32 products of 0/1 values, exact with or without TF32
(``core/galois.gf2_matmul``).  Cells and the grid are complex64:
``torch.view_as_real`` of them has the bytes of the reference's rail-major
float32 arrays with the rail axis moved last.  The IFFT is ``ops/cfft``
(cuFFT on the card).  Host tables are NumPy copies of the reference's
(``tx/dvbt2_tables.py``, ``_plan``, ``_l1_plan``, ``_frame_arrays``,
``_tr_kernel``), uploaded once per device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np
import torch

from dtv_utils_torch.core import bits as bitops
from dtv_utils_torch.core.config import (Dvbt2Config, T2Constellation,
                                         T2FrameSize)
from dtv_utils_torch.core.galois import gf2_matmul, gf2_poly_mod_matrix
from dtv_utils_torch.core.prbs import bb_scrambler_bits
from dtv_utils_torch.ops import cfft
from dtv_utils_torch.tx import dvbt2_tables as T
from dtv_utils_torch.tx import t2_p1
from dtv_utils_torch.utils.device import resolve_device
from dtv_utils_torch.utils.graph import Jit
from dtv_utils_torch.utils.trace import span, wait

# DVB CRC-8 (EN 302 755 §5.1.4): x^8+x^7+x^6+x^4+x^2+1
_CRC8_POLY = np.array([1, 0, 1, 0, 1, 0, 1, 1, 1], dtype=np.uint8)

OUTPUT_SCALE = 0.2          # dvbt2-blade.py:132 final multiply_const
PAPR_VCLIP = 3.3            # dvbt2-blade.py:53
PAPR_ITERATIONS = 3         # dvbt2-blade.py:54


# ---------------------------------------------------------------------------
# Stream state
# ---------------------------------------------------------------------------

@dataclass
class Dvbt2State:
    """Carry-state between consecutive T2 frames."""
    packet_phase: torch.Tensor   # int32 0-d: bytes into the current packet
    prev_tail: torch.Tensor      # uint8 [187]: last raw bytes (CRC window)


_STATE_LAYOUT = {
    "packet_phase": ((), torch.int32),
    "prev_tail": ((187,), torch.uint8),
}


def init_state(cfg: Dvbt2Config | None = None, *,
               device: str | torch.device) -> Dvbt2State:
    dev = resolve_device(device)
    return Dvbt2State(**{name: torch.zeros(shape, dtype=dtype, device=dev)
                         for name, (shape, dtype) in _STATE_LAYOUT.items()})


def state_from_numpy(d: Mapping[str, np.ndarray], *,
                     device: str | torch.device) -> Dvbt2State:
    """Build the port's state from host arrays, one per field — e.g. the
    fields of the reference's ``Dvbt2State`` as NumPy arrays — so a stream
    can change hands mid-way.  Shapes and dtypes must match exactly."""
    dev = resolve_device(device)
    out = {}
    for name, (shape, dtype) in _STATE_LAYOUT.items():
        t = torch.from_numpy(np.array(d[name]))
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"state field {name}: need {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        out[name] = t.to(dev)
    return Dvbt2State(**out)


def state_to_numpy(s: Dvbt2State) -> dict[str, np.ndarray]:
    """Host copies of every state field, keyed by field name."""
    return {f.name: getattr(s, f.name).cpu().numpy() for f in fields(s)}


# ---------------------------------------------------------------------------
# Static tables
# ---------------------------------------------------------------------------

@functools.cache
def _plan(cfg: Dvbt2Config) -> dict:
    """All static FEC/mapping tables for one config (host NumPy, cached): a
    copy of the reference's ``_plan``, same keys, shapes and dtypes."""
    kbch = cfg.kbch
    dfl_bytes = (kbch - 80) // 8
    n_bytes = dfl_bytes * cfg.fec_blocks
    bch_m = T.bch_parity_matrix(cfg.frame_size, cfg.bch_t, kbch
                                ).astype(np.int8)
    crc8_m = gf2_poly_mod_matrix(_CRC8_POLY, 187 * 8).astype(np.int8)
    hdr_crc_m = gf2_poly_mod_matrix(_CRC8_POLY, 72).astype(np.int8)
    scramble = bb_scrambler_bits(kbch)
    # LDPC accumulator edges in the rotated quasi-cyclic basis: address
    # a = c + q*s of group g means parity[(s+m)%360, c] ^= info[g, m], so
    # edge e contributes the 360-slice of the doubled info starting at
    # base_e = g*720 + (360 - s) % 360 to parity column c_e.
    rows_ldpc = T.ldpc_accumulator_rows(cfg.code_rate.value, cfg.nldpc,
                                        cfg.nbch)
    q = cfg.ldpc_q
    ldpc_g, ldpc_s, ldpc_c = [], [], []
    for g, addrs in enumerate(rows_ldpc):
        for a in addrs:
            ldpc_g.append(g)
            ldpc_s.append(a // q)
            ldpc_c.append(a % q)
    E = len(ldpc_g)
    ldpc_base = [g * 720 + (360 - s) % 360
                 for g, s in zip(ldpc_g, ldpc_s)]
    ldpc_sel = np.zeros((E, q), dtype=np.int8)
    ldpc_sel[np.arange(E), ldpc_c] = 1
    bit_perm = T.bit_interleaver_perm(cfg)
    dperm = T.demux_perm(cfg)
    v = cfg.constellation.bits_per_symbol
    lut = T.constellation_pairs(cfg.constellation, cfg.rotation)
    ncells = cfg.cells_per_fec_block
    ci_base = T.cell_interleaver_perm(ncells)
    ci_shift = T.cell_interleaver_shifts(cfg.fec_blocks, ncells)
    # scatter semantics out[L_r(q)] = in[q]  ->  gather index inverse
    ci_gather = np.empty((cfg.fec_blocks, ncells), dtype=np.int32)
    qidx = np.arange(ncells)
    for r in range(cfg.fec_blocks):
        lr = (ci_base + ci_shift[r]) % ncells
        ci_gather[r, lr] = qidx
    # time interleaver: TI block sizes (§6.5; uneven split like gr-dtv)
    nti = max(cfg.ti_blocks, 1)
    base, extra = divmod(cfg.fec_blocks, nti)
    ti_sizes = [base + (1 if i < extra else 0) for i in range(nti)]
    pow2 = (1 << np.arange(v - 1, -1, -1)).astype(np.int32)
    return dict(n_bytes=n_bytes, dfl_bytes=dfl_bytes, bch_m=bch_m,
                crc8_m=crc8_m, hdr_crc_m=hdr_crc_m,
                scramble=scramble, ldpc_base=tuple(ldpc_base),
                ldpc_sel=ldpc_sel,
                bit_perm=bit_perm, dperm=dperm, lut=lut,
                ci_gather=ci_gather, ti_sizes=tuple(ti_sizes), pow2=pow2)


def _up(a: np.ndarray, device: torch.device,
        dtype: torch.dtype | None = None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)


@functools.cache
def _device_plan(cfg: Dvbt2Config, device: torch.device) -> dict:
    """``_plan`` on ``device``, in the forms the chain consumes; uploaded
    once per (config, device)."""
    p = _plan(cfg)
    # bit interleaver then demux, composed into one gather of the frame
    comp = np.arange(cfg.nldpc, dtype=np.int64)
    if p["bit_perm"] is not None:
        comp = p["bit_perm"].astype(np.int64)
    comp = comp.reshape(-1, len(p["dperm"]))[:, p["dperm"]].reshape(-1)
    ldpc_idx = (np.arange(360, dtype=np.int64)[:, None]
                + np.asarray(p["ldpc_base"], dtype=np.int64)[None, :])
    nb, nc = cfg.fec_blocks, cfg.cells_per_fec_block
    ci_flat = (np.arange(nb, dtype=np.int64)[:, None] * nc
               + p["ci_gather"]).reshape(-1)
    return dict(
        crc8_m=_up(p["crc8_m"], device, torch.float32),
        hdr_crc_m=_up(p["hdr_crc_m"], device, torch.float32),
        bch_m=_up(p["bch_m"], device, torch.float32),
        scramble=_up(p["scramble"], device),
        ldpc_idx=_up(ldpc_idx.reshape(-1), device),       # [360 * E]
        ldpc_sel=_up(p["ldpc_sel"], device, torch.float32),
        comp=_up(comp, device),
        lut=_up(p["lut"], device),                        # float32 [2^v, 2]
        ci_flat=_up(ci_flat, device),
    )


@functools.lru_cache(maxsize=4)
def _stream_plan(cfg: Dvbt2Config, n_frames: int, device: torch.device
                 ) -> dict:
    """The mode-adaptation tables of ``n_frames`` consecutive frames on
    ``device``: sync slots every 188 bytes, each one's 187-byte CRC window,
    each FEC block's first byte as a packet offset (mod 188, taken in
    int64 on the host, so no index wraps however long the call), and the
    BB headers' constant bytes (SYNCD, bytes 7-8, is set per call).  The
    tables grow with ``n_frames`` (35 MB at BBC, 4 frames), so the cache
    keeps the last 4 (config, length, device) triples."""
    n = n_frames * _plan(cfg)["n_bytes"]
    sync_off = np.arange(n // 188 + 1, dtype=np.int64) * 188
    blocks = np.arange(n_frames * cfg.fec_blocks, dtype=np.int64)
    dfl = cfg.kbch - 80
    hdr = np.zeros((len(blocks), 7), dtype=np.uint8)
    hdr[:] = [0xF0, 0, 1504 >> 8, 1504 & 0xFF, dfl >> 8, dfl & 0xFF,
              0x47]                       # MATYPE (TS, SIS, CCM), UPL, DFL
    return dict(
        sync_off=_up(sync_off, device),                   # int64 [n_sync]
        win_off=_up(sync_off[:, None] + np.arange(187), device),
        block_phase=_up(blocks * _plan(cfg)["dfl_bytes"] % 188, device,
                        torch.int32),
        hdr=_up(hdr, device))


def _n_frames(cfg: Dvbt2Config, ts: torch.Tensor) -> int:
    n = _plan(cfg)["n_bytes"]
    if ts.dim() != 1 or not ts.shape[0] or ts.shape[0] % n:
        raise ValueError(f"need a 1-d multiple of {n} TS bytes, got "
                         f"{tuple(ts.shape)}")
    return ts.shape[0] // n


# ---------------------------------------------------------------------------
# Payload chain
# ---------------------------------------------------------------------------

def _crc8_rows(dp: dict, rows_bytes: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 187] -> CRC-8 byte [...] via a GF(2) product."""
    crc_bits = gf2_matmul(bitops.bytes_to_bits(rows_bytes), dp["crc8_m"])
    return bitops.bits_to_bytes(crc_bits)[..., 0]


def mode_adapt(cfg: Dvbt2Config, ts: torch.Tensor, state: Dvbt2State
               ) -> tuple[torch.Tensor, Dvbt2State]:
    """TS bytes uint8 [L*n_bytes] of L consecutive frames -> BBFRAMEs
    uint8 [L*fec_blocks, kbch] bits (unscrambled) and the state after the
    last frame (EN 302 755 §5.1, TS, normal mode).

    The 0x47 sync byte of each packet becomes the CRC-8 of the previous
    packet's 187 bytes.  Sync positions are first + 188k with
    first = (188 - phase) % 188 a device scalar, so the CRC windows are one
    gather at first + [188k + j] and the replacement one ``index_copy``; a
    sync position past the frame is sent to a spare slot and cropped."""
    dp = _device_plan(cfg, ts.device)
    sp = _stream_plan(cfg, _n_frames(cfg, ts), ts.device)
    n = ts.shape[0]
    n_sync = sp["sync_off"].shape[0]
    phase = state.packet_phase
    first = (188 - phase) % 188
    # ext = prev_tail ++ ts: window k covers the 187 bytes before sync k
    ext = torch.cat([state.prev_tail, ts,
                     ts.new_zeros(n_sync * 188 - n)])
    crcs = _crc8_rows(dp, ext[first + sp["win_off"]])    # uint8 [n_sync]
    pos = first + sp["sync_off"]
    pos = torch.where(pos < n, pos, n)
    adapted = torch.cat([ts, ts.new_zeros(1)]).index_copy(0, pos, crcs)[:n]
    data_bits = bitops.bytes_to_bits(adapted).reshape(-1, cfg.kbch - 80)

    # BB headers: MATYPE, UPL, DFL, SYNC fixed; SYNCD from the packet phase
    # at each block's first byte; CRC-8 over the 72 bits
    phase_b = (phase + sp["block_phase"]) % 188
    syncd = ((188 - phase_b) % 188) * 8
    hdr = torch.cat([sp["hdr"],
                     torch.stack([syncd >> 8, syncd & 0xFF], 1)
                     .to(torch.uint8)], 1)
    hdr_bits = bitops.bytes_to_bits(hdr)                     # [blocks, 72]
    crc_bits = gf2_matmul(hdr_bits, dp["hdr_crc_m"])
    frames = torch.cat([hdr_bits, crc_bits, data_bits], 1)  # [blocks, kbch]
    return frames, Dvbt2State(packet_phase=(phase + n % 188) % 188,
                              prev_tail=ts[-187:])


def fec_encode(cfg: Dvbt2Config, bbframes: torch.Tensor) -> torch.Tensor:
    """BBFRAMEs uint8 [blocks, kbch] -> FECFRAMEs uint8 [blocks, nldpc]:
    BB scrambler, BCH (one GF(2) product), LDPC.

    The LDPC accumulator works in the rotated quasi-cyclic basis (see
    ``_plan``): every edge reads one 360-slice of the doubled info, one
    gather for all edges; a float32 [b, 360, E] x [E, q] product with the
    0/1 column selector sums the edges per parity bit (at most E, exact),
    and the IRA accumulator is a prefix sum taken mod 2."""
    dp = _device_plan(cfg, bbframes.device)
    scrambled = bbframes ^ dp["scramble"]
    info = torch.cat([scrambled, gf2_matmul(scrambled, dp["bch_m"])], 1)
    b = info.shape[0]
    info3 = info.reshape(b, -1, 360)
    ext = torch.cat([info3, info3], 2).reshape(b, -1)      # doubled groups
    contrib = ext.index_select(1, dp["ldpc_idx"]).reshape(b, 360, -1)
    pre = torch.matmul(contrib.to(torch.float32), dp["ldpc_sel"])
    pre = pre.reshape(b, -1).to(torch.int32)               # p = q·r + c
    parity = (torch.cumsum(pre, 1, dtype=torch.int32) & 1).to(torch.uint8)
    return torch.cat([info, parity], 1)


def interleave_and_map(cfg: Dvbt2Config, fecframes: torch.Tensor
                       ) -> torch.Tensor:
    """FECFRAMEs uint8 [blocks, nldpc] -> cells complex64 [blocks, ncells]:
    bit interleaver + demux (one gather), MSB-first words, the constellation
    LUT, and the rotated constellations' cyclic Q delay of one cell within
    the FEC block (§6.3.3)."""
    dp = _device_plan(cfg, fecframes.device)
    y = fecframes.index_select(1, dp["comp"])
    words = bitops.bits_to_words(y, cfg.constellation.bits_per_symbol)
    pairs = dp["lut"][words]                                # [b, nc, 2]
    if cfg.rotation:
        pairs = torch.stack([pairs[..., 0],
                             torch.roll(pairs[..., 1], 1, dims=1)], -1)
    return torch.view_as_complex(pairs)


def cell_time_interleave(cfg: Dvbt2Config, cells: torch.Tensor
                         ) -> torch.Tensor:
    """cells complex64 [blocks, ncells] -> interleaving-frame payload
    complex64 [blocks*ncells]: per-block cell interleaver, then the
    row-column time interleaver per TI block (§6.4-6.5).  The chain itself
    composes both into the frame gather (``build_frame_grid_fused``)."""
    dp = _device_plan(cfg, cells.device)
    nb, ncells = cells.shape
    assert ncells % 5 == 0
    nr = ncells // 5
    ci = cells.reshape(-1)[dp["ci_flat"]].reshape(nb, ncells)
    out, start = [], 0
    for size in _plan(cfg)["ti_sizes"]:
        # written column-wise [5*size, nr], read row-wise
        mem = ci[start:start + size].reshape(size * 5, nr)
        out.append(mem.T.reshape(-1))
        start += size
    return torch.cat(out)


def payload_cells(cfg: Dvbt2Config, ts: torch.Tensor, state: Dvbt2State
                  ) -> tuple[torch.Tensor, Dvbt2State]:
    """TS bytes -> time-interleaved PLP payload cells for one frame."""
    bb, state = mode_adapt(cfg, ts, state)
    fec = fec_encode(cfg, bb)
    return cell_time_interleave(cfg, interleave_and_map(cfg, fec)), state


# ---------------------------------------------------------------------------
# L1 signalling encoding (§7.3): shortened BCH + punctured short LDPC
# ---------------------------------------------------------------------------

@functools.cache
def _l1_plan(cfg: Dvbt2Config) -> dict:
    """Host-side: the encoded L1-pre cells and L1-post cells (static per
    config); a copy of the reference's ``_l1_plan``."""
    n_post, n_punc, eta = T.l1_sizes(cfg.l1_constellation, cfg.n_p2)

    def encode_short(info_bits: np.ndarray, kbch: int, nbch: int,
                     keep_parity: int) -> np.ndarray:
        """Shortened BCH(t=12, GF(2^14)) + stand-in LDPC + puncture."""
        ksig = len(info_bits)
        padded = np.concatenate(
            [info_bits, np.zeros(kbch - ksig, np.uint8)])
        m = T.bch_parity_matrix(T2FrameSize.SHORT, 12, kbch)
        bch_par = (padded @ m) & 1
        ldpc_info = np.concatenate([padded, bch_par.astype(np.uint8)])
        q = (16200 - nbch) // 360
        rows = T.ldpc_accumulator_rows(0 if nbch == T.L1PRE_NBCH else 1,
                                       16200, nbch)
        npar = 16200 - nbch
        p = np.zeros(npar, dtype=np.uint8)
        for g, addrs in enumerate(rows):
            mm = np.arange(360)
            bits = ldpc_info[g * 360 + mm]
            for a in addrs:
                np.bitwise_xor.at(p, (a + mm * q) % npar, bits)
        p = np.bitwise_xor.accumulate(p)
        # shortening: transmit info (no pad) + BCH parity + kept LDPC parity
        return np.concatenate([info_bits, bch_par.astype(np.uint8),
                               p[:keep_parity]])

    pre_info = T.l1_pre_bits(cfg)
    pre_tx = encode_short(pre_info, T.L1PRE_KBCH, T.L1PRE_NBCH,
                          T.L1PRE_CELLS - T.L1PRE_KSIG - 168)
    assert len(pre_tx) == T.L1PRE_CELLS
    # BPSK cells (pairs)
    pre_cells = np.stack([1.0 - 2.0 * pre_tx.astype(np.float32),
                          np.zeros(len(pre_tx), np.float32)], -1)

    post_info = T.l1_post_bits(cfg)
    keep = 9000 - n_punc
    post_tx = encode_short(post_info, T.L1POST_KBCH, T.L1POST_NBCH, keep)
    assert len(post_tx) == n_post, (len(post_tx), n_post)
    # demux + map like the data path at the L1 constellation
    lut_map = {0: None, 1: T2Constellation.QPSK, 2: T2Constellation.QAM16,
               3: T2Constellation.QAM64}
    if cfg.l1_constellation == 0:
        post_cells = np.stack([1.0 - 2.0 * post_tx.astype(np.float32),
                               np.zeros(len(post_tx), np.float32)], -1)
    else:
        c = lut_map[cfg.l1_constellation]
        v = c.bits_per_symbol
        lut = T.constellation_pairs(c, rotation=False)
        words = post_tx.reshape(-1, v) @ (1 << np.arange(v - 1, -1, -1))
        post_cells = lut[words]
    return dict(pre_cells=pre_cells.astype(np.float32),
                post_cells=post_cells.astype(np.float32),
                n_post=n_post, eta=eta)


# ---------------------------------------------------------------------------
# Frame building (§8.3): cells -> per-symbol carrier grid
# ---------------------------------------------------------------------------

@functools.cache
def _frame_arrays(cfg: Dvbt2Config) -> dict:
    """Host-side scatter/gather arrays for frame assembly: a copy of the
    reference's ``_frame_arrays``, same keys, shapes and dtypes."""
    fp = T.frame_plan(cfg)
    l1 = _l1_plan(cfg)
    p = _plan(cfg)
    K = cfg.carriers
    lf = cfg.frame_symbols
    cnts = fp["data_cnt"]
    total = int(cnts.sum())
    n_l1 = len(l1["pre_cells"]) + len(l1["post_cells"])
    ncells = cfg.cells_per_fec_block
    nb = cfg.fec_blocks
    n_payload = nb * ncells
    n_dummy = total - n_l1 - n_payload
    assert n_dummy >= 0, (total, n_l1, n_payload)
    # dummy cells: BB-PRBS bits BPSK-mapped (§8.3.6.3 behaviour)
    dummy_bits = bb_scrambler_bits(max(n_dummy, 1))[:n_dummy]
    dummy = np.stack([1.0 - 2.0 * dummy_bits.astype(np.float32),
                      np.zeros(n_dummy, np.float32)], -1)
    # Compose (stream split → frequency interleave → data-carrier scatter)
    # into ONE static gather: grid[l, k] = stream[src[l, k]] on data
    # carriers, pilot/zero otherwise.  out[h[j]] = in[j] means the data
    # carrier holding data-cell i reads stream[start_l + hinv[i]].
    h_even, h_odd = T.freq_interleaver_perms(cfg)
    src = np.full((lf, K), -1, dtype=np.int32)
    start = 0
    for l in range(lf):
        c = int(cnts[l])
        h = h_even if l % 2 == 0 else h_odd
        hp = h[h < c]                     # truncated permutation over [0, c)
        hinv = np.empty(c, dtype=np.int32)
        hinv[hp] = np.arange(c, dtype=np.int32)
        src[l, fp["data_idx"][l, :c]] = start + hinv
        start += c
    # Compose the cell interleaver (§6.4) and time interleaver (§6.5) into
    # the same gather: payload stream position s is pre-interleave cell
    # payload_perm[s], so the chain gathers straight from the mapped cells.
    ci_flat = (np.arange(nb, dtype=np.int64)[:, None] * ncells
               + p["ci_gather"]).reshape(-1)
    ti = np.empty(n_payload, dtype=np.int64)
    nr = ncells // 5
    start_b = 0
    for size in p["ti_sizes"]:
        nc = size * 5
        pidx = np.arange(size * ncells, dtype=np.int64)
        ti[start_b * ncells + pidx] = (start_b * ncells
                                       + (pidx % nc) * nr + pidx // nc)
        start_b += size
    payload_perm = ci_flat[ti]
    src_fused = src.reshape(-1).astype(np.int64).copy()
    in_payload = ((src_fused >= n_l1) & (src_fused < n_l1 + n_payload))
    src_fused[in_payload] = n_l1 + payload_perm[src_fused[in_payload] - n_l1]
    src_fused = src_fused.reshape(lf, K).astype(np.int32)
    # static pilot grid
    grid = np.zeros((lf, K, 2), dtype=np.float32)
    sign = fp["pilot_sign"]
    for l in range(lf):
        idx = fp["sp_idx"][l][fp["sp_valid"][l]]
        grid[l, idx, 0] = fp["amp"][l] * sign[idx]
    # continual pilots on data symbols
    n_p2 = cfg.n_p2
    cp = fp["cp_set"]
    for l in range(n_p2, lf):
        grid[l, cp, 0] = T.CP_AMPLITUDE[cfg.fft_size] * sign[cp]
    return dict(dummy=dummy, src=np.maximum(src, 0),
                src_fused=np.maximum(src_fused, 0),
                data_mask=(src >= 0),
                pilot_grid=grid, cnts=cnts, total=total, lf=lf, K=K)


@functools.cache
def _device_frame(cfg: Dvbt2Config, device: torch.device,
                  src_key: str) -> dict:
    """The frame gather on ``device``: every carrier that holds no payload
    (pilots, L1, dummy cells, nulls) is a constant of the config, so the
    grid is ``where(payload, cells[idx], static)`` with no stream concat."""
    fa = _frame_arrays(cfg)
    l1 = _l1_plan(cfg)
    n_l1 = len(l1["pre_cells"]) + len(l1["post_cells"])
    n_payload = cfg.fec_blocks * cfg.cells_per_fec_block
    src = fa[src_key].reshape(-1).astype(np.int64)
    mask = fa["data_mask"].reshape(-1)
    stream = np.concatenate([l1["pre_cells"], l1["post_cells"],
                             np.zeros((n_payload, 2), np.float32),
                             fa["dummy"]])
    static = fa["pilot_grid"].reshape(-1, 2).copy()
    static[mask] = stream[src[mask]]
    payload = mask & (src >= n_l1) & (src < n_l1 + n_payload)
    return dict(static=torch.view_as_complex(_up(static, device)),
                payload=_up(payload, device),
                idx=_up(np.where(payload, src - n_l1, 0), device))


def _assemble_grid(cfg: Dvbt2Config, cells: torch.Tensor,
                   src_key: str) -> torch.Tensor:
    """One gather per frame of ``cells`` (the payload of L frames, frame
    by frame) and the static carriers → grid [L*L_F, K]."""
    df = _device_frame(cfg, cells.device, src_key)
    n_payload = cfg.fec_blocks * cfg.cells_per_fec_block
    frames = cells.reshape(-1, n_payload)[:, df["idx"]]  # [L, L_F*K]
    grid = torch.where(df["payload"], frames, df["static"])
    return grid.reshape(-1, cfg.carriers)


def build_frame_grid(cfg: Dvbt2Config, payload: torch.Tensor
                     ) -> torch.Tensor:
    """PLP payload cells complex64 [L*n_payload] of L frames (already
    cell/time-interleaved) -> carrier grid complex64 [L*L_F, K] with L1,
    dummy cells, frequency interleaving and pilots."""
    return _assemble_grid(cfg, payload, "src")


def build_frame_grid_fused(cfg: Dvbt2Config, cells: torch.Tensor
                           ) -> torch.Tensor:
    """Mapped cells complex64 [L*blocks, ncells] of L frames (NOT yet
    cell/time-interleaved) -> carrier grid [L*L_F, K], with the §6.4/§6.5
    interleavers composed into the frame gather (equal to
    ``cell_time_interleave`` + ``build_frame_grid``, bit for bit)."""
    return _assemble_grid(cfg, cells.reshape(-1), "src_fused")


# ---------------------------------------------------------------------------
# OFDM back end: IFFT + [tone reservation] + guard interval + P1 (§9.8, §10)
# ---------------------------------------------------------------------------

@functools.cache
def _p1_samples(cfg: Dvbt2Config) -> np.ndarray:
    """The 2048-sample P1 preamble float32 [2048, 2], a copy of the
    reference's: S1 = T2_SISO, S2 field = FFT size (mixed=0), scaled so its
    mean sample power matches the data symbols'."""
    s2 = {1024: 0, 2048: 1, 4096: 2, 8192: 3, 16384: 4, 32768: 5}[
        cfg.fft_size] << 1
    p1 = t2_p1.p1_time(s1=0, s2=s2,
                       mean_power=cfg.carriers / cfg.fft_size)
    return np.stack([p1.real, p1.imag], -1).astype(np.float32)


@functools.cache
def _tr_kernel(cfg: Dvbt2Config) -> np.ndarray:
    """Tone-reservation reference kernels float32 [2, fft, 2] (a copy of
    the reference's): the unit-peak time responses of the reserved carrier
    sets, row 0 for P2 symbols (tr_p2), row 1 for data/FC symbols (tr_data).
    The sets are the carriers ``frame_plan`` keeps free of data."""
    fft = cfg.fft_size
    K = cfg.carriers
    fp = T.frame_plan(cfg)
    left = (fft - K + 1) // 2
    kerns = []
    for pos in (fp["tr_p2"], fp["tr_data"]):
        full = np.zeros(fft, dtype=np.complex128)
        full[left + np.asarray(pos)] = 1.0
        kern = np.fft.ifft(np.fft.ifftshift(full))  # peak at sample 0
        kern /= kern[0].real                        # unit peak
        kerns.append(np.stack([kern.real, kern.imag], -1))
    return np.stack(kerns).astype(np.float32)


@functools.cache
def _device_back(cfg: Dvbt2Config, device: torch.device) -> dict:
    """P1 (already ×OUTPUT_SCALE, as the reference rounds it) and, with
    tone reservation on, the TR kernels and each symbol's kernel row."""
    p1 = _p1_samples(cfg) * np.float32(OUTPUT_SCALE)
    out = dict(p1=torch.view_as_complex(_up(p1, device)))
    if cfg.papr_tr:
        lf = cfg.frame_symbols
        out.update(
            tr_kern=torch.view_as_complex(_up(_tr_kernel(cfg), device)),
            tr_kind=_up((np.arange(lf) >= cfg.n_p2).astype(np.int64),
                        device),
            tr_pos=torch.arange(cfg.fft_size, device=device))
    return out


def _tr_step(cfg: Dvbt2Config, x: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One clip-and-filter iteration on time-domain symbols complex64
    [L*L_F, fft] of L frames; returns the new symbols and each symbol's
    peak index (the first maximum of |x|^2), int64 [L*L_F]."""
    db = _device_back(cfg, x.device)
    power = x.real * x.real + x.imag * x.imag              # [L*lf, fft]
    rms = torch.sqrt(power.mean(1))
    m = torch.argmax(power, 1)                             # [lf]
    peak = x.gather(1, m[:, None])[:, 0]
    mag = torch.sqrt(peak.real * peak.real + peak.imag * peak.imag)
    excess = torch.clamp_min(mag - PAPR_VCLIP * rms, 0.0)
    scale = torch.where(mag > 0, excess / torch.clamp_min(mag, 1e-30), 0.0)
    alpha = peak * scale                                   # complex excess
    idx = (db["tr_pos"][None, :] - m[:, None]) % cfg.fft_size
    idx = idx.reshape(-1, cfg.frame_symbols, cfg.fft_size)  # [L, lf, fft]
    kern = db["tr_kern"][db["tr_kind"][:, None], idx].reshape(x.shape)
    return x - alpha[:, None] * kern, m


def papr_reduce_tr(cfg: Dvbt2Config, time_syms: torch.Tensor
                   ) -> torch.Tensor:
    """Clip-and-filter tone reservation on time-domain symbols complex64
    [L*L_F, fft] (vclip 3.3, 3 iterations: dvbt2-blade.py:53-54).

    Each iteration finds the peak sample of every symbol and, where its
    magnitude exceeds PAPR_VCLIP × the symbol's RMS, subtracts the unit-peak
    TR kernel of the symbol's kind (P2 or data), circularly shifted to the
    peak and scaled by the complex excess.  The correction lands only on
    reserved carriers, so data cells are untouched."""
    x = time_syms
    for _ in range(PAPR_ITERATIONS):
        x, _ = _tr_step(cfg, x)
    return x


def time_symbols(cfg: Dvbt2Config, grid: torch.Tensor) -> torch.Tensor:
    """Carrier grid complex64 [n_sym, K] -> time-domain symbols complex64
    [n_sym, fft]: centred carriers, ifftshift, unnormalized IFFT."""
    fft = cfg.fft_size
    K = cfg.carriers
    left = (fft - K + 1) // 2
    spec = torch.zeros((grid.shape[0], fft), dtype=torch.complex64,
                       device=grid.device)
    spec[:, left:left + K] = grid
    return cfft.ifft_unnormalized(cfft.ifftshift(spec))


def grid_to_iq(cfg: Dvbt2Config, grid: torch.Tensor) -> torch.Tensor:
    """Carrier grid complex64 [L*L_F, K] of L frames -> IQ complex64
    [L*(2048 + L_F*(fft+gi))]: time symbols, [tone reservation,] cyclic
    prefix, ×OUTPUT_SCALE/sqrt(fft), with P1 before each frame."""
    fft = cfg.fft_size
    gi = cfg.guard_samples
    time = time_symbols(cfg, grid)
    if cfg.papr_tr:
        time = papr_reduce_tr(cfg, time)
    sym = torch.cat([time[:, fft - gi:], time], 1)
    n_frames = grid.shape[0] // cfg.frame_symbols
    body = sym.reshape(n_frames, -1) * float(OUTPUT_SCALE / np.sqrt(fft))
    p1 = _device_back(cfg, grid.device)["p1"]
    return torch.cat([p1.expand(n_frames, -1), body], 1).reshape(-1)


def modulate_frame(cfg: Dvbt2Config, ts: torch.Tensor, state: Dvbt2State
                   ) -> tuple[torch.Tensor, Dvbt2State]:
    """One T2 frame, or L consecutive ones: TS bytes uint8
    [L * payload_bytes_per_frame] -> IQ complex64 [L * samples_per_frame]
    on ``ts.device``, plus the state after the last frame."""
    bb, state = mode_adapt(cfg, ts, state)
    fec = fec_encode(cfg, bb)
    cells = interleave_and_map(cfg, fec)
    grid = build_frame_grid_fused(cfg, cells)
    return grid_to_iq(cfg, grid), state


@functools.cache
def _jit_modulator(cfg: Dvbt2Config, device: torch.device) -> Jit:
    return Jit(functools.partial(modulate_frame, cfg), device=device)


def jit_modulator(cfg: Dvbt2Config, *, device: str | torch.device = "cuda"
                  ) -> Jit:
    """``fn(ts, state) -> (iq, state)``: ``modulate_frame`` as one captured
    CUDA graph per input length on ``device`` (tone reservation's three
    passes inside it with ``papr_tr``; ``utils/graph``; eager through the
    same static buffers on the CPU), the counterpart of the reference's
    ``jit_modulator``.  The results are the caller's: the new
    ``prev_tail``, a view of the input in ``modulate_frame``, is a copy."""
    return _jit_modulator(cfg, resolve_device(device))


@span("dtv.tx.stream")
def modulate_stream(cfg: Dvbt2Config, ts: np.ndarray,
                    state: Dvbt2State | None = None, *,
                    device: str | torch.device
                    ) -> tuple[np.ndarray, Dvbt2State]:
    """Modulate whole T2 frames of host TS bytes on ``device``, one
    ``jit_modulator`` call each; returns host complex64 IQ and the final
    state (on ``device``)."""
    dev = resolve_device(device)
    blk = cfg.payload_bytes_per_frame
    if len(ts) % blk:
        raise ValueError(f"need a multiple of {blk} TS bytes, got {len(ts)}")
    if state is None:
        state = init_state(cfg, device=dev)
    elif state.prev_tail.device != dev:
        raise ValueError(f"state lives on {state.prev_tail.device}, "
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
            out.append(iq.cpu().numpy())
    with span("dtv.stream.host"):
        out = np.concatenate(out) if out else np.empty(0, np.complex64)
    return out, state


def samples_per_frame(cfg: Dvbt2Config) -> int:
    return 2048 + cfg.frame_symbols * (cfg.fft_size + cfg.guard_samples)
