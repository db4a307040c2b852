"""DVB-T2 receiver (EN 302 755) in PyTorch (port of
``dtv_utils_tpu/rx/dvbt2.py``).

It inverts ``tx/dvbt2.py`` for one or more T2 frames: P1 detection and
S1/S2 decode (host) → CP strip + forward FFT (cuFFT on the card) → the
inverse of the composed frame gather → L1-pre / L1-post parse with CRC-32
(host) → time/cell de-interleave → Q-delay undo + de-rotation → demap →
bit de-interleave → FEC → BB descramble → BB-header CRC-8 →
mode-adaptation undo with the sync-byte CRC chain (host) → TS.

Two demap paths, as in the reference: ``soft=False`` rounds each axis to
the nearest level and validates the FEC by re-encoding (the clean-signal
path); ``soft=True`` computes max-log per-bit LLRs and runs the min-sum
LDPC decoder (``ops/ldpc_decode.py``), the noisy-channel path.

Each frame is decoded on the device of the call with no host sync
(``_decode_frame``); the host reads the results once all frames are
queued.  The tables are built once per config from the port's own transmit
plan (``tx/dvbt2._plan``, ``_l1_plan``, ``_frame_arrays``) and uploaded
once per device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from dtv_utils_torch.core import bits as bitops
from dtv_utils_torch.core import cplx
from dtv_utils_torch.core.config import Dvbt2Config, T2Constellation
from dtv_utils_torch.core.galois import gf2_matmul
from dtv_utils_torch.ops import cfft
from dtv_utils_torch.ops import ldpc_decode
from dtv_utils_torch.tx import dvbt2 as TX
from dtv_utils_torch.tx import dvbt2_tables as T
from dtv_utils_torch.tx import t2_p1
from dtv_utils_torch.utils.device import resolve_device


@dataclass
class Dvbt2RxResult:
    ts: np.ndarray            # recovered TS bytes
    p1_detected: bool         # P1 found at the expected offset in each frame
    s1: int                   # decoded P1 signalling
    s2: int
    l1_pre: dict              # parsed L1-pre fields + CRC status
    l1_post: dict             # parsed L1-post fields + CRC status
    ldpc_ok: np.ndarray       # bool [frames, fec_blocks] syndrome == 0
    bch_ok: np.ndarray        # bool [frames, fec_blocks] syndrome == 0
    bb_crc_ok: np.ndarray     # bool [frames, fec_blocks] BB header CRC-8
    sync_crc_ok: bool         # §5.1 sync-byte CRC-8 chain verified


@functools.cache
def _rx_plan(cfg: Dvbt2Config) -> dict:
    """Host inverse tables, derived by inverting the transmit plan (a copy
    of the reference's ``_rx_plan``: same keys, shapes and dtypes)."""
    fa = TX._frame_arrays(cfg)
    l1 = TX._l1_plan(cfg)
    p = TX._plan(cfg)
    n_pre = len(l1["pre_cells"])
    n_post = len(l1["post_cells"])
    n_l1 = n_pre + n_post
    ncells = cfg.cells_per_fec_block
    n_payload = cfg.fec_blocks * ncells

    # stream position -> grid flat position (inverse of the frame gather
    # over the non-fused src: the recovered payload is the time-interleaved
    # stream)
    src = fa["src"].reshape(-1)
    mask = fa["data_mask"].reshape(-1)
    pos_of_stream = np.zeros(fa["total"], dtype=np.int32)
    pos_of_stream[src[mask]] = np.nonzero(mask)[0].astype(np.int32)

    # inverse of the time + cell interleaver composition
    ci_flat = (np.arange(cfg.fec_blocks, dtype=np.int64)[:, None] * ncells
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
    payload_perm = ci_flat[ti]                    # stream s -> cell index
    inv_payload = np.empty(n_payload, dtype=np.int64)
    inv_payload[payload_perm] = np.arange(n_payload)
    deinterleave = inv_payload.astype(np.int32)

    # axis demapper for the data constellation (reflected Gray, §6.3)
    v = cfg.constellation.bits_per_symbol
    half = v // 2
    L = 1 << half
    bits = (np.arange(L)[:, None] >> np.arange(half - 1, -1, -1)) & 1
    levels = T._gray_axis(bits)                  # [L] odd, in ±(L-1)
    axis_of_q = np.zeros(L, dtype=np.int32)
    for w in range(L):
        axis_of_q[int((levels[w] + L - 1) // 2)] = w
    axis_bits = ((axis_of_q[:, None] >> np.arange(half - 1, -1, -1)) & 1
                 ).astype(np.uint8)
    norm = float(T._NORM[v])
    rot = float(np.deg2rad(T.ROTATION_DEG[v])) if cfg.rotation else 0.0

    # recombine axis words into the cell word (even bits I, odd bits Q)
    word_of_iq = np.zeros((L, L), dtype=np.int32)
    for wi in range(L):
        for wq in range(L):
            word = 0
            for i in range(half):
                word |= ((wi >> (half - 1 - i)) & 1) << (v - 1 - 2 * i)
                word |= ((wq >> (half - 1 - i)) & 1) << (v - 2 - 2 * i)
            word_of_iq[wi, wq] = word
    demap_lut = word_of_iq[axis_of_q[:, None], axis_of_q[None, :]]

    # inverse of the composed bit-interleave + demux permutation
    nsub = len(p["dperm"])
    comp = np.arange(cfg.nldpc, dtype=np.int32)
    if p["bit_perm"] is not None:
        comp = np.asarray(p["bit_perm"], dtype=np.int32)[comp]
    comp = comp.reshape(-1, nsub)[:, np.asarray(p["dperm"])].reshape(-1)
    inv_comp = np.empty(cfg.nldpc, dtype=np.int32)
    inv_comp[comp] = np.arange(cfg.nldpc, dtype=np.int32)

    return dict(pos_of_stream=pos_of_stream, n_pre=n_pre, n_post=n_post,
                n_l1=n_l1, n_payload=n_payload, deinterleave=deinterleave,
                demap_lut=demap_lut, axis_bits=axis_bits,
                norm=norm, rot=rot, L=L,
                inv_comp=inv_comp, scramble=p["scramble"],
                bch_m=p["bch_m"], hdr_crc_m=p["hdr_crc_m"],
                crc8_m=p["crc8_m"])


@functools.cache
def _device_rx_plan(cfg: Dvbt2Config, device: torch.device) -> dict:
    """``_rx_plan`` on ``device``, in the dtypes the frame decode reads."""
    p = _rx_plan(cfg)

    def up(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    L, ab = p["L"], p["axis_bits"]
    return dict(
        pos_of_stream=up(p["pos_of_stream"], torch.int64),
        deinterleave=up(p["deinterleave"], torch.int64),
        demap_lut=up(p["demap_lut"]),
        levels=up((2.0 * np.arange(L) - (L - 1)) / p["norm"], torch.float32),
        # per axis bit, the levels whose bit is 1 (is 0): [half, L/2] each
        level_ones=up(np.stack([np.nonzero(ab[:, b] == 1)[0]
                                for b in range(ab.shape[1])]), torch.int64),
        level_zeros=up(np.stack([np.nonzero(ab[:, b] == 0)[0]
                                 for b in range(ab.shape[1])]), torch.int64),
        inv_comp=up(p["inv_comp"], torch.int64),
        scramble=up(p["scramble"]),
        hdr_crc_m=up(p["hdr_crc_m"], torch.float32))


def _frame_to_grid(cfg: Dvbt2Config, frame_iq: torch.Tensor) -> torch.Tensor:
    """One frame's IQ complex64 [L_F·(fft+gi)] (P1 already stripped) →
    grid complex64 [L_F, K], in the reference's order: ÷ (OUTPUT_SCALE /
    √fft) on the float32 rails, unnormalized FFT, ifftshift, ÷ fft."""
    fft = cfg.fft_size
    gi = cfg.guard_samples
    K = cfg.carriers
    sym = frame_iq.reshape(-1, fft + gi)[:, gi:]
    sym = torch.view_as_complex(
        torch.view_as_real(sym) / (TX.OUTPUT_SCALE / np.sqrt(fft)))
    spec = cfft.ifftshift(cfft.fft_unnormalized(sym))
    left = (fft - K + 1) // 2
    return torch.view_as_complex(
        torch.view_as_real(spec[:, left:left + K]) / fft)


def _axis_llrs(dp: dict, x: torch.Tensor) -> torch.Tensor:
    """Max-log axis LLRs [..., n, half] (positive = bit 0): per axis bit,
    min over levels with the bit 1 of d² − min over levels with it 0."""
    d = x[..., None] - dp["levels"]
    d2 = d * d                                          # [..., n, L]
    return d2[..., dp["level_ones"]].amin(-1) - d2[..., dp["level_zeros"]
                                                   ].amin(-1)


def _cells(cfg: Dvbt2Config, frame_iq: torch.Tensor):
    """Frame IQ → (stream complex64 [total], data cells float32 [blocks,
    ncells, 2] de-interleaved, Q delay undone and de-rotated)."""
    rp = _rx_plan(cfg)
    dp = _device_rx_plan(cfg, frame_iq.device)
    grid = _frame_to_grid(cfg, frame_iq)
    stream = grid.reshape(-1)[dp["pos_of_stream"]]
    payload = stream[rp["n_l1"]:rp["n_l1"] + rp["n_payload"]]
    cells = torch.view_as_real(payload[dp["deinterleave"]]).reshape(
        cfg.fec_blocks, cfg.cells_per_fec_block, 2)
    if cfg.rotation:
        i = cells[..., 0]
        q = torch.roll(cells[..., 1], -1, dims=1)       # undo the Q delay
        c, s = np.cos(rp["rot"]), np.sin(rp["rot"])
        cells = torch.stack([i * c + q * s, -i * s + q * c], dim=-1)
    return stream, cells


def hard_words(cfg: Dvbt2Config, cells: torch.Tensor) -> torch.Tensor:
    """Cells float32 [blocks, ncells, 2] → the nearest constellation
    point's word, int32 [blocks, ncells] (round half to even, as
    ``jnp.round``)."""
    rp = _rx_plan(cfg)
    dp = _device_rx_plan(cfg, cells.device)
    L = rp["L"]
    q = torch.clamp(torch.round((cells * rp["norm"] + L - 1) / 2), 0,
                    L - 1).to(torch.int64)
    return dp["demap_lut"][q[..., 0], q[..., 1]]


def soft_llrs(cfg: Dvbt2Config, cells: torch.Tensor) -> torch.Tensor:
    """Cells float32 [blocks, ncells, 2] → FEC-frame LLRs float32 [blocks,
    nldpc]: max-log axis LLRs woven even = I, odd = Q, then the inverse of
    the bit interleaver and demux."""
    dp = _device_rx_plan(cfg, cells.device)
    y = torch.stack([_axis_llrs(dp, cells[..., 0]),
                     _axis_llrs(dp, cells[..., 1])], dim=-1)
    return y.reshape(cfg.fec_blocks, -1).index_select(1, dp["inv_comp"])


def _decode_frame(cfg: Dvbt2Config, frame_iq: torch.Tensor, soft: bool,
                  iterations: int):
    """One frame's IQ complex64 (P1 stripped) → (L1-pre bits uint8,
    L1-post cells float32 [n_post, 2], data bytes uint8, ldpc_ok, bch_ok,
    bb_crc_ok bool [blocks]), all on the device of ``frame_iq``, with no
    host sync."""
    rp = _rx_plan(cfg)
    dp = _device_rx_plan(cfg, frame_iq.device)
    stream, cells = _cells(cfg, frame_iq)
    pre_bits = (stream[:rp["n_pre"]].real < 0).to(torch.uint8)  # BPSK
    post = torch.view_as_real(stream[rp["n_pre"]:rp["n_l1"]])
    if soft:
        fec, ldpc_ok = ldpc_decode.decode(cfg, soft_llrs(cfg, cells),
                                          iterations=iterations)
    else:
        y = bitops.words_to_bits(hard_words(cfg, cells),
                                 cfg.constellation.bits_per_symbol)
        fec = y.reshape(cfg.fec_blocks, -1).index_select(1, dp["inv_comp"])
        ldpc_ok = None

    # FEC validation: re-encode the recovered BBFRAME
    info = fec[:, :cfg.nbch]
    bb = info[:, :cfg.kbch] ^ dp["scramble"]
    reenc = TX.fec_encode(cfg, bb)
    if ldpc_ok is None:
        ldpc_ok = (reenc[:, cfg.nbch:] == fec[:, cfg.nbch:]).all(1)
    bch_ok = (reenc[:, cfg.kbch:cfg.nbch] == fec[:, cfg.kbch:cfg.nbch]).all(1)

    # BB header: 72 bits + CRC-8
    crc = gf2_matmul(bb[:, :72], dp["hdr_crc_m"])
    bb_crc_ok = (crc == bb[:, 72:80]).all(1)
    data = bitops.bits_to_bytes(bb[:, 80:].reshape(-1))
    return pre_bits, post, data, ldpc_ok, bch_ok, bb_crc_ok


def _parse_l1_pre(bits: np.ndarray) -> dict:
    """200 signalling bits -> fields; CRC-32 over the first 168."""
    def take(o, w):
        val = 0
        for i in range(w):
            val = (val << 1) | int(bits[o + i])
        return val
    crc_ok = bool(np.array_equal(T.crc32_mpeg(bits[:168]), bits[168:200]))
    return dict(
        crc_ok=crc_ok,
        type=take(0, 8), bwt_ext=take(8, 1), s1=take(9, 3), s2=take(12, 4),
        guard=take(17, 3), papr=take(20, 4), l1_mod=take(24, 4),
        l1_cod=take(28, 2), l1_fec_type=take(30, 2),
        l1_post_size=take(32, 18), l1_post_info_size=take(50, 18),
        pilot_pattern=take(68, 4), cell_id=take(80, 16),
        network_id=take(96, 16), t2_system_id=take(112, 16),
        num_t2_frames=take(128, 8), num_data_symbols=take(136, 12),
    )


def _parse_l1_post(cfg: Dvbt2Config, post_cells: np.ndarray) -> dict:
    """L1-post cells float32 [n, 2] -> demap at the L1 constellation ->
    parse KSIG fields."""
    lut_map = {1: T2Constellation.QPSK, 2: T2Constellation.QAM16,
               3: T2Constellation.QAM64}
    if cfg.l1_constellation == 0:
        bits = (post_cells[:, 0] < 0).astype(np.uint8)
    else:
        c = lut_map[cfg.l1_constellation]
        v = c.bits_per_symbol
        lut = T.constellation_pairs(c, rotation=False)
        pts = post_cells[:, 0] + 1j * post_cells[:, 1]
        ref = lut[:, 0] + 1j * lut[:, 1]
        words = np.argmin(np.abs(pts[:, None] - ref[None, :]), axis=1)
        bits = ((words[:, None] >> np.arange(v - 1, -1, -1)) & 1
                ).astype(np.uint8).reshape(-1)
    ksig = T.L1POST_KSIG
    info = bits[:ksig]

    def take(o, w):
        val = 0
        for i in range(w):
            val = (val << 1) | int(info[o + i])
        return val
    crc_ok = bool(np.array_equal(T.crc32_mpeg(info[:ksig - 32]),
                                 info[ksig - 32:]))
    return dict(
        crc_ok=crc_ok,
        num_plp=take(15, 8), frequency=take(38, 32), plp_id=take(70, 8),
        plp_type=take(78, 3), plp_payload_type=take(81, 5),
        plp_group_id=take(98, 8), plp_cod=take(106, 3), plp_mod=take(109, 3),
        plp_rotation=take(112, 1), plp_fec_type=take(113, 2),
        plp_num_blocks_max=take(115, 10),
    )


def undo_mode_adaptation(cfg: Dvbt2Config, adapted: np.ndarray
                         ) -> tuple[np.ndarray, bool]:
    """Data-field bytes of consecutive frames → (TS, sync CRC chain ok).

    The byte at each 188k is the CRC-8 of the 187 bytes before it (zeros
    before the first); every one is checked and 0x47 restored.  The
    reference walks the packets one by one; this is the same check as one
    GF(2) product over all windows (float32 0/1 sums, exact)."""
    n = len(adapted)
    sync_pos = np.arange(0, n, 188)
    windows = np.zeros((len(sync_pos), 187), dtype=np.uint8)
    if len(sync_pos) > 1:
        body = adapted[1:1 + 188 * (len(sync_pos) - 1)]
        windows[1:] = body.reshape(-1, 188)[:, :187]
    crc_m = _rx_plan(cfg)["crc8_m"].astype(np.float32)
    prod = np.unpackbits(windows, axis=1).astype(np.float32) @ crc_m
    want = np.packbits(prod.astype(np.int64).astype(np.uint8) & 1, axis=1)
    ok = bool(np.array_equal(adapted[sync_pos], want[:, 0]))
    ts = adapted.copy()
    ts[sync_pos] = 0x47
    return ts, ok


def demodulate_stream(cfg: Dvbt2Config, iq, *, soft: bool = False,
                      acquire: bool = False, iterations: int = 30,
                      device: str | torch.device) -> Dvbt2RxResult:
    """IQ (complex64 NumPy array or tensor) → recovered TS across all whole
    T2 frames, with P1/L1/FEC receiver validation, as host arrays.  Runs
    on ``device``.

    ``soft=True`` demaps to per-bit LLRs and runs the min-sum LDPC decoder
    (required on noisy input; the default hard path validates syndromes).
    ``acquire=True`` drops the frame-aligned-input contract: the P1 search
    runs over the first frame's worth of samples (plus two P1 lengths) to
    find the stream start, and everything before it is discarded."""
    dev = resolve_device(device)
    x = cplx.iq_to_device(iq, device=dev)
    host = iq.reshape(-1) if isinstance(iq, np.ndarray) else None

    def on_host(a: int, b: int) -> np.ndarray:
        return host[a:b] if host is not None else x[a:b].cpu().numpy()

    spf = TX.samples_per_frame(cfg)
    start = 0
    if acquire:
        start = t2_p1.detect_p1(on_host(0, min(x.shape[0],
                                               spf + t2_p1.P1_LEN * 2)))
    n_frames = (x.shape[0] - start) // spf
    if n_frames <= 0:
        raise ValueError(f"need at least one frame of {spf} samples")

    # the frames' heads come to the host first, so that the device decodes
    # queue with no sync between them while the host searches the P1s
    frames = range(start, start + n_frames * spf, spf)
    heads = [on_host(a, a + 4096) for a in frames]
    outs = [_decode_frame(cfg, x[a + 2048:a + spf], soft, iterations)
            for a in frames]
    # P1: guard-correlation detection + CSS S1/S2 decode
    p1_ok = all(t2_p1.detect_p1(h) == 0 for h in heads)
    s1, s2 = decode_s1_s2(heads[0][:2048])

    pre_bits, post = outs[0][0].cpu().numpy(), outs[0][1].cpu().numpy()
    adapted = torch.cat([o[2] for o in outs]).cpu().numpy()
    flags = [torch.stack([o[i] for o in outs]).cpu().numpy()
             for i in (3, 4, 5)]
    ts, sync_ok = undo_mode_adaptation(cfg, adapted)
    return Dvbt2RxResult(
        ts=ts, p1_detected=p1_ok, s1=s1, s2=s2,
        l1_pre=_parse_l1_pre(pre_bits), l1_post=_parse_l1_post(cfg, post),
        ldpc_ok=flags[0], bch_ok=flags[1], bb_crc_ok=flags[2],
        sync_crc_ok=sync_ok)


def decode_s1_s2(p1: np.ndarray) -> tuple[int, int]:
    """Decode S1/S2 from a received 2048-sample P1 by correlating the
    demodulated DBPSK sequence against the CSS patterns (EN 302 755
    §9.8)."""
    # part A spans samples 542..542+1024 (C-A-B layout, t2_p1.p1_time)
    a = p1[542:542 + 1024]
    spec = np.fft.fftshift(np.fft.fft(a))
    k = t2_p1.p1_active_carriers()
    act = spec[k + (1024 - t2_p1.P1_CARRIERS + 1) // 2]
    # DBPSK demod (differential for k>=1, absolute for k=0), then PRBS
    # descramble to recover the MSS bits
    d = act[1:] * np.conj(act[:-1])
    diff_bits = np.empty(len(act), dtype=np.uint8)
    diff_bits[0] = act[0].real < 0
    diff_bits[1:] = d.real < 0
    mss_hat = diff_bits ^ t2_p1._p1_prbs(len(act))
    best = (-1, -1, -1.0)
    for s1 in range(8):
        for s2 in range(16):
            score = np.mean(mss_hat == t2_p1.mss_bits(s1, s2))
            if score > best[2]:
                best = (s1, s2, score)
    return best[0], best[1]
