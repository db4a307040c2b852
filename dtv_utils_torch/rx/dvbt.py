"""DVB-T receiver (EN 300 744) in PyTorch (port of
``dtv_utils_tpu/rx/dvbt.py``).

It inverts ``tx/dvbt.py``: IQ → cyclic-prefix strip → forward FFT (cuFFT
on the card) → carrier extraction → pilot-phase detection → TPS decode
(differential + BCH syndrome check, on the host) → composed
de-interleave gather → max-log soft demap (per-bit LLRs) → depuncture →
block-parallel soft Viterbi (``ops/viterbi.py``) → Forney deinterleave →
Berlekamp-Massey RS(204,188) (``ops/rs_decode.py``) → energy de-dispersal
→ TS.

The IQ must start at a superframe boundary, the modulator's output
contract.  The pilot phase and TPS are decoded from the signal and
reported, not assumed.  Everything up to the TS runs on the device of the
call, with no host sync; the host tables are built once per config from
the port's own transmit plan (``tx/dvbt._plan``) and uploaded once per
device.  The soft demap and the decoders repeat the reference's
arithmetic, so on identical carriers their outputs are bit-exact.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from dtv_utils_torch.core import bits as bitops
from dtv_utils_torch.core import cplx
from dtv_utils_torch.core.config import DvbtConfig
from dtv_utils_torch.core.prbs import dvbt_dispersal_mask, dvbt_pilot_signs
from dtv_utils_torch.ops import cfft
from dtv_utils_torch.ops.rs_decode import DVBT_RS_DEC
from dtv_utils_torch.ops.viterbi import viterbi_decode_punctured
from dtv_utils_torch.tx import dvbt_tables as T
from dtv_utils_torch.tx.dvbt import OUTER_I, OUTER_M, OUTPUT_SCALE, _plan
from dtv_utils_torch.utils.device import resolve_device

PKT, CODED_PKT = 188, 204


@dataclass
class DvbtRxResult:
    ts: np.ndarray            # uint8 recovered transport stream
    rs_errors: np.ndarray     # int32 [n_pkts] corrected byte errors
    rs_ok: np.ndarray         # bool [n_pkts] packet decodable
    phase_ok: bool            # scattered-pilot phase sequence as expected
    tps: dict                 # decoded TPS fields + BCH syndrome status


@functools.cache
def _rx_plan(cfg: DvbtConfig) -> dict:
    """Host inverse tables derived from the transmit plan (a copy of the
    reference's ``_rx_plan``: same keys, shapes and dtypes)."""
    p = _plan(cfg)
    v = cfg.constellation.bits_per_symbol
    K = cfg.mode.carriers
    n_data = cfg.mode.data_carriers

    # inverse of the composed symbol-interleave gather:
    # TX: carriers[l, k] = lut[words[l, comp_idx[ph, k]]] on data positions
    inv_idx = np.zeros((4, n_data), dtype=np.int32)
    for ph in range(4):
        k_pos = np.where(p["data_mask"][ph])[0]
        inv_idx[ph, p["comp_idx"][ph][k_pos]] = k_pos

    # axis demapper: the I-axis level of each axis word (sign + Gray)
    half = v // 2
    L = 1 << half
    lut_c = T.constellation_lut(cfg.constellation)
    norm = {1: np.sqrt(2.0), 2: np.sqrt(10.0), 3: np.sqrt(42.0)}[half]
    axis_bits_of_q = np.zeros(L, dtype=np.int32)
    for w in range(L):
        # cell word with re-axis bits = w, im-axis bits = 0
        bits = np.zeros(v, dtype=np.int64)
        for i in range(half):
            bits[2 * i] = (w >> (half - 1 - i)) & 1
        word = 0
        for b in bits:
            word = (word << 1) | int(b)
        val = lut_c[word].real * norm
        q = int(round((val + (2 * L - 1) - L) / 2))  # levels ±1..±(2L-1)
        axis_bits_of_q[q] = w
    # max-log soft demap tables: per axis, the L level values and each
    # level's axis-bit pattern
    axis_levels = np.empty(L, dtype=np.float32)
    axis_bits = np.empty((L, half), dtype=np.uint8)
    for q in range(L):
        w = axis_bits_of_q[q]
        axis_levels[q] = (2 * q - (L - 1)) / norm
        axis_bits[q] = [(w >> (half - 1 - i)) & 1 for i in range(half)]

    # inverse of the bit-plane packing: kept-stream position of (u % P, e)
    demux_pos = np.argsort(np.asarray(T.DEMUX[v]))
    P = p["gen_P"]
    s0_of = np.zeros(P * v, dtype=np.int64)     # (u*v + e) -> kept index
    for u in range(P):
        blk_base = (u // T.BIT_ILV_BLOCK) * T.BIT_ILV_BLOCK
        for e in range(v):
            u2 = blk_base + ((u % T.BIT_ILV_BLOCK) + T.BIT_ILV_OFFSETS[e]) \
                % T.BIT_ILV_BLOCK
            s0_of[u * v + e] = v * u2 + int(demux_pos[e])
    inv_s0 = np.argsort(s0_of).astype(np.int32)  # kept index -> (u*v+e)

    # pilot references for phase detection
    w_sign = dvbt_pilot_signs(K)
    scat_ref = []
    for ph in range(4):
        s = T.scattered_pilots(cfg.mode, ph)
        ref = np.zeros(K, dtype=np.float32)
        ref[s] = w_sign[s]
        scat_ref.append(ref)

    mask, _ = dvbt_dispersal_mask()
    return dict(inv_idx=inv_idx, inv_s0=inv_s0,
                axis_levels=axis_levels, axis_bits=axis_bits,
                scat_ref=np.stack(scat_ref), dispersal=mask,
                tps_carriers=T.tps_carriers(cfg.mode).astype(np.int32),
                tps_base=w_sign[T.tps_carriers(cfg.mode)].astype(np.float32))


@functools.cache
def _device_rx_plan(cfg: DvbtConfig, device: torch.device) -> dict:
    """``_rx_plan`` on ``device``, in the dtypes the chain consumes."""
    p = _rx_plan(cfg)

    def up(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    # the levels whose axis bit b is 1 (is 0): [half, L/2] each
    ab = p["axis_bits"]
    ones = np.stack([np.nonzero(ab[:, b] == 1)[0] for b in range(ab.shape[1])])
    zeros = np.stack([np.nonzero(ab[:, b] == 0)[0]
                      for b in range(ab.shape[1])])
    return dict(inv_idx=up(p["inv_idx"], torch.int64),
                inv_s0=up(p["inv_s0"], torch.int64),
                axis_levels=up(p["axis_levels"]),
                level_ones=up(ones, torch.int64),
                level_zeros=up(zeros, torch.int64),
                scat_ref=up(p["scat_ref"]),
                dispersal=up(p["dispersal"].reshape(8, PKT)),
                tps_carriers=up(p["tps_carriers"], torch.int64),
                tps_base=up(p["tps_base"]))


def iq_to_carriers(cfg: DvbtConfig, iq: torch.Tensor) -> torch.Tensor:
    """IQ complex64 [n] → carrier grid complex64 [n_sym, K] (inverse of
    ``tx.dvbt.carriers_to_iq``)."""
    fft = cfg.fft_size
    gi = cfg.guard_samples
    K = cfg.mode.carriers
    sym = iq.reshape(-1, fft + gi)[:, gi:]
    spec = cfft.ifftshift(cfft.fft_unnormalized(sym))
    left = (fft - K + 1) // 2
    # divide the float32 rails, as the reference does
    return torch.view_as_complex(
        torch.view_as_real(spec[:, left:left + K]) / (fft * OUTPUT_SCALE))


def _extract_cells(cfg: DvbtConfig, carriers: torch.Tensor) -> torch.Tensor:
    """Carrier grid [n_sym, K] → de-interleaved data cells complex64
    [n_cells]; the grid starts at pilot phase 0."""
    inv = _device_rx_plan(cfg, carriers.device)["inv_idx"]   # [4, n_data]
    n_sym, K = carriers.shape
    grid = carriers.reshape(n_sym // 4, 4, K)
    return torch.gather(grid, 2, inv.expand(n_sym // 4, -1, -1)).reshape(-1)


def _cell_bit_llrs(cfg: DvbtConfig, cells: torch.Tensor) -> torch.Tensor:
    """Max-log per-bit LLRs float32 [n_cells, v] (positive = bit 0): per
    axis, LLR_b = min over levels with bit 1 of d² − min over levels with
    bit 0.  Even cell-word bits come from I, odd from Q (§4.3.5)."""
    p = _device_rx_plan(cfg, cells.device)
    v = cfg.constellation.bits_per_symbol
    lv = p["axis_levels"]

    def axis_llrs(x):                           # x [n] -> [n, half]
        d = x[:, None] - lv[None, :]
        d2 = d * d                              # [n, L]
        d1 = d2[:, p["level_ones"]].amin(-1)    # [n, half]
        d0 = d2[:, p["level_zeros"]].amin(-1)
        return d1 - d0

    rails = torch.view_as_real(cells)
    li = axis_llrs(rails[:, 0])
    lq = axis_llrs(rails[:, 1])
    return torch.stack([li, lq], dim=2).reshape(-1, v)   # even=I, odd=Q


def detect_symbol_phase(cfg: DvbtConfig,
                        carriers: torch.Tensor) -> torch.Tensor:
    """Per-symbol scattered-pilot phase estimate int64 [n_sym] in 0..3: the
    reference pattern whose pilots correlate best (elementwise float32
    products summed, so no TF32 matmul can enter; first index on a tie)."""
    ref = _device_rx_plan(cfg, carriers.device)["scat_ref"]   # [4, K]
    score = (carriers.real[:, None, :] * ref[None]).sum(-1)   # [n_sym, 4]
    return score.argmax(1)


def decode_tps(cfg: DvbtConfig, carriers: torch.Tensor) -> dict:
    """Differential TPS decode + BCH(67,53) syndrome check per frame: a
    majority vote per OFDM symbol on the device, the rest on the host."""
    p = _device_rx_plan(cfg, carriers.device)
    r = carriers.real[:, p["tps_carriers"]] * p["tps_base"][None, :]
    d = torch.sign(torch.sign(r).sum(1)).cpu().numpy().reshape(-1, 68)
    s = (d[:, 1:] != d[:, :-1]).astype(np.uint8)
    s = np.concatenate([np.zeros((len(d), 1), np.uint8), s], axis=1)
    out = {"frames": []}
    g = T._TPS_BCH_M.astype(np.int64)
    for sf in s:
        parity = (sf[1:54].astype(np.int64) @ g) & 1
        bch_ok = bool(np.array_equal(parity, sf[54:68]))
        sync_odd = bool(np.array_equal(sf[1:17], T.TPS_SYNC_ODD))
        sync_even = bool(np.array_equal(sf[1:17], T.TPS_SYNC_EVEN))
        out["frames"].append(dict(
            bch_ok=bch_ok,
            sync=("odd" if sync_odd else "even" if sync_even else "BAD"),
            frame_number=int((sf[23] << 1) | sf[24]),
            constellation=int((sf[25] << 1) | sf[26]),
            code_rate_hp=int((sf[30] << 2) | (sf[31] << 1) | sf[32]),
            guard=int((sf[36] << 1) | sf[37]),
            mode=int((sf[38] << 1) | sf[39]),
        ))
    out["all_bch_ok"] = all(fr["bch_ok"] for fr in out["frames"])
    return out


def coded_llrs(cfg: DvbtConfig, cells: torch.Tensor) -> torch.Tensor:
    """Cells → the punctured coder output's LLRs float32 [n_kept], in
    stream order: the soft demap, then the inverse of the bit-plane
    packing applied to the LLRs as the transmitter applied it to bits."""
    inv_s0 = _device_rx_plan(cfg, cells.device)["inv_s0"]
    llrs = _cell_bit_llrs(cfg, cells)           # [n_cells, v], + = bit 0
    z = llrs.reshape(-1, inv_s0.shape[0]).index_select(1, inv_s0)
    return z.reshape(-1)


def llrs_to_outer_bytes(cfg: DvbtConfig, cells: torch.Tensor) -> torch.Tensor:
    """Cells → outer-interleaved coded bytes uint8 (soft demap, depuncture
    + Viterbi)."""
    bits = viterbi_decode_punctured(coded_llrs(cfg, cells),
                                    cfg.code_rate.value)
    return bitops.bits_to_bytes(bits)


@functools.cache
def _forney_deinterleave_index(n_pkts: int,
                               device: torch.device) -> torch.Tensor:
    """coded[j] = outer[j + 204·(j % 12)] (zero initial carry)."""
    j = np.arange(n_pkts * CODED_PKT, dtype=np.int64)
    return torch.from_numpy(j + CODED_PKT * (j % OUTER_I)).to(device)


def decode_outer(outer: torch.Tensor):
    """Outer-interleaved bytes → (RS-corrected packets uint8 [n_pkts, 188],
    corrected byte counts int32, ok bool).  The Forney deinterleaver keeps
    I·M·(I−1) = 2244 bytes in flight, like a hardware receiver's."""
    carry = OUTER_I * OUTER_M * (OUTER_I - 1)
    n_pkts = max((outer.shape[0] - carry) // CODED_PKT, 0)
    coded = outer[_forney_deinterleave_index(n_pkts, outer.device)]
    corrected, n_err, ok = DVBT_RS_DEC().decode_bytes(
        coded.reshape(n_pkts, CODED_PKT))
    return corrected[:, :PKT], n_err, ok


def demodulate_stream(cfg: DvbtConfig, iq, *,
                      device: str | torch.device) -> DvbtRxResult:
    """IQ (complex64 NumPy array or tensor, whole superframes) → recovered
    TS and receiver health, as host arrays.  Runs on ``device``.

    Decodes every complete TS packet the stream holds; the Forney
    deinterleaver's 2244-byte tail stays in flight."""
    dev = resolve_device(device)
    x = cplx.iq_to_device(iq, device=dev)
    n_spf = cfg.symbols_per_superframe * (cfg.fft_size + cfg.guard_samples)
    if x.shape[0] == 0 or x.shape[0] % n_spf:
        raise ValueError(f"need whole superframes of {n_spf} samples, got "
                         f"{x.shape[0]}")

    carriers = iq_to_carriers(cfg, x)
    phases = detect_symbol_phase(cfg, carriers)
    outer = llrs_to_outer_bytes(cfg, _extract_cells(cfg, carriers))
    pkts, n_err, ok = decode_outer(outer)

    # energy de-dispersal (XOR is involutive; phase = packet index mod 8)
    rows = _device_rx_plan(cfg, dev)["dispersal"]
    ts = pkts ^ rows[torch.arange(pkts.shape[0], device=dev) % 8]

    phase_np = phases.cpu().numpy()
    return DvbtRxResult(
        ts=ts.reshape(-1).cpu().numpy(),
        rs_errors=n_err.cpu().numpy(),
        rs_ok=ok.cpu().numpy(),
        phase_ok=bool(np.array_equal(phase_np,
                                     np.arange(len(phase_np)) % 4)),
        tps=decode_tps(cfg, carriers),
    )
