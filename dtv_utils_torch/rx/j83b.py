"""ITU-T J.83 Annex B 64-QAM cable receiver in PyTorch (port of
``dtv_utils_tpu/rx/j83b.py``).

It inverts ``tx/j83b.py``: RRC matched filter + symbol-rate downsample
(calibrated against the interpolator's combined response) → nearest-point
64-QAM demap → differential quadrant decode → the two 16-state Viterbi
decoders (``ops/viterbi.py``, K=5 (25,37) punctured 4/5, run as one batch)
→ trellis-group reassembly → FSYNC check and control word → derandomize →
(I=128, J=4) convolutional de-interleave → RS(127,122) over GF(128) with
t=2 correction and the extension-symbol check → transport checksum and
0x47 restore → TS.

The IQ must start at a superblock boundary.  The de-interleaver keeps
65,024 symbols in flight, so the last ~8.5 FEC frames of a stream stay
undecoded, as in a hardware receiver.  The whole chain runs on the device
of the call; the matched filter is ``F.conv1d`` with TF32 switched off for
the call, so cuDNN sums in full float32 whatever the caller has set.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from dtv_utils_torch.core import bits as bitops
from dtv_utils_torch.core import cplx
from dtv_utils_torch.core.config import J83bConfig
from dtv_utils_torch.core.galois import GF128, gf2_matmul
from dtv_utils_torch.ops.rs_decode import RsDecoder, xor_reduce
from dtv_utils_torch.ops.viterbi import (J83B_G1, J83B_G2, J83B_K,
                                         depuncture_xy, seam_overlap,
                                         viterbi_decode)
from dtv_utils_torch.tx import j83b as TX
from dtv_utils_torch.utils.device import resolve_device

SUPERBLOCK_SAMPLES = 2 * TX.SUPERBLOCK_SYMBOLS


@dataclass
class J83bRxResult:
    ts: np.ndarray            # recovered TS bytes
    fsync_ok: bool            # every frame trailer matched
    control_word: int         # interleaver mode from the trailer (expect 6)
    rs_ok: np.ndarray         # bool [n_cw] codeword decodable
    rs_errors: np.ndarray     # int32 [n_cw] corrected symbol errors
    ext_ok: np.ndarray        # bool [n_cw] extension-symbol check
    checksum_ok: np.ndarray   # bool [n_pkts] transport checksum verified


@functools.cache
def _mf_plan(cfg: J83bConfig) -> dict:
    """Matched-filter calibration: push a unit impulse through the exact TX
    interpolator, correlate with the taps, and measure the combined
    response's peak offset and scale and its worst-case residual ISI."""
    taps = TX.rrc_taps(cfg).astype(np.float64)
    nt = len(taps)
    # TX: out[2m + p] = sum_k taps[2k + p] * ext[m + 49 - k] with
    # ext = [49-zero tail, cells], i.e. cell index c = m - k.
    M = nt  # impulse at cell index M, comfortably inside
    n_cells = 2 * nt + 1
    out = np.zeros(2 * n_cells)
    for m in range(n_cells):
        for p in range(2):
            for k in range(nt // 2):
                if m - k == M:
                    out[2 * m + p] += taps[2 * k + p]
    # RX: y[i] = sum_j taps[j] * out[i + j]  (correlation, zero-pad tail)
    resp = np.correlate(out, taps, mode="full")[nt - 1:]
    # the symbol estimate for cell m reads y[2m + off]
    peak_i = int(np.argmax(np.abs(resp)))
    off = peak_i - 2 * M
    scale = resp[peak_i]
    isi = sum(abs(resp[peak_i + 2 * d]) for d in range(-M // 2, M // 2)
              if d != 0 and 0 <= peak_i + 2 * d < len(resp))
    return dict(off=off, scale=float(scale), isi=float(isi / abs(scale)),
                taps=taps.astype(np.float32))


@functools.cache
def _device_front(cfg: J83bConfig, device: torch.device) -> dict:
    mp = _mf_plan(cfg)
    return dict(taps=torch.from_numpy(mp["taps"]).to(device)[None, None],
                lut=torch.from_numpy(TX.CONSTELLATION_64_RAILS).to(device))


@contextlib.contextmanager
def _full_fp32_convolutions():
    """cuDNN convolutions in full float32 for the duration of the call
    (cuDNN allows TF32 by default)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def front(cfg: J83bConfig, iq: torch.Tensor) -> torch.Tensor:
    """IQ complex64 [n] (n even) → 6-bit words int32 [n/2]: the matched
    filter y[i] = Σ_j taps[j]·x[i+j] read at y[2m + off] (a stride-2
    correlation), over the peak scale, then the nearest constellation point
    (first index on a tie, as the reference's argmin)."""
    mp = _mf_plan(cfg)
    off = mp["off"]
    if not 0 <= off <= 2:
        raise ValueError(f"matched-filter offset {off} outside 0..2")
    dp = _device_front(cfg, iq.device)
    nt = dp["taps"].shape[-1]
    n_sym = iq.shape[0] // 2
    rails = F.pad(torch.view_as_real(iq).T, (0, nt))        # [2, n + nt]
    with _full_fp32_convolutions():
        y = F.conv1d(rails[:, None, off:], dp["taps"], stride=2)
    sym = y[:, 0, :n_sym] / mp["scale"]                      # [2, n_sym]
    d2 = sym[0][:, None] - dp["lut"][0][None, :]             # [n_sym, 64]
    d2.mul_(d2)
    dq = sym[1][:, None] - dp["lut"][1][None, :]
    d2.add_(dq.mul_(dq))
    return d2.argmin(1).to(torch.int32)


def trellis_decode(words: torch.Tensor) -> torch.Tensor:
    """words int32 [n_sym] (n_sym % 5 == 0) → frame bits uint8
    [n_sym / 5 · 28] (inverse TCM).  The two coded substreams go through
    one Viterbi call as two independent streams."""
    w32 = words.to(torch.int32)

    def bit(i):
        return ((w32 >> i) & 1).to(torch.uint8)

    u, v, W, ca, cb, Z = bit(5), bit(4), bit(3), bit(2), bit(1), bit(0)
    # differential quadrant decode: q_out = Gray(W, Z) is a running sum of
    # the increments q_in mod 4
    q_out = (W.to(torch.int32) << 1) | (W ^ Z).to(torch.int32)
    q_prev = F.pad(q_out[:-1], (1, 0))
    q_in = (q_out - q_prev) & 3
    w = (q_in >> 1).to(torch.uint8)
    z = w ^ (q_in & 1).to(torch.uint8)
    llr = 1.0 - 2.0 * torch.stack([ca, cb]).to(torch.float32)
    pairs = depuncture_xy(llr, TX.PUNCT_X, TX.PUNCT_Y)       # [2, n_step, 2]
    dec = viterbi_decode(pairs, block=4096, k=J83B_K, g1=J83B_G1,
                         g2=J83B_G2, overlap=seam_overlap(J83B_K, 4, 5))
    n_grp = words.shape[0] // 5
    ca_in, cb_in = dec.reshape(2, n_grp, 4)
    # substream reassembly (inverse of the tx trellis_encode group layout)
    ua = torch.stack([w.reshape(n_grp, 5), u.reshape(n_grp, 5)],
                     dim=-1).reshape(n_grp, 10)
    ub = torch.stack([z.reshape(n_grp, 5), v.reshape(n_grp, 5)],
                     dim=-1).reshape(n_grp, 10)
    a = torch.cat([ua, ca_in], dim=1)                        # [n_grp, 14]
    b = torch.cat([ub, cb_in], dim=1)
    return torch.stack([a, b], dim=-1).reshape(-1)


@functools.cache
def _rs_dec() -> RsDecoder:
    """Decoder for the inner (127,122) code; the extension symbol is
    checked separately (see ``tx/j83b._rs``)."""
    return RsDecoder(GF128, k_sym=TX.RS_K, nroots=5, first_root=1)


@functools.cache
def _deinterleave_index(n_cw: int, device: torch.device) -> torch.Tensor:
    """interleaved[k] = cw[k − I·J·(k % I)]  ⇒  cw[j] = inter[j + I·J·(j % I)]
    (zero initial carry)."""
    j = np.arange(n_cw * TX.RS_N, dtype=np.int64)
    return torch.from_numpy(j + TX.ILV_I * TX.ILV_J * (j % TX.ILV_I)).to(
        device)


def demodulate_stream(cfg: J83bConfig, iq, *,
                      device: str | torch.device) -> J83bRxResult:
    """IQ (complex64 NumPy array or tensor, whole superblocks) → recovered
    TS and receiver health, as host arrays.  Runs on ``device``."""
    dev = resolve_device(device)
    x = cplx.iq_to_device(iq, device=dev)
    if x.shape[0] == 0 or x.shape[0] % SUPERBLOCK_SAMPLES:
        raise ValueError(f"need whole superblocks of {SUPERBLOCK_SAMPLES} "
                         f"samples, got {x.shape[0]}")
    n_sb = x.shape[0] // SUPERBLOCK_SAMPLES
    n_fr = n_sb * TX.FRAMES_PER_SUPERBLOCK
    fb = trellis_decode(front(cfg, x)).reshape(n_fr, TX.FRAME_BITS)

    # FSYNC check + strip.  The stream's final ~2 trellis groups have no
    # continuation evidence, so the last frame's trailer (the last 42 bits)
    # is left out of the check, as a streaming receiver never sees it.
    pay_bits = TX.FRAME_SYMBOLS * 7
    sync = fb[:, pay_bits:]
    want = TX._device_table("fsync", dev)[0]
    fsync_ok = (sync[:-1] == want).all()
    control_word = bitops.bits_to_words(sync[0, -4:], 4)[0]

    # derandomize + de-interleave
    syms = bitops.bits_to_words(fb[:, :pay_bits], 7)          # [n_fr, 7680]
    rnd = TX._device_table("randomizer", dev)
    inter = (syms.reshape(n_sb, -1) ^ rnd).reshape(-1)
    max_shift = TX.ILV_I * TX.ILV_J * (TX.ILV_I - 1)
    # tail guard: the final 2 trellis groups' bits (ceil(56/7) = 8 symbols)
    # lie in the Viterbi erasure tail, not yet received in stream terms
    n_cw = max((inter.shape[0] - max_shift - 8) // TX.RS_N, 0)
    cw = inter[_deinterleave_index(n_cw, dev)].reshape(n_cw, TX.RS_N)

    # RS: correct up to t=2 on the (127,122) body, check the extension
    corrected, n_err, ok = _rs_dec().decode_words(cw[:, :127])
    ext_ok = xor_reduce(corrected) == cw[:, 127]

    # transport de-framing: 7-bit symbols → bytes → checksum verify
    bits = bitops.words_to_bits(corrected[:, :TX.RS_K].reshape(-1), 7)
    n_pkts = bits.shape[0] // 8 // 188
    packed = bitops.bits_to_bytes(bits[:n_pkts * 188 * 8]).reshape(n_pkts, 188)
    crc = bitops.bits_to_bytes(gf2_matmul(
        bitops.bytes_to_bits(packed[:, 1:]), TX._device_table("crc", dev)))
    checksum_ok = packed[:, 0] == crc[:, 0]
    ts = packed.clone()
    ts[:, 0] = 0x47

    return J83bRxResult(
        ts=ts.reshape(-1).cpu().numpy(), fsync_ok=bool(fsync_ok),
        control_word=int(control_word), rs_ok=ok.cpu().numpy(),
        rs_errors=n_err.cpu().numpy(), ext_ok=ext_ok.cpu().numpy(),
        checksum_ok=checksum_ok.cpu().numpy())
