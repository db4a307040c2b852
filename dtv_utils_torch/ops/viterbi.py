"""Block-parallel soft Viterbi decoder for rate-1/2 binary convolutional
codes with puncturing (port of ``dtv_utils_tpu/ops/viterbi.py``).

It serves the DVB-T K=7 (171, 133) inner code and the J.83B K=5 (25, 37)
trellis component.  The coded stream is cut into blocks of ``block`` steps
with ``overlap`` steps of context on each side; every block runs its own
add-compare-select (ACS) recursion from an all-equal start, and only its
core is kept, so each block decodes as a whole-stream Viterbi would once
the survivors have merged (``seam_overlap``).  Blocks are independent, so a
longer stream only widens the batch: the number of trellis steps, and so
the number of launches, is ``block + 2·overlap`` whatever the length.
The blocks run in passes sized to the device's working memory (one pass
while they fit), so a stream of any length decodes in bounded memory.

Each pass is two kernels hand-written for Hopper (``csrc/viterbi.cu``): the
ACS over all L steps in one launch, writing the survivor decisions
bit-packed as the reference packs them (uint8 ``[L, B, S/8]``, bit ``s & 7``
of byte ``s >> 3``) and the final metrics, then the traceback in a second
launch.  ``_acs`` and ``_traceback`` are their wrappers: a CUDA tensor
launches the kernel, a CPU tensor takes the plain version
(``acs_reference``, a Python loop over the steps on metrics ``[B, S]``
whose bool decisions ``pack_decisions`` packs, and ``traceback_reference``,
a reverse loop of three ops per step); there is no other route and no
fallback.  The launches and the plain loops run inside ``torch.profiler``
ranges named ``viterbi_acs`` and ``viterbi_traceback``, so a trace can
attribute their device time; ``_build.LAUNCHES`` counts the kernels'
launches.

The arithmetic is the reference's, operation for operation, in the kernels
and the plain versions alike, so decisions match it bit for bit on
identical LLRs: ``bm = ±x ± y`` (exact sign flips of one rounded sum),
``cand = metric + bm``, strict ``>`` (ties pick branch 0), the max
subtraction, and a first-index ``argmax`` at the traceback start.

State convention (as ``ops/convcode.py`` and ``tx/j83b.py``): the encoder
register holds the last K-1 input bits, state s = (d[i-1] .. d[i-K+1]) with
d[i-1] at the top bit; the tap window for input b is w = (b << (K-1)) | s,
the outputs are the parities of w & g1 and w & g2, the next state w >> 1.
LLRs are positive for bit 0; an erasure is 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dtv_utils_torch.ops import _build
from dtv_utils_torch.ops.convcode import PUNCTURE_PATTERNS
from dtv_utils_torch.utils.device import (VITERBI_BYTES_PER_STEP,
                                          VITERBI_PLAIN_BYTES_PER_STEP,
                                          units_per_pass)

# DVB-T mother code (EN 300 744 §4.3.3)
DVBT_K, DVBT_G1, DVBT_G2 = 7, 0o171, 0o133
# J.83B trellis component code (SCTE 07 §5.5; tx/j83b.py G1/G2_TAPS)
J83B_K, J83B_G1, J83B_G2 = 5, 0o25, 0o37

# Survivor merge depth for the unpunctured mother code (5·K with a wide
# margin); punctured callers scale it with seam_overlap().
OVERLAP = 96

# The codes csrc/viterbi.cu is built for, K: (g1, g2); its ACS fixes the
# branch metrics' signs at compile time.
KERNEL_CODES = {DVBT_K: (DVBT_G1, DVBT_G2), J83B_K: (J83B_G1, J83B_G2)}


def seam_overlap(k: int, num: int, den: int) -> int:
    """Survivor-merge overlap for a rate-num/den punctured stream of a
    constraint-length-k mother code: ceil(5·k/(1−r)) trellis steps, never
    below OVERLAP.  Rate 7/8 → 280 steps for K=7, 4/5 → 125 for K=5."""
    return max(OVERLAP, -(-5 * k * den // (den - num)))


def _parity(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    while np.any(x):
        out ^= x & 1
        x >>= 1
    return out


@functools.cache
def _trellis(k: int, g1: int, g2: int) -> dict[str, np.ndarray]:
    """Static transition tables indexed by (next state ns, a), a the bit
    shifted out of the register (host NumPy, the reference's layout)."""
    n_states = 1 << (k - 1)
    half = n_states >> 1
    ns = np.arange(n_states)[:, None]          # [S, 1]
    a = np.arange(2)[None, :]                  # [1, 2]
    prev = ((ns & (half - 1)) << 1) | a        # predecessor state [S, 2]
    b = ns >> (k - 2)                          # input bit of the transition
    w = (b << (k - 1)) | prev                  # K-bit tap window
    out_x = 1.0 - 2.0 * _parity(w & g1)        # ±1, +1 for coded bit 0
    out_y = 1.0 - 2.0 * _parity(w & g2)
    return dict(prev=prev.astype(np.int32),
                out_x=out_x.astype(np.float32),
                out_y=out_y.astype(np.float32),
                n_states=n_states)


@functools.cache
def _device_trellis(k: int, g1: int, g2: int,
                    device: torch.device) -> torch.Tensor:
    """Index [2S] of each branch (ns, a) into the four branch metrics
    [x+y, x−y, −x+y, −x−y] of a step, on ``device``.

    The ACS reads metrics[prev[ns, a]] as a view: prev[ns, a] = 2·(ns mod
    S/2) + a, so metrics.view(B, S/2, 2)[:, ns mod S/2, a] is the
    predecessor.  That layout is checked here, once."""
    tr = _trellis(k, g1, g2)
    S = tr["n_states"]
    ns = np.arange(S)[:, None]
    if not np.array_equal(tr["prev"], 2 * (ns % (S // 2)) + np.arange(2)):
        raise AssertionError("trellis predecessors are not in butterfly "
                             "order")
    code = 2 * (tr["out_x"] < 0) + (tr["out_y"] < 0)        # [S, 2]
    return torch.from_numpy(code.reshape(-1).astype(np.int64)).to(device)


@functools.cache
def _kept_columns(xp: tuple[int, ...], yp: tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    cols = [c for i in range(len(xp))
            for c, on in ((2 * i, xp[i]), (2 * i + 1, yp[i])) if on]
    return torch.tensor(cols, dtype=torch.int64).to(device)


def depuncture_xy(llr: torch.Tensor, xp: tuple[int, ...],
                  yp: tuple[int, ...]) -> torch.Tensor:
    """Punctured serial LLRs [..., n_kept] → (x, y) pairs [..., n_steps, 2]
    with 0 (an erasure) at every punctured position.  n_kept must be a
    whole number of puncture periods."""
    period = len(xp)
    kept_per = int(sum(xp) + sum(yp))
    n = llr.shape[-1]
    if n % kept_per:
        raise ValueError(f"{n} LLRs is not a whole number of puncture "
                         f"periods of {kept_per}")
    lead = llr.shape[:-1]
    reps = n // kept_per
    full = torch.zeros((*lead, reps, 2 * period), dtype=llr.dtype,
                       device=llr.device)
    full.index_copy_(-1, _kept_columns(tuple(xp), tuple(yp), llr.device),
                     llr.reshape(*lead, reps, kept_per))
    return full.reshape(*lead, reps * period, 2)


def depuncture(llr: torch.Tensor, code_rate: tuple[int, int]) -> torch.Tensor:
    """DVB-T convenience: depuncture by EN 300 744 table 3 rate."""
    xp, yp = PUNCTURE_PATTERNS[code_rate]
    return depuncture_xy(llr, xp, yp)


def acs_reference(pairs: torch.Tensor, k: int, g1: int,
                  g2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ACS kernel: pairs float32 [L, B, 2] →
    (decisions bool [L, B, S], final metrics float32 [B, S]).
    decisions[t, b, ns] is the reference's ``cand[..., 1] > cand[..., 0]``:
    True when the survivor into ns came from a = 1."""
    L, B, _ = pairs.shape
    S = 1 << (k - 1)
    half = S // 2
    code = _device_trellis(k, g1, g2, pairs.device)
    x, y = pairs[..., 0], pairs[..., 1]
    s = x + y
    d = x - y
    bm4 = torch.stack([s, d, -d, -s], dim=-1)                 # [L, B, 4]
    decs = torch.empty((L, B, 2, half), dtype=torch.bool,
                       device=pairs.device)
    metrics = torch.zeros((B, 1, half, 2), dtype=torch.float32,
                          device=pairs.device)
    with torch.profiler.record_function("viterbi_acs"):
        for t in range(L):
            bm = bm4[t].index_select(1, code).view(B, 2, half, 2)
            cand = metrics + bm                               # [B, 2, half, 2]
            torch.gt(cand[..., 1], cand[..., 0], out=decs[t])
            new = cand.amax(-1)                               # [B, 2, half]
            metrics = (new - new.amax((1, 2), keepdim=True)).view(
                B, 1, half, 2)
    return decs.view(L, B, S), metrics.view(B, S)


def pack_decisions(decs: torch.Tensor) -> torch.Tensor:
    """bool [L, B, S] → uint8 [L, B, S/8]: decision s in bit ``s & 7`` of
    byte ``s >> 3``, the reference's packing and the kernel's words."""
    L, B, S = decs.shape
    u = decs.view(torch.uint8).reshape(L, B, S // 8, 8)
    packed = u[..., 0].clone()
    for i in range(1, 8):
        packed |= u[..., i] << i
    return packed


def traceback_reference(packed: torch.Tensor, final: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Plain version of the traceback kernel: packed decisions uint8
    [L, B, S/8] and final metrics [B, S] → decoded bits uint8 [L, B] (bit t
    is the encoder input of step t)."""
    L, B, nbytes = packed.shape
    S = 8 * nbytes
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    decs = (packed[..., None] >> shifts).bitwise_and_(1).view(
        torch.bool).view(L, B, S)
    states = torch.empty((L + 1, B, 1), dtype=torch.int64,
                         device=packed.device)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    states[L] = final.argmax(-1, keepdim=True)
    with torch.profiler.record_function("viterbi_traceback"):
        for t in range(L - 1, -1, -1):
            a = torch.gather(decs[t], 1, states[t + 1])        # bool [B, 1]
            torch.bitwise_and(torch.add(a, states[t + 1], alpha=2), S - 1,
                              out=states[t])
    return (states[1:, :, 0] >> (k - 2)).to(torch.uint8)


def _on_card(x: torch.Tensor, k: int, code=None) -> bool:
    """``_build.on_card``, and on the card a K (and a generator pair
    ``code``, where given) the kernels are built for."""
    card = _build.on_card(x)
    if card and (k not in KERNEL_CODES
                 or code not in (None, KERNEL_CODES[k])):
        raise ValueError(f"the Viterbi kernels are built for the codes "
                         f"(K: (g1, g2)) {KERNEL_CODES}, not K={k}, "
                         f"{code}")
    return card


def _acs(pairs: torch.Tensor, k: int, g1: int,
         g2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ACS over all steps: pairs float32 [L, B, 2] (contiguous) → (packed
    decisions uint8 [L, B, S/8], final metrics float32 [B, S]), by the
    kernel on the card and by ``acs_reference`` on the CPU."""
    if pairs.dtype != torch.float32:
        raise TypeError(f"pairs must be float32, got {pairs.dtype}")
    if pairs.dim() != 3 or pairs.shape[2] != 2 or k < 4:
        raise ValueError(f"need pairs [L, B, 2] and K >= 4, got "
                         f"{tuple(pairs.shape)}, K={k}")
    if not pairs.is_contiguous():
        raise ValueError("pairs must be contiguous")
    if not _on_card(pairs, k, (g1, g2)):
        decs, final = acs_reference(pairs, k, g1, g2)
        return pack_decisions(decs), final
    L, B, _ = pairs.shape
    S = 1 << (k - 1)
    packed = torch.empty((L, B, S // 8), dtype=torch.uint8,
                         device=pairs.device)
    final = torch.empty((B, S), dtype=torch.float32, device=pairs.device)
    with torch.profiler.record_function("viterbi_acs"):
        _build.launch("viterbi_acs", pairs.device, k,
                      pairs.data_ptr(), L, B, g1, g2, packed.data_ptr(),
                      final.data_ptr())
    return packed, final


def _traceback(packed: torch.Tensor, final: torch.Tensor,
               k: int) -> torch.Tensor:
    """Packed decisions uint8 [L, B, S/8] and final metrics float32 [B, S]
    (both contiguous, on one device) → bits uint8 [L, B], by the kernel on
    the card and by ``traceback_reference`` on the CPU.  On the card the
    decisions must start at a multiple of their S/8-byte word (any view
    of ``_acs``'s output along L does), else the launch raises."""
    S = 1 << (k - 1)
    if packed.dtype != torch.uint8 or final.dtype != torch.float32:
        raise TypeError(f"need uint8 decisions and float32 metrics, got "
                        f"{packed.dtype} and {final.dtype}")
    if (packed.dim() != 3 or k < 4 or packed.shape[2] != S // 8
            or final.shape != (packed.shape[1], S)):
        raise ValueError(f"need decisions [L, B, {S // 8}] and metrics "
                         f"[B, {S}] for K={k}, got {tuple(packed.shape)} "
                         f"and {tuple(final.shape)}")
    if packed.device != final.device:
        raise ValueError(f"decisions on {packed.device}, metrics on "
                         f"{final.device}")
    if not (packed.is_contiguous() and final.is_contiguous()):
        raise ValueError("decisions and metrics must be contiguous")
    if not _on_card(packed, k):
        return traceback_reference(packed, final, k)
    L, B, _ = packed.shape
    bits = torch.empty((L, B), dtype=torch.uint8, device=packed.device)
    with torch.profiler.record_function("viterbi_traceback"):
        _build.launch("viterbi_traceback", packed.device, k,
                      packed.data_ptr(), final.data_ptr(), L, B,
                      bits.data_ptr())
    return bits


def _decode(window, n_str: int, n: int, block: int, overlap: int, k: int,
            g1: int, g2: int, device: torch.device) -> torch.Tensor:
    """Blocked Viterbi over ``n_str`` streams of n steps, in passes of as
    many blocks as the device's working memory holds (all streams' blocks
    side by side; ``utils.device.units_per_pass``).  ``window(lo, hi)``
    gives the float32 (x, y) pairs [n_str, hi − lo, 2] of stream positions
    [lo, hi).  Blocks are independent, so the passes decode exactly as one
    pass would.  Returns bits uint8 [n_str, n]."""
    block = min(block, n)
    nb = -(-n // block)
    L = block + 2 * overlap
    # the kernels' bytes on the card, the plain version's (bool decisions)
    # on the CPU; both K=7's, and the narrower K=5 trellis needs less
    step = (VITERBI_BYTES_PER_STEP if device.type == "cuda"
            else VITERBI_PLAIN_BYTES_PER_STEP)
    per_pass = max(1, units_per_pass(device, L * step) // n_str)
    core = torch.empty((n_str, nb, block), dtype=torch.uint8, device=device)
    for b0 in range(0, nb, per_pass):
        b1 = min(b0 + per_pass, nb)
        # block b covers stream positions [b·block − overlap,
        # (b+1)·block + overlap)
        lo, hi = b0 * block - overlap, b1 * block + overlap
        x = window(max(lo, 0), min(hi, n))
        # Head pad: strong zero-bit evidence (the encoder starts in state 0
        # and pre-stream steps emit X=Y=0).  Tail pad: erasures (the final
        # state is the last K-1 data bits, which no tail evidence may
        # contradict).
        ext = F.pad(x, (0, 0, max(-lo, 0), 0), value=4.0)
        ext = F.pad(ext, (0, 0, 0, max(hi - n, 0)))
        blocks = ext.unfold(1, L, block)                 # [str, nbp, 2, L]
        pairs = blocks.permute(3, 0, 1, 2).reshape(L, -1, 2).contiguous()
        packed, final = _acs(pairs, k, g1, g2)
        bits = _traceback(packed, final, k)              # [L, str*nbp]
        core[:, b0:b1] = bits[overlap:overlap + block].T.reshape(
            n_str, b1 - b0, block)
        # free this pass before the next one builds its window
        del x, ext, blocks, pairs, packed, final, bits
    return core.view(n_str, nb * block)[:, :n]


def viterbi_decode(llr_pairs: torch.Tensor, block: int = 4096,
                   overlap: int = OVERLAP, k: int = DVBT_K,
                   g1: int = DVBT_G1, g2: int = DVBT_G2) -> torch.Tensor:
    """Decode (x, y) LLR pairs [..., n, 2] → input bits uint8 [..., n], on
    the device of the input.

    Leading dimensions are independent streams of equal length, decoded
    side by side in each ACS pass; each decodes exactly as it would alone.
    Every stream is assumed to start from the all-zero encoder state.
    Punctured callers must pass ``overlap=seam_overlap(k, num, den)``
    (viterbi_decode_punctured does).  The blocks run in passes sized to
    the device's working memory; the bits do not depend on the passes.
    On the card the kernels are built for two codes, ``KERNEL_CODES``:
    DVB-T's K=7 (171, 133) and J.83B's K=5 (25, 37); another code raises
    there (the CPU path takes any rate-1/2 code).
    """
    *lead, n, two = llr_pairs.shape
    if two != 2:
        raise ValueError(f"need (x, y) pairs [..., n, 2], got "
                         f"{tuple(llr_pairs.shape)}")
    if n == 0:
        return torch.zeros((*lead, 0), dtype=torch.uint8,
                           device=llr_pairs.device)
    x = llr_pairs.reshape(-1, n, 2).to(torch.float32)
    bits = _decode(lambda lo, hi: x[:, lo:hi], x.shape[0], n, block, overlap,
                   k, g1, g2, x.device)
    return bits.reshape(*lead, n)


def viterbi_decode_punctured(llr: torch.Tensor, code_rate: tuple[int, int],
                             block: int = 4096) -> torch.Tensor:
    """DVB-T punctured serial LLR stream [..., n_kept] → decoded input bits
    uint8, with the overlap scaled to the puncture rate.  Each pass
    depunctures only the puncture periods its blocks read, so no
    whole-stream copy of the pairs is made."""
    xp, yp = PUNCTURE_PATTERNS[code_rate]
    period, kept = len(xp), int(sum(xp) + sum(yp))
    *lead, n_kept = llr.shape
    if n_kept % kept:
        raise ValueError(f"{n_kept} LLRs is not a whole number of puncture "
                         f"periods of {kept}")
    n = n_kept // kept * period
    if n == 0:
        return torch.zeros((*lead, 0), dtype=torch.uint8, device=llr.device)
    z = llr.reshape(-1, n_kept).to(torch.float32)

    def window(lo: int, hi: int) -> torch.Tensor:
        p0, p1 = lo // period, -(-hi // period)
        pairs = depuncture_xy(z[:, p0 * kept:p1 * kept], xp, yp)
        return pairs[:, lo - p0 * period:hi - p0 * period]

    bits = _decode(window, z.shape[0], n, block,
                   seam_overlap(DVBT_K, *code_rate), DVBT_K, DVBT_G1,
                   DVBT_G2, z.device)
    return bits.reshape(*lead, n)
