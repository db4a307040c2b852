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

On the device that is a Python loop over the steps on metrics ``[B, S]``
(float32): per step one gather of the step's branch metrics, one add, one
compare into the decision tensor (bool ``[L, B, S]``), one max over the two
branches and the per-block max subtraction, and no host sync.  The
traceback is a reverse loop of three ops per step.  The two loops run
inside ``torch.profiler`` ranges named ``viterbi_acs`` and
``viterbi_traceback``, so a trace can attribute their device time.

The arithmetic is the reference's, operation for operation, so decisions
match it bit for bit on identical LLRs: ``bm = ±x ± y`` (exact sign flips
of one rounded sum), ``cand = metric + bm``, strict ``>`` (ties pick branch
0), the max subtraction, and a first-index ``argmax`` at the traceback
start.

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

from dtv_utils_torch.ops.convcode import PUNCTURE_PATTERNS

# DVB-T mother code (EN 300 744 §4.3.3)
DVBT_K, DVBT_G1, DVBT_G2 = 7, 0o171, 0o133
# J.83B trellis component code (SCTE 07 §5.5; tx/j83b.py G1/G2_TAPS)
J83B_K, J83B_G1, J83B_G2 = 5, 0o25, 0o37

# Survivor merge depth for the unpunctured mother code (5·K with a wide
# margin); punctured callers scale it with seam_overlap().
OVERLAP = 96


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


def _acs(pairs: torch.Tensor, k: int, g1: int,
         g2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """pairs float32 [L, B, 2] → (decisions bool [L, B, S], final metrics
    float32 [B, S]).  decisions[t, b, ns] is the reference's ``cand[..., 1]
    > cand[..., 0]``: True when the survivor into ns came from a = 1."""
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


def _traceback(decs: torch.Tensor, final: torch.Tensor,
               k: int) -> torch.Tensor:
    """decisions bool [L, B, S], final metrics [B, S] → decoded bits uint8
    [L, B] (bit t is the encoder input of step t)."""
    L, B, S = decs.shape
    states = torch.empty((L + 1, B, 1), dtype=torch.int64, device=decs.device)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    states[L] = final.argmax(-1, keepdim=True)
    with torch.profiler.record_function("viterbi_traceback"):
        for t in range(L - 1, -1, -1):
            a = torch.gather(decs[t], 1, states[t + 1])        # bool [B, 1]
            torch.bitwise_and(torch.add(a, states[t + 1], alpha=2), S - 1,
                              out=states[t])
    return (states[1:, :, 0] >> (k - 2)).to(torch.uint8)


def viterbi_decode(llr_pairs: torch.Tensor, block: int = 4096,
                   overlap: int = OVERLAP, k: int = DVBT_K,
                   g1: int = DVBT_G1, g2: int = DVBT_G2) -> torch.Tensor:
    """Decode (x, y) LLR pairs [..., n, 2] → input bits uint8 [..., n], on
    the device of the input.

    Leading dimensions are independent streams of equal length, decoded
    in one ACS pass (their blocks side by side); each decodes exactly as
    it would alone.  Every stream is assumed to start from the all-zero
    encoder state.  Punctured callers must pass ``overlap=seam_overlap(k,
    num, den)`` (viterbi_decode_punctured does).
    """
    *lead, n, two = llr_pairs.shape
    if two != 2:
        raise ValueError(f"need (x, y) pairs [..., n, 2], got "
                         f"{tuple(llr_pairs.shape)}")
    if n == 0:
        return torch.zeros((*lead, 0), dtype=torch.uint8,
                           device=llr_pairs.device)
    block = min(block, n)
    nb = -(-n // block)
    L = block + 2 * overlap
    x = llr_pairs.reshape(-1, n, 2).to(torch.float32)
    n_str = x.shape[0]
    # Head pad: strong zero-bit evidence (the encoder starts in state 0 and
    # pre-stream steps emit X=Y=0).  Tail pad: erasures (the final state is
    # the last K-1 data bits, which no tail evidence may contradict).
    ext = F.pad(x, (0, 0, overlap, 0), value=4.0)
    ext = F.pad(ext, (0, 0, 0, nb * block - n + overlap))
    # block b covers stream positions [b·block − overlap, (b+1)·block + overlap)
    blocks = ext.unfold(1, L, block)                         # [str, nb, 2, L]
    pairs = blocks.permute(3, 0, 1, 2).reshape(L, n_str * nb, 2)
    decs, final = _acs(pairs, k, g1, g2)
    bits = _traceback(decs, final, k)                        # [L, str*nb]
    core = bits[overlap:overlap + block].T.reshape(n_str, nb * block)
    return core[:, :n].reshape(*lead, n)


def viterbi_decode_punctured(llr: torch.Tensor, code_rate: tuple[int, int],
                             block: int = 4096) -> torch.Tensor:
    """DVB-T punctured serial LLR stream [n_kept] → decoded input bits
    uint8, with the overlap scaled to the puncture rate."""
    return viterbi_decode(depuncture(llr, code_rate), block=block,
                          overlap=seam_overlap(DVBT_K, *code_rate))
