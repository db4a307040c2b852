"""ITU-T J.83 Annex B in the benchmark: the program's entries for a
configuration file of standard "j83b", and the reference beside them.

The program (``dtv_utils_torch``) is imported inside the functions that
call it.
"""

from __future__ import annotations

import contextlib

import torch

from dtvbench.reference import j83b as ref
# The receive result's RS readings are DVB-T's: one function reads both.
from dtvbench.standards.dvbt import rx_info  # noqa: F401

BLOCK_BYTES = ref.BLOCK_BYTES          # TS bytes per superblock
BLOCK_SAMPLES = ref.BLOCK_SAMPLES      # IQ samples per superblock
SUPPORTED = {"constellation": "64-QAM", "interleaver_I": 128,
             "interleaver_J": 4, "symbol_rate": 5056941,
             "rrc_rolloff": 0.18, "interpolation": 2}


def port_config(cfg: dict):
    """The program's ``J83bConfig`` for a configuration file."""
    from dtv_utils_torch.core.config import J83bConfig
    for k, v in SUPPORTED.items():
        if cfg[k] != v:
            raise ValueError(f"the J.83B reference has no {k} {cfg[k]!r}")
    return J83bConfig()


def capture(ts: torch.Tensor) -> torch.Tensor:
    """The reference's IQ of a stream that starts with ``ts``."""
    return ref.modulate(ts.reshape(-1))


def demodulator(cfg: dict, device):
    """``fn(iq host complex64)`` → the program's receive result."""
    from dtv_utils_torch.rx import j83b as rxq
    pc = port_config(cfg)
    return lambda iq: rxq.demodulate_stream(pc, iq, device=device)


def bad_flags(res) -> int:
    """Health flags that are off: codewords that are undecodable or fail
    the extension check, packets whose transport checksum fails, a frame
    trailer that does not match, a control word other than 6 (I = 128,
    J = 4)."""
    return (int((~res.rs_ok).sum()) + int((~res.ext_ok).sum())
            + int((~res.checksum_ok).sum()) + (not res.fsync_ok)
            + (res.control_word != 6))


def viterbi_work(blocks: int) -> tuple[int, int, int]:
    """(trellis steps, constraint length, LLRs) of decoding ``blocks``
    superblocks: per 28-bit trellis group, 4 coded bits in each of the
    two substreams, and 5 kept bits of each."""
    groups = blocks * ref.FR["frames_per_superblock"] * ref.FRAME_BITS \
        // ref.TR["group_bits"]
    return groups * 8, ref.TR["K"], groups * 10


def rx_work(blocks: int) -> dict:
    """The work of a receive call of ``blocks`` superblocks, beside its
    blocks: the Viterbi's trellis (``viterbi_roofline.rx`` reads it)."""
    return {"viterbi": viterbi_work(blocks)}


# The stage whose precision the configuration states, "matched filter
# in float32, TF32 off": the matched filter's output (``F.conv1d`` in
# ``rx.j83b.front``) in the checked calls, held to the reference's
# float64 correlation of the same capture as the widest gap over the
# reference's RMS.
DEMAP_CHECK = "mf_err"


class _Functional:
    """``torch.nn.functional`` as ``rx.j83b`` sees it, with ``conv1d``
    replaced by ``conv1d(conv1d_of_F, *args, **kwargs)``."""

    def __init__(self, F, conv1d):
        self._F, self._conv1d = F, conv1d

    def __getattr__(self, name):
        return getattr(self._F, name)

    def conv1d(self, *args, **kwargs):
        return self._conv1d(self._F.conv1d, *args, **kwargs)


@contextlib.contextmanager
def _functional(conv1d):
    from dtv_utils_torch.rx import j83b as rxq
    orig = rxq.F
    rxq.F = _Functional(orig, conv1d)
    try:
        yield
    finally:
        rxq.F = orig


def demap_tap(tap):
    """Keep the matched filter's output of the program's front end in the
    checked calls."""
    def kept(conv1d, *args, **kwargs):
        out = conv1d(*args, **kwargs)
        if tap.on:
            tap.kept.append(out)
        return out
    return _functional(kept)


def demap_reference(iq: torch.Tensor) -> torch.Tensor:
    """The reference's matched filter output of a capture."""
    return ref.matched_filter(iq)


def demap_err(got, want: torch.Tensor, chk: dict) -> float:
    """Widest gap of the program's matched filter output (rails × 1 ×
    positions) from the reference's, over the reference's RMS; infinite
    where the program's is missing or too short."""
    n = want.shape[0]
    if got is None or got.dim() != 3 or got.shape[:2] != (2, 1) \
            or got.shape[2] < n:
        return float("inf")
    got = got[:, 0, :n].T.to(want.dtype)
    rms = want.square().mean().sqrt()
    return float((got - want).abs().max() / rms)


@contextlib.contextmanager
def lower_precision_rx(kind: str):
    """The program's matched filter one precision lower, "bfloat16": the
    convolution on bfloat16 samples and taps.  For the control runs,
    never for the benchmark's.  (The configuration's TF32 off is no
    control here: cuDNN runs this one-channel filter without TF32 when
    it is allowed, and reads as with it off; PERF.md.)"""
    if kind != "bfloat16":
        raise ValueError(f"unknown precision {kind!r}")

    def bf16(conv1d, x, w, *args, **kwargs):
        return conv1d(x.to(torch.bfloat16), w.to(torch.bfloat16),
                      *args, **kwargs).to(x.dtype)

    with _functional(bf16):
        yield
