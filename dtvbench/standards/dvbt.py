"""DVB-T in the benchmark: the program's entries for a configuration
file of standard "dvbt", and the reference beside them.

The program (``dtv_utils_torch``) is imported inside the functions that
call it, so that the reference and the harness's own files load without
it.
"""

from __future__ import annotations

import contextlib

import torch

from dtvbench.reference import dvbt as ref

BLOCK_BYTES = ref.BLOCK_BYTES          # TS bytes per superframe
BLOCK_SAMPLES = ref.BLOCK_SAMPLES      # IQ samples per superframe
HALO_BYTES = ref.HALO_PACKETS * 188    # the previous superframe's tail
SUPPORTED = {"mode": "8K", "constellation": "64-QAM", "code_rate": "7/8",
             "guard": "1/32", "hierarchy": "none"}


def _check(cfg: dict) -> None:
    for k, v in SUPPORTED.items():
        if cfg[k] != v:
            raise ValueError(f"the DVB-T reference has no {k} {cfg[k]!r}")


def port_config(cfg: dict):
    """The program's ``DvbtConfig`` for a configuration file."""
    from dtv_utils_torch.core.config import (CodeRate, Constellation,
                                             DvbtConfig, GuardInterval,
                                             TransmissionMode)
    _check(cfg)
    return DvbtConfig(mode=TransmissionMode.M8K,
                      bandwidth_mhz=cfg["bandwidth_mhz"],
                      constellation=Constellation.QAM64,
                      code_rate=CodeRate.R7_8, guard=GuardInterval.G1_32)


def batched(cfg: dict, device):
    """``fn(ts_blocks uint8 [L, BLOCK_BYTES], prev_tail, start_block)`` →
    IQ complex64 [L, BLOCK_SAMPLES] on the device: the program's batched
    modulator (one captured graph per L)."""
    from dtv_utils_torch.parallel.stream import batched_dvbt_modulator
    return batched_dvbt_modulator(port_config(cfg), device=device)


def reference(ts: torch.Tensor, prev_tail: torch.Tensor | None, block: int,
              precision: str = "float64") -> torch.Tensor:
    """The reference's IQ of superframes block … of a stream that started
    at superframe 0, from the TS bytes and the previous superframe's
    tail."""
    state = (ref.init_state(ts.device) if block == 0
             else ref.state_at(prev_tail, block))
    iq, _ = ref.modulate(ts.reshape(-1), state, precision)
    return iq


def capture(ts: torch.Tensor) -> torch.Tensor:
    """The reference's IQ of a stream that starts with ``ts``."""
    return reference(ts, None, 0)


def demodulator(cfg: dict, device):
    """``fn(iq host complex64)`` → the program's receive result."""
    from dtv_utils_torch.rx import dvbt as rxd
    pc = port_config(cfg)
    return lambda iq: rxd.demodulate_stream(pc, iq, device=device)


def bad_flags(res) -> int:
    """Health flags that are off: undecodable packets, the pilot phase
    sequence, and each TPS frame whose BCH check or fields differ from
    the configuration (EN 300 744 §4.6.2: 64-QAM 2, rate 7/8 4, GI 1/32
    0, 8K 1; frames 1 and 3 of a superframe carry the odd sync word)."""
    bad = int((~res.rs_ok).sum()) + (not res.phase_ok)
    for f, fr in enumerate(res.tps["frames"]):
        want = dict(bch_ok=True, sync="odd" if f % 2 == 0 else "even",
                    frame_number=f % 4, constellation=2, code_rate_hp=4,
                    guard=0, mode=1)
        bad += fr != want
    return bad


def viterbi_work(blocks: int) -> tuple[int, int, int]:
    """(trellis steps, constraint length, LLRs) of decoding ``blocks``
    superframes: one step per bit of RS-coded bytes, 8 kept LLRs per 7
    steps at rate 7/8."""
    steps = blocks * ref.PACKETS * ref.CODED * 8
    return steps, 7, steps * 8 // 7


def rx_work(blocks: int) -> dict:
    """The work of a receive call of ``blocks`` superframes, beside its
    blocks: the Viterbi's trellis (``viterbi_roofline.rx`` reads it)."""
    return {"viterbi": viterbi_work(blocks)}


def rx_info(results) -> dict:
    """Readings logged beside the check: the RS decoder's corrected
    symbols, a mean over the window's calls.  Every receiver whose result
    has ``rs_errors`` (J.83B's too) takes this one."""
    return {"rs_corrected_per_call":
            sum(int(r.rs_errors.sum()) for r in results) / len(results)}


# The stage whose precision the configuration states, "receiver LLRs
# float32": the soft demap's LLRs, held to the reference's demap of the
# same capture as the widest gap over the reference's RMS.
DEMAP_CHECK = "llr_err"


def demap_tap(tap):
    """Keep the LLRs the program's demapper returns (``rx.dvbt.
    coded_llrs``) in the checked calls."""
    from dtv_utils_torch.rx import dvbt as rxd
    return tap.patch(rxd, "coded_llrs")


def demap_reference(iq: torch.Tensor) -> torch.Tensor:
    """The reference's LLRs, in stream order, of a capture."""
    return ref.coded_llrs(iq)


def demap_err(got, want: torch.Tensor, chk: dict) -> float:
    """Widest gap of the program's LLRs from the reference's, over the
    reference's RMS; infinite where the program's are missing or of
    another shape."""
    if got is None or got.shape != want.shape:
        return float("inf")
    rms = want.square().mean().sqrt()
    return float((got.to(want.dtype) - want).abs().max() / rms)


@contextlib.contextmanager
def lower_precision_rx(kind: str):
    """The program's receiver with its soft decisions cut: "bfloat16"
    rounds the demapper's LLRs to bfloat16, "hard" keeps their sign
    only.  For the control runs, never for the benchmark's."""
    from dtv_utils_torch.rx import dvbt as rxd
    orig = rxd.coded_llrs

    def cut(cfg, cells):
        z = orig(cfg, cells)
        if kind == "bfloat16":
            return z.to(torch.bfloat16).to(torch.float32)
        if kind == "hard":
            return torch.sign(z)
        raise ValueError(f"unknown precision {kind!r}")

    rxd.coded_llrs = cut
    try:
        yield
    finally:
        rxd.coded_llrs = orig
