#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with an H100 (sm_90a) and the CUDA
toolkit: ``python3 chip_smoke.py``.  It builds the port's CUDA kernels from
``dtv_utils_torch/csrc`` (one ``nvcc`` per source, all started together)
and holds each against its plain PyTorch version, then drives each ported
path on the card at its full size and checks it against a golden made from
the JAX reference:

* J.83B: ``modulate_stream`` and the ``qam-mod`` CLI against
  ``tests/golden/j83b_torch_smoke.json`` (``tests/test_torch_j83b.py``);
* DVB-T 8K 64-QAM 7/8 GI 1/32: ``modulate_stream``, the ``dvbt-mod`` CLI
  and its state save/resume against ``tests/golden/dvbt_torch_smoke.json``
  (``tests/test_torch_dvbt.py``);
* PAPR: the card's report against papr.c's own goldens and against the
  port's CPU report on the DVB-T IQ;
* DVB-T2 BBC 32K (and one tone-reservation frame of the default profile):
  the seeded stand-in tables' digests first, then ``modulate_stream``'s
  grids, state and IQ, and the ``dvbt2-mod`` CLI with ``--tables``, against
  ``tests/golden/dvbt2_torch_smoke.json`` (``tests/test_torch_dvbt2.py``);
* the decoder kernels against their plain versions on the card, bit for
  bit, at full width on the pairs and LLRs the receivers make: the Viterbi
  ACS and traceback (``csrc/viterbi.cu``) at K=7 on the flagship's 2
  superframes at 20.0 dB and at K=5 on J.83B's 2 superblocks at 27 dB
  (packed decisions, final metrics, bits), the min-sum check and variable
  kernels (``csrc/ldpc_minsum.cu``) on one BBC frame's 202 soft FEC blocks
  at 23.0 dB and on pure noise, on blade's 31 coded blocks (a ragged
  slice) and on SHORT 5/6 noise (D = 42): the check state, the messages
  it rebuilds and the totals after the first and the 30th iteration, hard
  bits, ``ok``; the RS kernel (``csrc/rs_decode.cu``) on the codewords
  the DVB-T and J.83B receivers hand it (10,573 x 204 bytes and 22,051 x
  127 words from the noisy captures) and on the same words with 0..2t+4
  symbol errors each: corrected words, n_err and ok; each timed cold and
  warm beside its bound and its plain version, the BBC frame also at 32
  and 64 codewords per slice;
* the DVB-T and J.83B receivers on the IQ above, clean and through AWGN at
  20.0 and 27 dB, with every kernel of the path launched (the counts set
  to 0 before each receiver's run and read after it): the exact input TS
  and every health flag, the card
  against the port's CPU stage by stage (Viterbi, J.83B front and trellis
  decode, RS for both fields), no host sync inside the decoders, and
  ``dvbt-rx`` / ``qam-rx`` against ``demodulate_stream``; one ACS pass
  and RX_DVBT_ACTIVITIES device activities per flagship call (one RS
  kernel launch in its ``rs_decode_kernel`` range), each
  passed stage's peak memory per unit within its size in
  ``utils/device.py``; 24 DVB-T superframes under a 12 GB memory cap,
  equal to the uncapped call;
* the DVB-T2 receiver on the BBC frames above, hard and soft (clean and
  at RX_DVBT2_SNR_DB), and on 2 blade frames soft at 14.5 dB: the exact TS
  with every flag and the signalled L1 fields, the card against the CPU
  (hard words, the min-sum decoder, the syndrome), the min-sum kernels
  launched in the soft runs, no host sync in the
  decoder or the frame decode, and ``dvbt2-rx``;
* batched streaming (``parallel/stream.py``): DVB-T flagship calls of 4
  and 8 superframes, DVB-T2 BBC and J.83B calls of 4 frames / superblocks
  (bench.py's DVB-T2 launch), each from block 0 and as a continuation,
  equal to the serial one-block chain bit for bit with no host sync, one
  FIR launch per J.83B call, and fewer than twice a one-block call's
  device activities; the sharded modulators at world size 1 in an NCCL
  process group equal to the batched ones; ``entry()`` and
  ``dryrun_multichip(1)``;
* the stage profiler (``utils/profile.py``, ``dtv profile``) on every
  chain at full width, TF32 off: each row within 105 % of the H100's
  roofline, with device time when queued behind a spin kernel, the FIR
  kernel launched in every call of the J.83B rows that run it and no
  faster than its own timing, each FULL
  row no faster than the serving profile's device time per block, and
  ``dtv profile -j papr`` as a subprocess; the rate oracles
  (``dvbtrate``, ``dvbs2rate``, ``atsc3rate``) through the port's CLI and
  the native analyzers built by ``analysis/native.py`` (``l1dump``,
  ``flags264``, ``xport``) against ``tests/golden``;
* the captured calls (step 12b, ``utils/graph``): each modulator's
  ``jit_modulator`` (DVB-T flagship, DVB-T2 BBC) and BBC's 4-frame batched
  runner and J.83B's, 8 calls x 4 streams round-robin, equal to the eager
  chain bit for bit (IQ and state) with no host sync, the first call's
  result unchanged after the last, the bounded table caches cleared
  between capture and replay, the FIR launched once per J.83B replay;
  host µs per call, Msamples/s in alternating eager/graph pairs, device
  ms per block, busy share, capture seconds and the graphs' pool; and
  ``jit_decode`` on BBC's 2 frames equal to ``decode``;
* the bench surfaces (step 13, through the graphs): ``bench.bench_j83b``
  in this process, one FIR kernel launch per superblock it launched; ``python -m
  dtv_utils_torch.bench --stress 45``, every one of ``bench.py``'s four
  metrics finite, above real time (above 1 GSa/s for PAPR) and naming
  the card, beside steps 8, 9 and 11's medians of the same shapes; and
  ``python -m dtv_utils_torch.scaling_bench --gpu``'s NCCL row.

The FIR kernel is checked at the main path's size and at edge sizes, on
rows at every 4-byte alignment and in chained calls, and timed cold (L2
holding none of its data) and warm beside its bound, its plain version and
one cuDNN call that computes the same function.  Then the script times
the receivers (DVB-T at 2 and 8 superframes per call, J.83B at 2
superblocks, DVB-T2 BBC at 2 frames hard and soft) and profiles one DVB-T
and one soft DVB-T2 receive call, times the serving shapes
of ``bench.py`` (J.83B, DVB-T, DVB-T2, PAPR) and profiles the J.83B, DVB-T
and DVB-T2 chains, and times batched serving (one stream, L blocks per
call) with each call's device time, activities and peak memory.  Every
check raises on failure, so the exit code is non-zero if any phase fails.
The last two lines of stdout are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  It never imports JAX.

``python3 chip_smoke.py --j83b-ab TREE`` only profiles J.83B, with the
package of TREE (another tree of this repository, e.g. the parent commit
unpacked by ``git archive``) and with this one in turns, and prints the
device time per superblock that this tree saves.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import hashlib
import inspect
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from dtv_utils_torch.ops import _build
from dtv_utils_torch.utils.device import card_line

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "j83b_torch_smoke.json"
DVBT_GOLDEN = ROOT / "tests" / "golden" / "dvbt_torch_smoke.json"
DVBT2_GOLDEN = ROOT / "tests" / "golden" / "dvbt2_torch_smoke.json"
DVBT2_TABLES_GOLDEN = ROOT / "tests" / "golden" / "dvbt2_tables_bbc.txt"
PAPR_GOLDENS = {False: ROOT / "tests" / "golden" / "papr_4096.txt",
                True: ROOT / "tests" / "golden" / "papr_g_4096.txt"}

FIR_TOL = dict(atol=1e-6, rtol=1e-6)   # kernel vs plain: fp32 sums in two orders
IQ_ATOL = 2e-6                          # card IQ vs the JAX reference's on a CPU
FIR_SIZES = (1_806_210, 40_000, 1)      # main-path n, a ragged tile, one cell
FIR_EDGE_SIZES = (48, 49, 1_023, 1_025, 1_000_001, 4_097)
FIR_OFFSETS = (1, 2, 3)                 # floats past a 16-byte boundary
FIR_SETS = 6                            # 6 x 43.35 MB: more than the L2
FIR_TIMED = 24                          # launches per timing
HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
FP32_FLOPS = 67e12                      # fp32 outside the tensor cores
FP32_LANES_PER_SM = 128                 # fp32 instructions per SM and clock
N_STREAMS = 4                           # bench.py's serving shape
TIMED_ROUNDS = 25                       # per repeat; 3 repeats show the spread
DVBT_IQ_REL = 1e-4                      # max|d|/rms, card IQ vs the JAX CPU's
DVBT_FLOOR_MSPS = 8e6 * 8 / 7 / 1e6     # real time for one 8 MHz channel
PROFILE_ROUNDS = 8                      # DVB-T profiler window, 4 streams
PAPR_CHUNK = 1 << 26                    # bench.py's PAPR chunk, complex
PAPR_LEVELS = 13                        # ~ a 12 dB report
J83B_STATE_KEYS = ("ilv_carry", "conv_a", "conv_b", "diff_state")
DVBT_STATE_KEYS = ("packet_phase", "outer_carry", "conv_state")
DVBT2_STATE_KEYS = ("packet_phase", "prev_tail")
DVBT2_IQ_REL = 1e-4                     # max|d|/rms, card IQ vs the JAX CPU's
DVBT2_TIE_REL = 1e-5                    # a TR peak may move only between
#                                         powers this close (FFT rounding)
RX_DVBT_SNR_DB = 20.0                   # README's point for 64-QAM 7/8
RX_J83B_SNR_DB = 27.0                   # the J.83B operating region
RX_NOISE_SEED = 0x5EED                  # host default_rng for the AWGN
RX_VITERBI_BLOCKS = 64                  # card-vs-CPU Viterbi cut, blocks
RX_J83B_GROUPS = 50_000                 # card-vs-CPU J.83B cut, groups
RX_SUPERFRAMES = (2, 8)                 # DVB-T receive calls timed
RX_DVBT_ACTIVITIES = 51                 # device activities, 2-superframe call
RX_REPEATS = 3
RX_CAP_BYTES = 12e9                     # set_per_process_memory_fraction cap
RX_CAP_SUPERFRAMES = (12, 24)           # DVB-T calls decoded under the cap
RX_SLOPE_WORKING_BYTES = 4 << 30        # pinned for the memory slope
RX_DVBT2_SNR_DB = 23.0                  # BBC 256-QAM 2/3 soft: 2 dB of margin
RX_BLADE_SNR_DB = 14.5                  # the reference's 64-QAM 2/3 point
RX_LDPC_BLOCKS = 8                      # card-vs-CPU LDPC cut, FEC blocks
DEC_TIMED = 6                           # decoder-kernel launches per timing
DEC_SETS = 2                            # input sets rotated when cold
DEC_NOISE_SEED = 0xDEC                  # the LDPC's pure-noise LLRs
RS_ERROR_SEED = 0x125                   # the RS kernel's corrupted words
LDPC_ES_N0_DB = 2.5                     # BPSK codewords the decoder corrects
LDPC_ITERATIONS = 30                    # rx.dvbt2's soft decode
SPIN_CYCLES_PER_MS = 2e6                # torch.cuda._sleep, ~2 GHz SM clock
HOST_PROBE_LAUNCHES = 20_000            # tiny launches per host probe
BATCH_DVBT = (4, 8)                     # superframes per batched DVB-T call
BATCH_L = 4                             # T2 frames / superblocks per call
#                                         (bench.py's DVB-T2 launch)
BATCH_ROUNDS = 8                        # timed batched calls per repeat
BATCH_PROFILED = 3                      # profiled batched calls
PROFILE_PAD_CYCLES = 40_000_000         # ~20 ms spin at each profile edge
BATCH_SEED = 0xBA7
BATCH_MAX_GROWTH = 2.0                  # L=4 call's activities < 2x L=1's
PROFILE_CHAINS = ("dvbt", "dvbt2", "dvbt2-bbc", "j83b", "papr")
PROFILE_MAX_PCT = 105.0                 # of the roofline: more is a bad model
PROFILE_FIR_FLOOR = 0.9                 # rrc_interpolate row / step 3's warm
PROFILE_FULL_FLOOR = 0.95               # FULL row / steps 8-9's busy ms
PROFILE_QUEUED = 3                      # calls queued for a row's device ms
PROFILE_FIR_ROWS = ("rrc_interpolate", "FULL superblock")
GRAPH_CALLS = 8                         # graphs step: calls per stream
GRAPH_SEED = 0x6A4
GRAPH_QUEUED = 6                        # calls queued for device ms (116
#                                         J.83B launches each: the queue
#                                         holds ~1000)
GRAPH_JUNK = 4                          # tensors per size after eviction
GRAPH_KERNELS = ("fir_interp2", "ldpc_check", "ldpc_variable")  # in graphs
BENCH_J83B_S = 10.0                     # in-process bench_j83b's deadline
BENCH_STRESS_S = 45.0                   # bench --stress budget per metric
RATE_CASES = (
    [(["dvbtrate", str(bw)], f"dvbtrate_{bw}.txt") for bw in (5, 6, 7, 8)]
    + [(["dvbs2rate", *([] if o == "n" else ["-" + o]), r],
        f"dvbs2rate_{o}_{r}.txt")
       for o, r in (("n", "27500000"), ("s", "27500000"), ("x", "27500000"),
                    ("sx", "27500000"), ("v", "27500000"),
                    ("n", "31415926.5"), ("sx", "1000000"))]
    + [(["atsc3rate", *a.split()], "atsc3rate_" + a.replace(" ", "_")
        + ".txt")
       for a in ("32 5 72 2 8 2 0 6 1 1 1 0 4 0",
                 "8 3 100 1 10 3 0 0 0 2 3 2 2 1",
                 "16 9 120 2 6 1 1 4 1 1 2 4 0 0 150",
                 "32 10 60 1 2 0 0 8 1 5 7 3 1 0 10")])


def seeded_ts(seed: int, n_bytes: int) -> np.ndarray:
    """Pseudo-random TS bytes with a 0x47 sync byte every 188, from a
    splitmix64 hash of the byte index: the same bytes on any NumPy version
    (a Generator's stream may change between releases)."""
    x = np.arange(n_bytes, dtype=np.uint64) + np.uint64(
        seed * 0x9E3779B97F4A7C15 % 2**64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    ts = (x >> np.uint64(56)).astype(np.uint8)
    ts[::188] = 0x47
    return ts


def sha256(*arrays: np.ndarray) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def state_digest(d: dict, keys=J83B_STATE_KEYS) -> str:
    """sha256 of a chain state's integer fields, from host arrays."""
    return sha256(*(np.asarray(d[k]) for k in keys))


def dvbt_flagship():
    """DVB-T 8K 64-QAM 7/8 GI 1/32, 8 MHz: bench.py's headline config."""
    from dtv_utils_torch.core.config import (CodeRate, Constellation,
                                             DvbtConfig, GuardInterval,
                                             TransmissionMode)
    return DvbtConfig(mode=TransmissionMode.M8K, bandwidth_mhz=8,
                      constellation=Constellation.QAM64,
                      code_rate=CodeRate.R7_8, guard=GuardInterval.G1_32)


def dvbt2_bbc():
    """DVB-T2 BBC 32K profile (``dvbt2-mod --profile bbc``): bench.py's
    ``dvbt2_32k_bbc_iq_throughput`` config, full width and depth."""
    from dtv_utils_torch.models.dvbt2 import PROFILES
    return PROFILES["bbc"]


def dvbt2_papr():
    """The default (blade) profile with tone reservation (``--papr``)."""
    from dtv_utils_torch.models.dvbt2 import PROFILES
    return dataclasses.replace(PROFILES["blade"], papr_tr=True)


def dvbt2_standin_digests(T, bbc, papr) -> dict[str, str]:
    """sha256 of every seeded stand-in table the two DVB-T2 configs use,
    from ``T``, the ``dvbt2_tables`` module of either package.  They come
    from ``numpy.random.default_rng``, whose stream NumPy does not promise
    to keep across releases."""
    def rows(*key):
        r = T.ldpc_accumulator_rows(*key)
        return sha256(np.asarray([len(x) for x in r], np.int64),
                      np.concatenate([np.asarray(x, np.int64) for x in r]))
    fb, fp = T.frame_plan(bbc), T.frame_plan(papr)
    return {
        "ldpc_64800_2_3": rows(bbc.code_rate.value, bbc.nldpc, bbc.nbch),
        "ldpc_16200_l1_pre": rows(0, 16200, T.L1PRE_NBCH),
        "ldpc_16200_l1_post": rows(1, 16200, T.L1POST_NBCH),
        "cp_set_32768": sha256(fb["cp_set"]),
        "tr_p2_32768": sha256(fb["tr_p2"]),
        "cp_set_4096": sha256(fp["cp_set"]),
        "tr_p2_4096": sha256(fp["tr_p2"]),
        "tr_data_4096": sha256(fp["tr_data"]),
        "cell_perm_8100": sha256(
            T.cell_interleaver_perm(bbc.cells_per_fec_block)),
        "cell_perm_10800": sha256(
            T.cell_interleaver_perm(papr.cells_per_fec_block)),
        "freq_perms_32768": sha256(*T.freq_interleaver_perms(bbc)),
        "freq_perms_4096": sha256(*T.freq_interleaver_perms(papr)),
    }


def papr_fixture() -> np.ndarray:
    """The input papr.c's goldens were made from: 4096 complex samples."""
    rng = np.random.default_rng(1234)
    return (rng.standard_normal(8192) * 0.25).astype(np.float32)


def _fir_case(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.testing.assert_close(got, want, **FIR_TOL)
    err = (got - want).abs().max().item() if got.numel() else 0.0
    print(f"fir {label}: max|d|={err:.3e}")
    return err


def _misaligned_rows(g, dev, n: int, off: int) -> torch.Tensor:
    """[2, n] rows ``off`` floats into a buffer whose row stride is a
    multiple of 4 floats, so that no row starts 16-byte aligned."""
    buf = torch.randn(2, (n + off + 3) // 4 * 4, generator=g, device=dev)
    return buf[:, off:off + n]


def check_fir(dev, taps) -> float:
    """Kernel against the plain version on the card; returns max |Δ|.
    Sizes: the main path's, a ragged tile, one cell, a batched J.83B call's
    (BATCH_L superblocks in one launch), history-only windows (n <= 49),
    tile edges and an odd n (output row 1 only 8-byte aligned);
    the split entry on rows that start 1, 2 or 3 floats past a 16-byte
    boundary; chained calls with the 49-sample history carried."""
    from dtv_utils_torch.ops import fir
    from dtv_utils_torch.tx import j83b as txq

    g = torch.Generator(device=dev).manual_seed(83)
    worst = 0.0
    for n in FIR_SIZES + (BATCH_L * FIR_SIZES[0],) + FIR_EDGE_SIZES:
        x = torch.randn(2, fir.HIST + n, generator=g, device=dev)
        worst = max(worst, _fir_case(
            f"n={n}", fir.polyphase_interp2(x, taps, n),
            fir.interp2_reference(x, taps, n)))
    for n in (FIR_SIZES[0], FIR_EDGE_SIZES[-1]):
        for off in FIR_OFFSETS:
            tail = _misaligned_rows(g, dev, fir.HIST, off)
            cells = _misaligned_rows(g, dev, n, off)
            worst = max(worst, _fir_case(
                f"split n={n}, rows {off} floats past 16 bytes",
                fir.polyphase_interp2_split(tail, cells, taps),
                fir.interp2_reference(torch.cat([tail, cells], dim=1), taps,
                                      n)))
    # two chained calls carrying the 49-sample tail == one call on the whole
    n1, n2 = 40_000, 33_333
    cells = torch.randn(2, n1 + n2, generator=g, device=dev)
    tail = torch.zeros(2, fir.HIST, device=dev)
    ext1 = torch.cat([tail, cells[:, :n1]], dim=1)
    out1 = fir.polyphase_interp2(ext1, taps, n1)
    ext2 = torch.cat([ext1[:, -fir.HIST:], cells[:, n1:]], dim=1)
    out2 = fir.polyphase_interp2(ext2, taps, n2)
    want = fir.interp2_reference(torch.cat([tail, cells], dim=1), taps,
                                 n1 + n2)
    worst = max(worst, _fir_case(f"chained {n1}+{n2}",
                                 torch.cat([out1, out2], dim=1), want))
    # the stream's own chaining (split entry), with a piece shorter than 49
    for pieces in ((20, 40_000), (40_000, 20, 7, 33_333)):
        cells = torch.randn(2, sum(pieces), generator=g, device=dev)
        tail = torch.randn(2, fir.HIST, generator=g, device=dev)
        want = fir.interp2_reference(torch.cat([tail, cells], dim=1), taps,
                                     sum(pieces))
        outs, t, at = [], tail, 0
        for p in pieces:
            out, t = txq.rrc_interpolate(cells[:, at:at + p], t, taps)
            outs.append(out)
            at += p
        if not torch.equal(t, cells[:, -fir.HIST:]):
            raise AssertionError("rrc_interpolate's history is not the last "
                                 f"{fir.HIST} cells")
        worst = max(worst, _fir_case(
            "rrc_interpolate chained " + "+".join(map(str, pieces)),
            torch.cat(outs, dim=1), want))
    return worst


def library_interp2(ext: torch.Tensor, w: torch.Tensor,
                    n: int) -> torch.Tensor:
    """The FIR as one PyTorch call, a yardstick for the kernel's time: a
    stride-2 transposed convolution with all 100 taps ``w [1, 1, 100]``
    (cuDNN on the card) interpolates by 2; output 98 + 2m + p is the
    kernel's out[:, 2m + p].  The port never calls it."""
    return F.conv_transpose1d(ext[:, None], w, stride=2)[:, 0, 98:98 + 2 * n]


def fir_bounds_ms(n: int) -> tuple[float, float]:
    """Least time for the FIR on an H100 SXM: (bytes, each input read and
    each output written once, over 3.35 TB/s; FP32 FLOPs over 67 TFLOP/s)."""
    nbytes = 4 * (2 * (49 + n) + 2 * 2 * n)
    flops = 2 * (2 * 2 * n * 50)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3


def _queued_ms(calls) -> float:
    """Mean device ms per call of ``calls``, launched back to back behind a
    spin kernel long enough for the host to queue them all, so that no host
    gap enters the window.  Each call is made once untimed first; the spin
    starts at 1.5 times the host time of that round, or ~20 ms."""
    t0 = time.perf_counter()
    for c in calls:
        c()
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = max(40_000_000, int(1.5 * warm_ms * SPIN_CYCLES_PER_MS))
    for attempt in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(spin)
        ev[1].record()
        t0 = time.perf_counter()
        for c in calls:
            c()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * ev[0].elapsed_time(ev[1]):
            break
        spin *= 4                                   # the host fell behind
    else:
        print(f"note: the host took {host_ms:.3f} ms to queue {len(calls)} "
              "calls, longer than the spin: this time includes host gaps")
    return ev[1].elapsed_time(ev[2]) / len(calls)


def time_fir(dev, taps) -> dict[str, float]:
    """Device ms per call at the main-path size for the kernel, the plain
    version and the one-call yardstick, each cold (FIR_TIMED launches over
    FIR_SETS distinct input and output sets, ~260 MB, so the 50 MB L2
    holds none of a launch's data) and warm (the same set every launch), in
    turns: library, plain, kernel, kernel, plain, library."""
    from dtv_utils_torch.ops import fir

    n = FIR_SIZES[0]
    g = torch.Generator(device=dev).manual_seed(84)
    exts = [torch.randn(2, fir.HIST + n, generator=g, device=dev)
            for _ in range(FIR_SETS)]
    outs = [torch.empty(2, 2 * n, device=dev) for _ in range(FIR_SETS)]
    ph = fir._phase_taps(np.asarray(taps, np.float32).tobytes())
    w = torch.from_numpy(np.array(taps, np.float32)).to(dev)[None, None]
    fns = {
        "kernel": lambda k: fir._launch(exts[k][:, :fir.HIST],
                                        exts[k][:, fir.HIST:], outs[k], ph),
        "plain": lambda k: fir.interp2_reference(exts[k], taps, n),
        "library": lambda k: library_interp2(exts[k], w, n),
    }
    runs: dict[str, list[float]] = {}
    for side in ("library", "plain", "kernel", "kernel", "plain", "library"):
        f = fns[side]
        for temp, sets in (("cold", range(FIR_SETS)), ("warm", [0])):
            calls = [functools.partial(f, sets[i % len(sets)])
                     for i in range(FIR_TIMED)]
            runs.setdefault(f"{side}_{temp}", []).append(_queued_ms(calls))
    print("fir timings (ms, two turns each): " + ", ".join(
        f"{k} {v[0]:.5f}/{v[1]:.5f}" for k, v in runs.items()))
    return {k: sum(v) / len(v) for k, v in runs.items()}


def check_slice(dev, golden: dict) -> tuple[int, np.ndarray]:
    """modulate_stream over the golden's superblocks, checked against the
    golden; returns the FIR kernel launches it made and its IQ."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.tx import j83b as txq

    cfg = J83bConfig()
    n_sb = golden["superblocks"]
    ts = seeded_ts(golden["seed"], n_sb * txq.SUPERBLOCK_BYTES)
    if sha256(ts) != golden["ts_sha256"]:
        raise AssertionError("seeded_ts no longer makes the golden's input")

    _build.LAUNCHES["fir_interp2"] = 0
    iq, state = txq.modulate_stream(cfg, ts, device=dev)
    launches = _build.LAUNCHES["fir_interp2"]
    print(f"modulate_stream: {n_sb} superblocks, {launches} FIR launches")

    want_len = n_sb * 2 * txq.SUPERBLOCK_SYMBOLS
    if iq.shape != (want_len,) or iq.dtype != np.complex64:
        raise AssertionError(f"IQ {iq.dtype} {iq.shape}, want complex64 "
                             f"({want_len},)")
    if not np.isfinite(iq.view(np.float32)).all():
        raise AssertionError("non-finite IQ")
    idx = np.asarray(golden["iq_index"])
    want = (np.asarray(golden["iq_re"], np.float32)
            + 1j * np.asarray(golden["iq_im"], np.float32))
    err = np.abs(iq[idx] - want).max()
    print(f"IQ at {idx.size} golden indices: max|d|={err:.3e}")
    np.testing.assert_allclose(iq[idx], want, rtol=0, atol=IQ_ATOL)
    if state_digest(txq.state_to_numpy(state)) != golden["state_sha256"]:
        raise AssertionError("final state differs from the golden")

    st = txq.init_state(cfg, device=dev)
    blk = txq.SUPERBLOCK_BYTES
    for i in range(n_sb):
        block = torch.from_numpy(ts[i * blk:(i + 1) * blk]).to(dev)
        cells, st = txq.encode_to_cells(cfg, block, st)
        if sha256(cells.cpu().numpy()) != golden["cells_sha256"][i]:
            raise AssertionError(f"superblock {i}: cells differ from golden")
    print("cells sha256 and state digest match the golden")
    return launches, iq


def check_dvbt_slice(dev, golden: dict) -> tuple[np.ndarray, float]:
    """DVB-T ``modulate_stream`` over the golden's superframes on ``dev``:
    carriers' sha256 per superframe and the state digest equal the golden,
    IQ at the golden's indices within DVBT_IQ_REL.  Returns the IQ and its
    max|d|/rms."""
    from dtv_utils_torch.tx import dvbt as txd

    cfg = dvbt_flagship()
    n_sf = golden["superframes"]
    blk = cfg.ts_bytes_per_superframe
    ts = seeded_ts(golden["seed"], n_sf * blk)
    if sha256(ts) != golden["ts_sha256"]:
        raise AssertionError("seeded_ts no longer makes the DVB-T input")

    iq, state = txd.modulate_stream(cfg, ts, device=dev)
    want_len = n_sf * cfg.samples_per_superframe
    if iq.shape != (want_len,) or iq.dtype != np.complex64:
        raise AssertionError(f"IQ {iq.dtype} {iq.shape}, want complex64 "
                             f"({want_len},)")
    if not np.isfinite(iq.view(np.float32)).all():
        raise AssertionError("non-finite IQ")
    idx = np.asarray(golden["iq_index"])
    want = (np.asarray(golden["iq_re"], np.float32)
            + 1j * np.asarray(golden["iq_im"], np.float32))
    rel = float(np.abs(iq[idx] - want).max() / golden["iq_rms"])
    print(f"dvbt modulate_stream: {n_sf} superframes; IQ at {idx.size} "
          f"golden indices: max|d|/rms={rel:.3e} (bound {DVBT_IQ_REL:g})")
    if not rel < DVBT_IQ_REL:
        raise AssertionError(f"DVB-T IQ max|d|/rms {rel:.3e} >= "
                             f"{DVBT_IQ_REL:g}")
    if state_digest(txd.state_to_numpy(state),
                    DVBT_STATE_KEYS) != golden["state_sha256"]:
        raise AssertionError("DVB-T final state differs from the golden")

    st = txd.init_state(cfg, device=dev)
    for i in range(n_sf):
        block = torch.from_numpy(ts[i * blk:(i + 1) * blk]).to(dev)
        carriers, st = txd.encode_to_carriers(cfg, block, st)
        got = torch.view_as_real(carriers).cpu().numpy()
        if sha256(got) != golden["carriers_sha256"][i]:
            raise AssertionError(f"superframe {i}: carriers differ from "
                                 "golden")
    print("dvbt carriers sha256 and state digest match the golden")

    if dev.type == "cuda":          # a warm superframe may not sync
        torch.cuda.set_sync_debug_mode("error")
        try:
            txd.modulate_superframe(cfg, block, st)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print("dvbt modulate_superframe ran with no host sync")
    return iq, rel


def time_dvbt2_plan(dev) -> tuple[float, float]:
    """Seconds to build the BBC host tables (cold, in this process) and to
    upload them to ``dev``."""
    from dtv_utils_torch.tx import dvbt2 as t2

    cfg = dvbt2_bbc()
    t0 = time.perf_counter()
    t2._plan(cfg)
    t2._frame_arrays(cfg)
    t1 = time.perf_counter()
    t2._device_plan(cfg, dev)
    t2._device_frame(cfg, dev, "src_fused")
    t2._device_back(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1


def check_dvbt2_tables(golden: dict) -> None:
    """The port's seeded stand-in tables equal the JAX reference's, checked
    before anything is modulated so that a changed NumPy stream is named
    as such, not found as a grid mismatch."""
    from dtv_utils_torch.tx import dvbt2_tables as T

    got = dvbt2_standin_digests(T, dvbt2_bbc(), dvbt2_papr())
    bad = sorted(k for k, v in golden["standins"].items() if got.get(k) != v)
    if bad or got.keys() != golden["standins"].keys():
        raise AssertionError(
            f"DVB-T2 stand-in tables differ from the JAX reference's: {bad} "
            f"(numpy {np.__version__}; a Generator's stream may have changed)")
    print(f"dvbt2 stand-in tables: {len(got)} digests equal the golden's "
          f"(numpy {np.__version__})")


def _dvbt2_grid(cfg, block: torch.Tensor, state):
    """The carrier grid of one frame, through the stage functions."""
    from dtv_utils_torch.tx import dvbt2 as t2

    bb, state = t2.mode_adapt(cfg, block, state)
    cells = t2.interleave_and_map(cfg, t2.fec_encode(cfg, bb))
    return t2.build_frame_grid_fused(cfg, cells), state


def _golden_iq(g: dict) -> tuple[np.ndarray, np.ndarray]:
    return np.asarray(g["iq_index"]), (
        np.asarray(g["iq_re"], np.float32)
        + 1j * np.asarray(g["iq_im"], np.float32))


def check_dvbt2_slice(dev, golden: dict) -> tuple[np.ndarray, float]:
    """DVB-T2 BBC ``modulate_stream`` over the golden's frames on ``dev``:
    each frame's grid sha256 and the final state digest equal the golden,
    IQ at the golden's indices within DVBT2_IQ_REL, and a warm frame makes
    no host sync.  Returns the IQ and its max|d|/rms."""
    from dtv_utils_torch.tx import dvbt2 as t2

    cfg = dvbt2_bbc()
    n_fr = golden["frames"]
    blk = cfg.payload_bytes_per_frame
    ts = seeded_ts(golden["seed"], n_fr * blk)
    if sha256(ts) != golden["ts_sha256"]:
        raise AssertionError("seeded_ts no longer makes the DVB-T2 input")

    iq, state = t2.modulate_stream(cfg, ts, device=dev)
    want_len = n_fr * t2.samples_per_frame(cfg)
    if iq.shape != (want_len,) or iq.dtype != np.complex64:
        raise AssertionError(f"IQ {iq.dtype} {iq.shape}, want complex64 "
                             f"({want_len},)")
    if not np.isfinite(iq.view(np.float32)).all():
        raise AssertionError("non-finite IQ")
    idx, want = _golden_iq(golden)
    rel = float(np.abs(iq[idx] - want).max() / golden["iq_rms"])
    print(f"dvbt2 bbc modulate_stream: {n_fr} frames; IQ at {idx.size} "
          f"golden indices: max|d|/rms={rel:.3e} (bound {DVBT2_IQ_REL:g})")
    if not rel < DVBT2_IQ_REL:
        raise AssertionError(f"DVB-T2 IQ max|d|/rms {rel:.3e} >= "
                             f"{DVBT2_IQ_REL:g}")
    if state_digest(t2.state_to_numpy(state),
                    DVBT2_STATE_KEYS) != golden["state_sha256"]:
        raise AssertionError("DVB-T2 final state differs from the golden")

    st = t2.init_state(cfg, device=dev)
    for i in range(n_fr):
        block = torch.from_numpy(ts[i * blk:(i + 1) * blk]).to(dev)
        grid, st = _dvbt2_grid(cfg, block, st)
        if sha256(torch.view_as_real(grid).cpu().numpy()) \
                != golden["grid_sha256"][i]:
            raise AssertionError(f"DVB-T2 frame {i}: grid differs from "
                                 "golden")
    print("dvbt2 grid sha256 per frame and state digest match the golden")

    if dev.type == "cuda":          # a warm frame may not sync
        torch.cuda.set_sync_debug_mode("error")
        try:
            t2.modulate_frame(cfg, block, st)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print("dvbt2 modulate_frame ran with no host sync")
    return iq, rel


def check_dvbt2_papr(dev, golden: dict) -> float:
    """One frame of the default profile with tone reservation: the grid is
    bit-exact; the peak each TR iteration picks per symbol is the
    reference's, except where two powers tie within DVBT2_TIE_REL (printed
    with both indices and powers; those symbols leave the IQ check); the
    other symbols' IQ within DVBT2_IQ_REL.  Returns that max|d|/rms."""
    from dtv_utils_torch.tx import dvbt2 as t2

    g = golden["papr"]
    cfg = dvbt2_papr()
    ts = seeded_ts(g["seed"], cfg.payload_bytes_per_frame)
    if sha256(ts) != g["ts_sha256"]:
        raise AssertionError("seeded_ts no longer makes the TR input")
    iq, _ = t2.modulate_stream(cfg, ts, device=dev)
    grid, _ = _dvbt2_grid(cfg, torch.from_numpy(ts).to(dev),
                          t2.init_state(cfg, device=dev))
    if sha256(torch.view_as_real(grid).cpu().numpy()) != g["grid_sha256"]:
        raise AssertionError("DVB-T2 tone-reservation frame: grid differs "
                             "from golden")
    x = t2.time_symbols(cfg, grid)
    flipped: dict[int, int] = {}
    for it, want_m in enumerate(g["tr_peaks"]):
        power = (x.real * x.real + x.imag * x.imag).cpu().numpy()
        x, m = t2._tr_step(cfg, x)
        for sym in np.nonzero(m.cpu().numpy() != np.asarray(want_m))[0]:
            if sym in flipped:
                continue
            a, b = int(want_m[sym]), int(m[sym])
            pa, pb = float(power[sym, a]), float(power[sym, b])
            print(f"dvbt2 tone reservation flip: symbol {sym}, iteration "
                  f"{it}: reference peak {a} (|x|^2 {pa:.9g} here), this "
                  f"run's peak {b} (|x|^2 {pb:.9g})")
            if abs(pb - pa) > DVBT2_TIE_REL * pb:
                raise AssertionError("a TR peak moved between powers that "
                                     "do not tie")
            flipped[int(sym)] = it
    idx, want = _golden_iq(g)
    sym_of = (idx - 2048) // (cfg.fft_size + cfg.guard_samples)
    keep = ~np.isin(sym_of, list(flipped))
    rel = float(np.abs(iq[idx[keep]] - want[keep]).max() / g["iq_rms"])
    print(f"dvbt2 tone reservation (blade, 1 frame): grid equals the "
          f"golden; {len(flipped)} peak flips; IQ at {keep.sum()} of "
          f"{idx.size} golden indices: max|d|/rms={rel:.3e} (bound "
          f"{DVBT2_IQ_REL:g})")
    if not rel < DVBT2_IQ_REL:
        raise AssertionError(f"DVB-T2 TR IQ max|d|/rms {rel:.3e} >= "
                             f"{DVBT2_IQ_REL:g}")
    return rel


def check_dvbt2_cli(golden: dict, iq: np.ndarray, device: str) -> None:
    """``dvbt2-mod --profile bbc`` writes exactly ``iq``; ``--tables``
    prints the JAX CLI's report and exits 3 (stand-ins active)."""
    cfg = dvbt2_bbc()
    ts = seeded_ts(golden["seed"],
                   golden["frames"] * cfg.payload_bytes_per_frame)
    cmd = [sys.executable, "-m", "dtv_utils_torch.cli", "dvbt2-mod",
           "--profile", "bbc"]
    with tempfile.TemporaryDirectory() as d:
        src, dst = Path(d, "in.ts"), Path(d, "out.cfile")
        ts.tofile(src)
        subprocess.run([*cmd, "-n", str(golden["frames"]), str(src),
                        str(dst), "--device", device], cwd=ROOT, check=True,
                       timeout=300, stdout=subprocess.DEVNULL)
        if dst.read_bytes() != iq.tobytes():
            raise AssertionError("dvbt2-mod output differs from "
                                 "modulate_stream")
    res = subprocess.run([*cmd, "--tables"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    if res.returncode != 3 or res.stdout != DVBT2_TABLES_GOLDEN.read_text():
        raise AssertionError(f"dvbt2-mod --tables: exit {res.returncode}, "
                             "or its report differs from the JAX CLI's")
    print("dvbt2-mod output equals modulate_stream's; --tables equals the "
          "JAX CLI's report and exits 3")


def _dvbt_mod(args: list[str], device: str) -> None:
    subprocess.run([sys.executable, "-m", "dtv_utils_torch.cli", "dvbt-mod",
                    *args, "--device", device],
                   cwd=ROOT, check=True, timeout=300, stdout=subprocess.DEVNULL)


def check_dvbt_cli(golden: dict, iq: np.ndarray, device: str) -> None:
    """``dvbt-mod`` writes exactly ``iq``, and a ``--save-state`` /
    ``--load-state`` split run writes the same bytes as one run."""
    cfg = dvbt_flagship()
    blk = cfg.ts_bytes_per_superframe
    ts = seeded_ts(golden["seed"], golden["superframes"] * blk)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        ts.tofile(d / "in.ts")
        ts[blk:].tofile(d / "rest.ts")
        _dvbt_mod(["-o", str(d / "one.cfile"), str(d / "in.ts")], device)
        _dvbt_mod(["-n", "1", "--save-state", str(d / "s.npz"),
                   "-o", str(d / "a.cfile"), str(d / "in.ts")], device)
        _dvbt_mod(["-n", str(golden["superframes"] - 1), "--load-state",
                   str(d / "s.npz"), "-o", str(d / "b.cfile"),
                   str(d / "rest.ts")], device)
        one = (d / "one.cfile").read_bytes()
        split = (d / "a.cfile").read_bytes() + (d / "b.cfile").read_bytes()
    if one != iq.tobytes():
        raise AssertionError("dvbt-mod output differs from modulate_stream")
    if split != one:
        raise AssertionError("dvbt-mod split at a saved state differs from "
                             "the one-shot run")
    print("dvbt-mod output equals modulate_stream's; the save/load-state "
          "split run equals the one-shot run")


def check_papr(dev, golden: dict, iq: np.ndarray) -> None:
    """The card's PAPR report equals papr.c's goldens on their input, and
    the port's CPU report on the DVB-T IQ, byte for byte."""
    from dtv_utils_torch.analysis import papr

    x = papr_fixture()
    if sha256(x) != golden["papr_input_sha256"]:
        raise AssertionError("numpy.random.default_rng(1234) no longer makes "
                             "the PAPR goldens' input; the comparison with "
                             "papr.c's reports would be void")
    with tempfile.TemporaryDirectory() as d:
        small, big = Path(d, "small.cfile"), Path(d, "dvbt.cfile")
        x.tofile(small)
        iq.astype(np.complex64).tofile(big)
        for graph, path in PAPR_GOLDENS.items():
            if papr.report(str(small), graph, device=dev) != path.read_text():
                raise AssertionError(f"PAPR report differs from {path.name}")
            got = papr.report(str(big), graph, device=dev)
            if got != papr.report(str(big), graph, device="cpu"):
                raise AssertionError(f"PAPR report (graph={graph}) on the "
                                     "DVB-T IQ differs between card and CPU")
    print("papr: reports equal papr.c's goldens and the CPU's on the "
          "DVB-T IQ")


def check_cli(golden: dict, iq: np.ndarray, device: str) -> None:
    """``python -m dtv_utils_torch.cli qam-mod`` writes the same IQ."""
    from dtv_utils_torch.tx import j83b as txq

    ts = seeded_ts(golden["seed"],
                   golden["superblocks"] * txq.SUPERBLOCK_BYTES)
    with tempfile.TemporaryDirectory() as d:
        src, dst = Path(d, "in.ts"), Path(d, "out.cfile")
        ts.tofile(src)
        subprocess.run([sys.executable, "-m", "dtv_utils_torch.cli",
                        "qam-mod", str(src), str(dst), "--device", device],
                       cwd=ROOT, check=True, timeout=300)
        got = np.fromfile(dst, dtype=np.complex64)
    if not np.array_equal(got, iq):
        raise AssertionError("qam-mod CLI output differs from modulate_stream")
    print("qam-mod CLI output equals modulate_stream's")


def awgn(iq: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    """``iq`` plus complex white Gaussian noise at ``snr_db`` below its
    mean power, drawn on the host from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    p = np.mean(np.abs(iq) ** 2) / 10 ** (snr_db / 10)
    noise = (rng.normal(0, np.sqrt(p / 2), len(iq))
             + 1j * rng.normal(0, np.sqrt(p / 2), len(iq)))
    return (iq + noise.astype(np.complex64)).astype(np.complex64)


def _expect_ts(label: str, got: np.ndarray, ts: np.ndarray,
               n_pkts: int) -> None:
    if len(got) != n_pkts * 188 or not np.array_equal(got, ts[:len(got)]):
        raise AssertionError(f"{label}: recovered TS ({len(got)} bytes) is "
                             f"not the first {n_pkts} input packets")


def check_dvbt_rx(dev, golden: dict, iq: np.ndarray):
    """The flagship's 2 superframes back through ``rx.dvbt`` on ``dev``,
    clean and at RX_DVBT_SNR_DB: the exact TS, every packet decodable; clean,
    no corrected byte, pilot phases in order and every TPS frame's BCH and
    fields equal to the config.  Returns the clean result and the noisy IQ."""
    from dtv_utils_torch.rx import dvbt as rxd
    from dtv_utils_torch.tx.dvbt import OUTER_I, OUTER_M

    cfg = dvbt_flagship()
    ts = seeded_ts(golden["seed"],
                   golden["superframes"] * cfg.ts_bytes_per_superframe)
    n_pkts = ((golden["superframes"] * cfg.rs_blocks_per_superframe * 204
               - OUTER_I * OUTER_M * (OUTER_I - 1)) // 204)
    res = rxd.demodulate_stream(cfg, torch.from_numpy(iq).to(dev),
                                device=dev)
    _expect_ts("dvbt rx clean", res.ts, ts, n_pkts)
    if not (res.rs_ok.all() and res.rs_errors.sum() == 0 and res.phase_ok
            and res.tps["all_bch_ok"]):
        raise AssertionError("dvbt rx clean: an RS, phase or TPS flag is off")
    # EN 300 744 §4.6.2: 64-QAM = 2, rate 7/8 = 4, GI 1/32 = 0, 8K = 1;
    # frames 1 and 3 of a superframe carry the odd sync word
    for f, fr in enumerate(res.tps["frames"]):
        want = dict(bch_ok=True, sync="odd" if f % 2 == 0 else "even",
                    frame_number=f % 4, constellation=2, code_rate_hp=4,
                    guard=0, mode=1)
        if fr != want:
            raise AssertionError(f"dvbt rx TPS frame {f}: {fr} != {want}")
    print(f"dvbt rx clean ({golden['superframes']} superframes): TS exact, "
          f"{n_pkts} packets, 0 corrected bytes, phases in order, "
          f"{len(res.tps['frames'])} TPS frames equal the config")
    noisy = awgn(iq, RX_DVBT_SNR_DB, RX_NOISE_SEED)
    res_n = rxd.demodulate_stream(cfg, noisy, device=dev)
    _expect_ts(f"dvbt rx at {RX_DVBT_SNR_DB} dB", res_n.ts, ts, n_pkts)
    if not res_n.rs_ok.all():
        raise AssertionError(f"dvbt rx at {RX_DVBT_SNR_DB} dB: "
                             f"{(~res_n.rs_ok).sum()} packets uncorrectable")
    print(f"dvbt rx at {RX_DVBT_SNR_DB} dB SNR: TS exact, every packet "
          f"decodable; RS corrected {int(res_n.rs_errors.sum())} bytes "
          f"(at most {int(res_n.rs_errors.max())} in a packet of 204)")
    return res, noisy


def check_j83b_rx(dev, golden: dict, iq: np.ndarray):
    """The J.83B slice's 2 superblocks (out of the FIR kernel) back through
    ``rx.j83b`` on ``dev``: clean, the exact TS and every flag; at
    RX_J83B_SNR_DB, the exact TS, RS and checksums.  Returns the clean
    result and the noisy IQ."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.rx import j83b as rxq
    from dtv_utils_torch.tx import j83b as txq

    cfg = J83bConfig()
    ts = seeded_ts(golden["seed"],
                   golden["superblocks"] * txq.SUPERBLOCK_BYTES)
    res = rxq.demodulate_stream(cfg, torch.from_numpy(iq).to(dev),
                                device=dev)
    n_pkts = len(res.ts) // 188
    _expect_ts("j83b rx clean", res.ts, ts, n_pkts)
    if not (n_pkts > 0 and res.fsync_ok and res.control_word == 6
            and res.rs_ok.all() and res.ext_ok.all()
            and res.checksum_ok.all() and res.rs_errors.sum() == 0):
        raise AssertionError("j83b rx clean: a flag is off")
    print(f"j83b rx clean ({golden['superblocks']} superblocks): TS exact, "
          f"{n_pkts} packets; FSYNC, control word 6, RS, extension and "
          f"checksums all ok over {len(res.rs_ok)} codewords")
    noisy = awgn(iq, RX_J83B_SNR_DB, RX_NOISE_SEED)
    res_n = rxq.demodulate_stream(cfg, noisy, device=dev)
    _expect_ts(f"j83b rx at {RX_J83B_SNR_DB} dB", res_n.ts, ts, n_pkts)
    if not (res_n.rs_ok.all() and res_n.checksum_ok.all()):
        raise AssertionError(f"j83b rx at {RX_J83B_SNR_DB} dB: RS or "
                             "checksum failed")
    print(f"j83b rx at {RX_J83B_SNR_DB} dB SNR: TS exact, RS and checksums "
          f"ok; RS corrected {int(res_n.rs_errors.sum())} symbols")
    return res, noisy


def _rs_cases(seed: int):
    """(decoder, codewords, corrupted codewords, errors per word) for the
    DVB-T RS(204,188) and the J.83B RS(127,122): 0..t errors and beyond."""
    from dtv_utils_torch.core.galois import GF128
    from dtv_utils_torch.ops import rs, rs_decode

    rng = np.random.default_rng(seed)
    out = []
    for dec, enc in ((rs_decode.DVBT_RS_DEC(), rs.DVBT_RS()),
                     (rs_decode.RsDecoder(GF128, 122, 5, first_root=1),
                      rs.RsBitEncoder(GF128, 122, 5, first_root=1))):
        msgs = rng.integers(0, dec.gf.q, (512, dec.k_sym))
        cw = np.concatenate([msgs, enc.gf.rs_encode_ref(msgs, enc.genpoly)],
                            axis=1)
        n_errs = np.arange(len(cw)) % (2 * dec.t + 5)
        bad = cw.copy()
        for p, ne in enumerate(n_errs):
            pos = rng.choice(dec.n, ne, replace=False)
            bad[p, pos] ^= rng.integers(1, dec.gf.q, ne)
        out.append((dec, cw, bad, n_errs))
    return out


def _equal_on(label: str, card, cpu) -> None:
    card = card if isinstance(card, tuple) else (card,)
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    for a, b in zip(card, cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{label}: the card differs from the CPU")


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over two tensors of one shape, any dtype; equal entries,
    infinities included, count 0."""
    a, b = a.double(), b.to(a.device).double()
    d = torch.where(a == b, 0.0, (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def check_rx_stages(dev, dvbt_noisy: np.ndarray, j83b_iq: np.ndarray,
                    j83b_noisy: np.ndarray) -> None:
    """Card against the port's CPU on identical inputs, stage by stage, and
    no host sync inside the two decoders on device tensors."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.ops import viterbi
    from dtv_utils_torch.rx import dvbt as rxd
    from dtv_utils_torch.rx import j83b as rxq

    cfg = dvbt_flagship()
    rate = cfg.code_rate.value
    carriers = rxd.iq_to_carriers(cfg, torch.from_numpy(dvbt_noisy).to(dev))
    z = rxd.coded_llrs(cfg, rxd._extract_cells(cfg, carriers))
    # 64 blocks of 4096 trellis steps, in whole puncture periods of 7 steps
    cut = z[:RX_VITERBI_BLOCKS * 4096 // rate[0] * rate[1]]
    bits = viterbi.viterbi_decode_punctured(cut, rate)
    _equal_on("viterbi_decode_punctured", bits,
              viterbi.viterbi_decode_punctured(cut.cpu(), rate))
    print(f"viterbi (K=7, 7/8) on {cut.numel()} flagship LLRs at "
          f"{RX_DVBT_SNR_DB} dB ({RX_VITERBI_BLOCKS} blocks): card bits "
          "equal the CPU's")

    jcfg = J83bConfig()
    words = rxq.front(jcfg, torch.from_numpy(j83b_iq).to(dev))
    _equal_on("j83b front (clean)", words,
              rxq.front(jcfg, torch.from_numpy(j83b_iq)))
    noisy_words = rxq.front(jcfg, torch.from_numpy(j83b_noisy).to(dev))
    cut_w = noisy_words[:5 * RX_J83B_GROUPS]
    _equal_on("j83b trellis decode", rxq.trellis_decode(cut_w),
              rxq.trellis_decode(cut_w.cpu()))
    print(f"j83b front words on the clean IQ ({words.numel()} symbols) and "
          f"the dual Viterbi on {cut_w.numel()} noisy words: card equals "
          "the CPU")

    for dec, cw, bad, n_errs in _rs_cases(RX_NOISE_SEED):
        x = torch.from_numpy(bad)
        got = (dec.decode_bytes(x.to(torch.uint8).to(dev)) if dec.gf.m == 8
               else dec.decode_words(x.to(dev)))
        want = (dec.decode_bytes(x.to(torch.uint8)) if dec.gf.m == 8
                else dec.decode_words(x))
        _equal_on(f"RS GF(2^{dec.gf.m})", tuple(got), tuple(want))
        le_t = n_errs <= dec.t
        fixed = want[0].numpy().astype(np.int64)
        if not (np.array_equal(fixed[le_t], cw[le_t]) and want[2].numpy()[
                le_t].all() and np.array_equal(want[1].numpy()[le_t],
                                               n_errs[le_t])):
            raise AssertionError(f"RS GF(2^{dec.gf.m}) missed a word with "
                                 "at most t errors")
        print(f"RS GF(2^{dec.gf.m}) t={dec.t} on {len(cw)} words with 0.."
              f"{n_errs.max()} errors: corrected words, n_err and ok equal "
              f"the CPU's; {int((~want[2].numpy()).sum())} flagged "
              "uncorrectable")

    if dev.type == "cuda":
        dec, _, bad, _ = _rs_cases(RX_NOISE_SEED)[0]
        bad_dev = torch.from_numpy(bad).to(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            viterbi.viterbi_decode_punctured(cut, rate)
            dec.decode_words(bad_dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print("viterbi_decode and RsDecoder.decode_words ran with no host "
              "sync")


def _rx_cli(tool: str, iq: np.ndarray, want: np.ndarray, device: str,
            args=()) -> None:
    with tempfile.TemporaryDirectory() as d:
        src, dst = Path(d, "in.cfile"), Path(d, "out.ts")
        iq.tofile(src)
        subprocess.run([sys.executable, "-m", "dtv_utils_torch.cli", tool,
                        *args, "-o", str(dst), str(src), "--device", device],
                       cwd=ROOT, check=True, timeout=300,
                       stdout=subprocess.DEVNULL)
        if dst.read_bytes() != want.tobytes():
            raise AssertionError(f"{tool} output differs from "
                                 "demodulate_stream's TS")
    print(f"{tool} output equals demodulate_stream's TS")


@contextlib.contextmanager
def _patched(module, name: str, value):
    """``module.name`` set to ``value`` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def _counted(module, name: str):
    """Count the calls of ``module.name`` inside the block (a one-element
    list, read after it)."""
    fn, n = getattr(module, name), [0]

    def counting(*args, **kwargs):
        n[0] += 1
        return fn(*args, **kwargs)

    with _patched(module, name, counting):
        yield n


@contextlib.contextmanager
def _main_path(store: dict, label: str, kernels: tuple[str, ...]):
    """Set the launch counts of ``kernels`` to 0, run the block (a
    main-path run), store the counts it made under ``label``; fail if a
    kernel of the path was not launched."""
    for key in kernels:
        _build.LAUNCHES[key] = 0
    yield
    store[label] = {key: _build.LAUNCHES[key] for key in kernels}
    if not all(store[label].values()):
        raise AssertionError(f"{label}: a kernel of the path was not "
                             f"launched: {store[label]}")
    print(f"{label} kernel launches: {store[label]}")


def _wall_s(fn, repeats: int = RX_REPEATS) -> list[float]:
    """Host seconds of ``fn()`` (which ends with host arrays), one warm-up
    call first."""
    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def time_rx(dev, card: str, dvbt_golden: dict, dvbt_iq: np.ndarray,
            j83b_iq: np.ndarray) -> float:
    """Receive throughput, device-resident IQ in and the host TS out: DVB-T
    at 2 and 8 superframes per call, J.83B at 2 superblocks.  Returns the
    median seconds of a 2-superframe DVB-T call."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.rx import dvbt as rxd
    from dtv_utils_torch.rx import j83b as rxq
    from dtv_utils_torch.tx import dvbt as txd

    from dtv_utils_torch.ops import viterbi

    cfg = dvbt_flagship()
    dvbt_msps = float(cfg.sample_rate) / 1e6
    sec2 = 0.0
    for n_sf in RX_SUPERFRAMES:
        if n_sf == dvbt_golden["superframes"]:
            iq = dvbt_iq
        else:
            ts = seeded_ts(dvbt_golden["seed"],
                           n_sf * cfg.ts_bytes_per_superframe)
            iq, _ = txd.modulate_stream(cfg, ts, device=dev)
            res = rxd.demodulate_stream(cfg, iq, device=dev)
            _expect_ts(f"dvbt rx {n_sf} superframes", res.ts, ts,
                       len(res.ts) // 188)
        x = torch.from_numpy(iq).to(dev)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        secs = _wall_s(
            lambda: rxd.demodulate_stream(cfg, x, device=dev))
        peak = torch.cuda.max_memory_allocated(dev) - held
        with _counted(viterbi, "_acs") as passes:
            rxd.demodulate_stream(cfg, x, device=dev)
        if passes[0] != 1:
            raise AssertionError(f"dvbt rx {n_sf} superframes: {passes[0]} "
                                 "ACS passes, not one")
        msps = [x.numel() / s / 1e6 for s in secs]
        print(f"dvbt rx, {n_sf} superframes per call ({x.numel()} samples, "
              f"{1e3 * x.numel() / float(cfg.sample_rate):.3f} ms of air): "
              f"{_repeats(msps)} Msamples/s, {_repeats(secs, '.4f')} s per "
              f"call; real time is {dvbt_msps:.6f} Msps; {passes[0]} ACS "
              f"pass(es); peak device memory {peak / 1e9:.3f} GB above what "
              f"was held before; on {card}")
        check_pass_units(dev, card, cfg, x)
        if n_sf == dvbt_golden["superframes"]:
            sec2 = sorted(secs)[1]
    jcfg = J83bConfig()
    x = torch.from_numpy(j83b_iq).to(dev)
    secs = _wall_s(lambda: rxq.demodulate_stream(jcfg, x, device=dev))
    msps = [x.numel() / s / 1e6 for s in secs]
    print(f"j83b rx, {x.numel() // rxq.SUPERBLOCK_SAMPLES} superblocks per "
          f"call ({x.numel()} samples): {_repeats(msps)} Msamples/s, "
          f"{_repeats(secs, '.4f')} s per call; real time is "
          f"{float(jcfg.sample_rate) / 1e6:.6f} Msps; on {card}")
    return sec2


def _peak(dev, fn):
    """(fn(), the device bytes allocated at the peak of its run above what
    was held before it)."""
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) - held


def check_pass_units(dev, card: str, cfg, x: torch.Tensor) -> None:
    """The DVB-T receiver's three stages that run in passes, each run once
    over the whole of ``x``: the peak above its input per unit of work,
    against the bytes per unit ``utils/device.py`` sizes the passes with.
    Fails if a peak is larger, or if a stage took more than one pass."""
    from dtv_utils_torch.core import bits as bitops
    from dtv_utils_torch.ops import rs_decode, viterbi
    from dtv_utils_torch.ops.convcode import PUNCTURE_PATTERNS
    from dtv_utils_torch.rx import dvbt as rxd
    from dtv_utils_torch.utils import device as udev

    rate = cfg.code_rate.value
    xp, yp = PUNCTURE_PATTERNS[rate]
    block = inspect.signature(
        viterbi.viterbi_decode_punctured).parameters["block"].default
    (_, _, z), front = _peak(dev, lambda: rxd._front_end(cfg, x))
    steps = z.numel() // (sum(xp) + sum(yp)) * len(xp)
    block_steps = -(-steps // block) * (
        block + 2 * viterbi.seam_overlap(viterbi.DVBT_K, *rate))
    with _counted(viterbi, "_acs") as passes:
        bits, vit = _peak(
            dev, lambda: viterbi.viterbi_decode_punctured(z, rate))
    outer = bitops.bits_to_bytes(bits)
    del z, bits
    with _counted(rs_decode.RsDecoder, "decode_bytes") as chunks:
        (pkts, _, _), rs = _peak(dev, lambda: rxd.decode_outer(outer))
    n_sf = x.numel() // cfg.samples_per_superframe
    for stage, unit, got, bound, n_pass in (
            ("front end", "IQ sample", front / x.numel(),
             udev.FRONT_BYTES_PER_SAMPLE, 1),
            ("Viterbi", "trellis step of a block", vit / block_steps,
             udev.VITERBI_BYTES_PER_STEP, passes[0]),
            ("RS", "TS packet", rs / pkts.shape[0], udev.RS_BYTES_PER_PACKET,
             chunks[0])):
        print(f"dvbt rx {n_sf} superframes, {stage} in {n_pass} pass(es): "
              f"peak {got:.1f} bytes per {unit} above its input; passes "
              f"sized at {bound}; on {card}")
        if n_pass != 1 or got > bound:
            raise AssertionError(f"dvbt rx {stage}: {got:.1f} bytes per "
                                 f"{unit} over {n_pass} pass(es); "
                                 f"utils/device.py sizes it at {bound}")


def check_dvbt_rx_capped(dev, card: str, dvbt_golden: dict) -> None:
    """``dvbt-rx``'s memory no longer grows with its input's length: under
    a RX_CAP_BYTES ``set_per_process_memory_fraction`` cap (the unpassed
    decoder needed ~1.09 GB per superframe, ~26 GB for 24), the flagship's
    24 superframes decode to the exact TS, equal to the same call without
    the cap.  The passes are sized from the memory left, so the peak does
    not follow the length; the slope per superframe (IQ included) is
    measured at 12 and 24 superframes with the working memory pinned to
    RX_SLOPE_WORKING_BYTES, so that both calls run passes of one size."""
    from dtv_utils_torch.rx import dvbt as rxd
    from dtv_utils_torch.tx import dvbt as txd
    from dtv_utils_torch.utils import device as udev
    from dtv_utils_torch.utils import graph

    cfg = dvbt_flagship()
    spf = cfg.samples_per_superframe
    lo, hi = RX_CAP_SUPERFRAMES
    ts = seeded_ts(dvbt_golden["seed"], hi * cfg.ts_bytes_per_superframe)
    iq, _ = txd.modulate_stream(cfg, ts, device=dev)
    graph.release(dev)      # the modulator's graph pool stays out of it
    x = torch.from_numpy(iq).to(dev)
    del iq
    t0 = time.perf_counter()
    free = rxd.demodulate_stream(cfg, x, device=dev)
    free_s = time.perf_counter() - t0
    _expect_ts(f"dvbt rx {hi} superframes", free.ts, ts, len(free.ts) // 188)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory

    def pinned(_dev) -> int:
        return RX_SLOPE_WORKING_BYTES

    torch.cuda.set_per_process_memory_fraction(RX_CAP_BYTES / total, dev)
    peak = {}
    try:
        for n_sf, pin in ((hi, False), (lo, True), (hi, True)):
            with contextlib.ExitStack() as stack:
                if pin:
                    stack.enter_context(_patched(udev, "working_bytes",
                                                 pinned))
                held = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                res = rxd.demodulate_stream(cfg, x[:n_sf * spf], device=dev)
                secs = time.perf_counter() - t0
                top = torch.cuda.max_memory_allocated(dev) - held
            _expect_ts(f"dvbt rx {n_sf} superframes under the cap", res.ts,
                       ts, len(res.ts) // 188)
            if pin:
                peak[n_sf] = top
            elif not (np.array_equal(res.ts, free.ts)
                      and np.array_equal(res.rs_errors, free.rs_errors)
                      and np.array_equal(res.rs_ok, free.rs_ok)
                      and res.tps == free.tps
                      and res.phase_ok == free.phase_ok):
                raise AssertionError(f"dvbt rx {hi} superframes: the capped "
                                     "call differs from the uncapped one")
            print(f"dvbt rx, {n_sf} superframes under a "
                  f"{RX_CAP_BYTES / 1e9:g} GB cap"
                  + (f", working memory pinned to "
                     f"{RX_SLOPE_WORKING_BYTES / 1e9:g} GB" if pin else "")
                  + f": TS exact ({len(res.ts) // 188} packets"
                  + ("" if pin else ", equal to the uncapped call's")
                  + f"), {secs:.3f} s (uncapped {free_s:.3f} s at {hi}), "
                  f"peak {top / 1e9:.3f} GB above the IQ held; on {card}")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    slope = (peak[hi] - peak[lo]) / (hi - lo) + 8 * spf
    print(f"dvbt rx memory: {slope / 1e9:.4f} GB per superframe with the "
          f"IQ, at a pinned working memory (peak {peak[lo] / 1e9:.3f} GB at "
          f"{lo}, {peak[hi] / 1e9:.3f} GB at {hi}); on {card}")


def _range_activities(events, acts, name: str) -> list:
    """Device activities launched inside the profiler ranges ``name``: by
    a host op inside them, or by a runtime launch made inside them (a
    kernel launched through ctypes has no host op)."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == name]

    def inside(e) -> bool:
        return any(a <= e["ts"] < b for a, b in spans)

    ids = {e["args"].get("External id") for e in events
           if e.get("cat") == "cpu_op" and inside(e)} - {None}
    launches = {e["args"].get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and inside(e)} - {None}
    return [e for e in acts
            if e.get("args", {}).get("External id") in ids
            or e.get("args", {}).get("correlation") in launches]


def profile_dvbt_rx(dev, card: str, iq: np.ndarray, call_s: float) -> dict:
    """torch.profiler over one DVB-T receive call (2 superframes): device
    busy time and share of the unprofiled call, device activities per call,
    the top ops, and the share of device time in the Viterbi's ACS and
    traceback kernels (launched inside its ``viterbi_acs`` and
    ``viterbi_traceback`` ranges, one launch each per pass: fails on
    another count)."""
    from torch.profiler import ProfilerActivity, profile

    from dtv_utils_torch.rx import dvbt as rxd

    cfg = dvbt_flagship()
    x = torch.from_numpy(iq).to(dev)
    rxd.demodulate_stream(cfg, x, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rxd.demodulate_stream(cfg, x, device=dev)
        torch.cuda.synchronize()
    events, acts, busy_us, total_us, rows = _trace_summary(prof)
    if len(acts) != RX_DVBT_ACTIVITIES:
        raise AssertionError(f"dvbt rx: {len(acts)} device activities in "
                             f"one call, not {RX_DVBT_ACTIVITIES}")
    busy_ms = busy_us / 1e3
    got = {}
    for name in ("viterbi_acs", "viterbi_traceback"):
        inside = _range_activities(events, acts, name)
        got[name] = (len(inside), sum(e["dur"] for e in inside))
        if len(inside) != 1:
            raise AssertionError(f"dvbt rx: {len(inside)} device "
                                 f"activities in {name}, not the kernel's "
                                 "one launch")
    loop_n = sum(n for n, _ in got.values())
    loop_us = sum(us for _, us in got.values())
    rs = _range_activities(events, acts, "rs_decode_kernel")
    if len(rs) != 1:
        raise AssertionError(f"dvbt rx: {len(rs)} device activities in "
                             "rs_decode_kernel, not the kernel's one launch")
    print(f"dvbt rx profile: RS kernel {rs[0]['dur'] / 1e3:.4f} ms of device "
          f"time in its one launch, on {card}")
    print(f"dvbt rx profile (1 call, 2 superframes): {len(acts)} device "
          f"activities, busy {busy_ms:.3f} ms = {busy_ms / 1e3 / call_s:.3f} "
          f"of the unprofiled call's {call_s:.4f} s; Viterbi kernels "
          f"{loop_n} activities ({loop_n / len(acts):.3f}), "
          f"{loop_us / 1e3:.3f} ms = {loop_us / total_us:.3f} of device "
          f"time (ACS {got['viterbi_acs'][1] / 1e3:.3f} ms over "
          f"{got['viterbi_acs'][0]}, traceback "
          f"{got['viterbi_traceback'][1] / 1e3:.3f} ms over "
          f"{got['viterbi_traceback'][0]}); on {card}; top ops by self "
          "CUDA time:")
    for self_us, count, key in rows[:10]:
        print(f"  {self_us / 1e3:9.3f} ms {100 * self_us / total_us:5.1f} % "
              f"{count:6d} calls  {key[:60]}")
    return dict(busy_ms=busy_ms, activities=len(acts), loop_share=loop_us
                / total_us, rs_ms=rs[0]["dur"] / 1e3)


def _expect_t2(label: str, res, ts: np.ndarray, cfg,
               signalling: bool = True) -> None:
    """The exact input TS, every FEC and CRC flag of the data path (LDPC,
    BCH, BB header, sync-byte chain) and, with ``signalling``, P1, S1/S2,
    the L1 CRCs and the L1 fields the config signals
    (tx/dvbt2_tables.l1_pre_bits/l1_post_bits).  The L1-post cells carry
    no FEC in either package's receiver, so under noise they are only
    reported."""
    from dtv_utils_torch.tx import dvbt2_tables as T

    if len(res.ts) != len(ts) or not np.array_equal(res.ts, ts):
        raise AssertionError(f"{label}: recovered TS ({len(res.ts)} bytes) "
                             f"is not the {len(ts)}-byte input")
    flags = dict(sync_crc=res.sync_crc_ok, ldpc=bool(res.ldpc_ok.all()),
                 bch=bool(res.bch_ok.all()), bb_crc=bool(res.bb_crc_ok.all()))
    l1 = dict(p1=res.p1_detected, l1_pre_crc=res.l1_pre["crc_ok"],
              l1_post_crc=res.l1_post["crc_ok"])
    if not all(flags.values()) or (signalling and not all(l1.values())):
        raise AssertionError(f"{label}: a flag is off: {flags} {l1}")
    if not signalling:
        print(f"{label}: signalling (not required under noise): {l1}")
        return
    want = dict(s1=0, s2=T._S2_FFT_CODE[cfg.fft_size] << 1,
                pilot_pattern=cfg.pilot_pattern.number,
                num_data_symbols=cfg.data_symbols,
                plp_mod=T._PLP_MOD[cfg.constellation.value],
                plp_cod=T._PLP_COD[cfg.code_rate.value],
                plp_rotation=int(cfg.rotation),
                plp_num_blocks_max=cfg.fec_blocks)
    got = dict(s1=res.s1, s2=res.s2, **{k: res.l1_pre[k] for k in (
        "pilot_pattern", "num_data_symbols")}, **{k: res.l1_post[k] for k in (
            "plp_mod", "plp_cod", "plp_rotation", "plp_num_blocks_max")})
    if got != want:
        raise AssertionError(f"{label}: signalling {got} != {want}")


def check_dvbt2_rx(dev, golden: dict, iq: np.ndarray):
    """DVB-T2 BBC's 2 frames (step 6) back through ``rx.dvbt2`` on ``dev``:
    the hard path, the soft path clean and at RX_DVBT2_SNR_DB, then the
    blade profile's 2 frames soft at RX_BLADE_SNR_DB; each the exact TS
    with every flag and the signalled L1 fields.  Returns the hard result
    and the noisy BBC IQ."""
    from dtv_utils_torch.models.dvbt2 import PROFILES
    from dtv_utils_torch.rx import dvbt2 as rx2
    from dtv_utils_torch.tx import dvbt2 as t2

    cfg = dvbt2_bbc()
    ts = seeded_ts(golden["seed"],
                   golden["frames"] * cfg.payload_bytes_per_frame)
    x = torch.from_numpy(iq).to(dev)
    res = rx2.demodulate_stream(cfg, x, device=dev)
    _expect_t2("dvbt2 rx bbc hard", res, ts, cfg)
    print(f"dvbt2 rx bbc hard ({golden['frames']} frames): TS exact "
          f"({len(ts)} bytes); P1, S1/S2 ({res.s1}, {res.s2}), L1-pre and "
          f"L1-post CRCs and fields, LDPC, BCH, BB-header CRC over "
          f"{res.ldpc_ok.size} FEC blocks and the sync-byte CRC chain ok")
    soft = rx2.demodulate_stream(cfg, x, soft=True, device=dev)
    _expect_t2("dvbt2 rx bbc soft clean", soft, ts, cfg)
    noisy = awgn(iq, RX_DVBT2_SNR_DB, RX_NOISE_SEED)
    soft = rx2.demodulate_stream(cfg, noisy, soft=True, device=dev)
    _expect_t2(f"dvbt2 rx bbc soft at {RX_DVBT2_SNR_DB} dB", soft, ts, cfg,
               signalling=False)
    print(f"dvbt2 rx bbc soft (30 min-sum iterations): TS exact with every "
          f"flag clean, and with every data-path flag at {RX_DVBT2_SNR_DB} "
          "dB SNR")

    blade = PROFILES["blade"]
    ts_b = seeded_ts(golden["seed"], 2 * blade.payload_bytes_per_frame)
    iq_b, _ = t2.modulate_stream(blade, ts_b, device=dev)
    res_b = rx2.demodulate_stream(
        blade, awgn(iq_b, RX_BLADE_SNR_DB, RX_NOISE_SEED), soft=True,
        device=dev)
    _expect_t2(f"dvbt2 rx blade soft at {RX_BLADE_SNR_DB} dB", res_b, ts_b,
               blade, signalling=False)
    print(f"dvbt2 rx blade (2 frames, {blade.fec_blocks} FEC blocks each) "
          f"soft at {RX_BLADE_SNR_DB} dB SNR: TS exact with every data-path "
          "flag")
    return res, noisy


def check_dvbt2_stages(dev, iq: np.ndarray, noisy: np.ndarray) -> None:
    """Card against the port's CPU on identical inputs: the hard path's
    words, the min-sum decoder (hard bits and ok) on RX_LDPC_BLOCKS FEC
    blocks of the noisy BBC frame's LLRs, and the syndrome; then no host
    sync inside ``ldpc_decode.decode`` or the per-frame decode."""
    from dtv_utils_torch.ops import ldpc_decode
    from dtv_utils_torch.rx import dvbt2 as rx2
    from dtv_utils_torch.tx import dvbt2 as t2

    cfg = dvbt2_bbc()
    spf = t2.samples_per_frame(cfg)
    body = torch.from_numpy(iq[2048:spf]).to(dev)
    _, cells = rx2._cells(cfg, body)
    words = rx2.hard_words(cfg, cells)
    _equal_on("dvbt2 hard words", words, rx2.hard_words(cfg, cells.cpu()))
    _, cells_n = rx2._cells(cfg, torch.from_numpy(noisy[2048:spf]).to(dev))
    llr = rx2.soft_llrs(cfg, cells_n)[:RX_LDPC_BLOCKS]
    hard, ok = ldpc_decode.decode(cfg, llr)
    _equal_on("ldpc_decode.decode", (hard, ok),
              ldpc_decode.decode(cfg, llr.cpu()))
    flipped = hard.clone()
    flipped[:, ::997] ^= 1
    _equal_on("ldpc syndrome", ldpc_decode.syndrome(cfg, flipped),
              ldpc_decode.syndrome(cfg, flipped.cpu()))
    print(f"dvbt2 stages: hard words ({words.numel()} cells), the min-sum "
          f"decoder on {RX_LDPC_BLOCKS} noisy FEC blocks ({int(ok.sum())} "
          f"converged) and the syndrome: card equals the CPU")
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
        try:
            ldpc_decode.decode(cfg, llr)
            for soft in (False, True):
                rx2._decode_frame(cfg, body, soft, 30)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print("ldpc_decode.decode and the per-frame decode (hard and soft) "
              "ran with no host sync")


def time_dvbt2_rx(dev, card: str, iq: np.ndarray) -> dict[str, float]:
    """DVB-T2 BBC receive throughput, device-resident IQ in and the host TS
    out, hard and soft, 2 frames per call; the soft call's peak device
    memory, and one soft frame's.  Returns the median seconds per call of
    each path."""
    from dtv_utils_torch.rx import dvbt2 as rx2
    from dtv_utils_torch.tx import dvbt2 as t2

    cfg = dvbt2_bbc()
    spf = t2.samples_per_frame(cfg)
    air_ms = 1e3 * spf / float(cfg.sample_rate)
    x = torch.from_numpy(iq).to(dev)
    n_fr = x.numel() // spf
    out = {}
    for soft in (False, True):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        secs = _wall_s(lambda: rx2.demodulate_stream(cfg, x, soft=soft,
                                                     device=dev))
        peak = torch.cuda.max_memory_allocated(dev) - held
        msps = [x.numel() / s / 1e6 for s in secs]
        ms_fr = [1e3 * s / n_fr for s in secs]
        print(f"dvbt2 rx bbc {'soft' if soft else 'hard'}, {n_fr} frames per "
              f"call ({x.numel()} samples): {_repeats(msps)} Msamples/s, "
              f"{_repeats(ms_fr, '.2f')} ms per frame (air time "
              f"{air_ms:.3f} ms; real time is "
              f"{float(cfg.sample_rate) / 1e6:.6f} Msps); peak device memory "
              f"{peak / 1e9:.3f} GB above the IQ held; on {card}")
        out["soft" if soft else "hard"] = sorted(secs)[1]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rx2._decode_frame(cfg, x[2048:spf], True, LDPC_ITERATIONS)
    torch.cuda.synchronize()
    print(f"dvbt2 rx bbc soft, one frame's decode (P1 stripped): peak device "
          f"memory {(torch.cuda.max_memory_allocated(dev) - held) / 1e6:.3f} "
          f"MB above the IQ held; on {card}")
    return out


def profile_dvbt2_rx(dev, card: str, iq: np.ndarray, call_s: float) -> None:
    """torch.profiler over one soft DVB-T2 BBC receive call (2 frames):
    device activities per frame, busy share of the unprofiled call, the
    ``ldpc_minsum`` range's share of device time (2 · LDPC_ITERATIONS + 1
    kernel launches per frame: fails on another count), and the top
    ops."""
    from torch.profiler import ProfilerActivity, profile

    from dtv_utils_torch.rx import dvbt2 as rx2
    from dtv_utils_torch.tx import dvbt2 as t2

    cfg = dvbt2_bbc()
    x = torch.from_numpy(iq).to(dev)
    n_fr = x.numel() // t2.samples_per_frame(cfg)
    rx2.demodulate_stream(cfg, x, soft=True, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rx2.demodulate_stream(cfg, x, soft=True, device=dev)
        torch.cuda.synchronize()
    events, acts, busy_us, total_us, rows = _trace_summary(prof)
    ldpc = _range_activities(events, acts, "ldpc_minsum")
    ldpc_us = sum(e["dur"] for e in ldpc)
    if len(ldpc) != (2 * LDPC_ITERATIONS + 1) * n_fr:
        raise AssertionError(f"dvbt2 rx: {len(ldpc)} device activities in "
                             f"ldpc_minsum over {n_fr} frames, not the "
                             f"kernels' {2 * LDPC_ITERATIONS + 1} per frame")
    print(f"dvbt2 rx bbc soft profile (1 call, {n_fr} frames): {len(acts)} "
          f"device activities ({len(acts) / n_fr:.1f} per frame), busy "
          f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / call_s:.3f} of the "
          f"unprofiled call's {call_s:.4f} s; ldpc_minsum {len(ldpc)} "
          f"activities, {ldpc_us / 1e3:.3f} ms = {ldpc_us / total_us:.3f} of "
          f"device time; on {card}; top ops by self CUDA time:")
    for self_us, count, key in rows[:10]:
        print(f"  {self_us / 1e3:9.3f} ms {100 * self_us / total_us:5.1f} % "
              f"{count:6d} calls  {key[:60]}")


def _captured_acs(fn) -> list[tuple]:
    """Run ``fn()`` and return the arguments (pairs, k, g1, g2) of each of
    its calls to ``ops.viterbi._acs``: the shapes the main path gives the
    ACS kernel."""
    from dtv_utils_torch.ops import viterbi

    seen, acs = [], viterbi._acs

    def keep(pairs, *code):
        seen.append((pairs, *code))
        return acs(pairs, *code)

    with _patched(viterbi, "_acs", keep):
        fn()
    return seen


def _bound(nbytes: float, ops: float,
           ops_per_s: float = FP32_FLOPS) -> tuple[float, str]:
    """Least ms on an H100 SXM for ``nbytes`` moved and ``ops`` fp32
    operations at ``ops_per_s``, and which of the two sets it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def fp32_instruction_rate(dev) -> float:
    """fp32 instructions per second the card can issue: 128 per SM and
    clock (an add, compare, select or max is one, an FMA too) times its SMs
    times the SM clock nvidia-smi reports as its maximum."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[dev.index]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return FP32_LANES_PER_SM * sms * float(mhz) * 1e6


def viterbi_bounds(L: int, B: int, S: int, ops_per_s: float = FP32_FLOPS
                   ) -> dict[str, tuple[float, str]]:
    """ACS: pairs read, packed decisions and final metrics written; per
    step and block 2 (s, d) + 2S (cand) + S (compare) + S (select) + S - 1
    (max) + S (subtract) fp32 operations, none of them an FMA, so counted
    at the fp32 instruction rate (``fp32_instruction_rate``); at the
    default 67 TFLOP/s, which counts an FMA as two, they give the earlier
    yardstick, the kernels JSON's ``bound_ms``.  Traceback: decisions and final
    metrics read, bits written; S - 1 compares per block (the walk is
    integer work)."""
    return {"viterbi_acs": _bound(L * B * 8 + L * B * S // 8 + B * S * 4,
                                  L * B * (6 * S + 1), ops_per_s),
            "viterbi_traceback": _bound(L * B * S // 8 + B * S * 4 + L * B,
                                        B * (S - 1), ops_per_s)}


def ldpc_bounds(batch: int, nldpc: int, n_par: int, n_edges: int,
                dv: int) -> dict[str, tuple[float, str]]:
    """The work of one min-sum iteration in the representation the kernels
    carry: 16 bytes of check state (m1, m2, meta) per check and codeword.
    Check kernel: totals read once, the state read and written, the CSR
    edge list read; per edge a product (the old message), a subtract, |x|,
    two compares, a min and two bit operations.  Variable kernel: the
    state read, llr read, totals written, the [dv, nldpc] table read; per
    edge a product and an add, per variable the llr add."""
    return {"ldpc_check": _bound(
                4 * nldpc * batch + 2 * 16 * n_par * batch
                + 4 * (n_par + 1) + 4 * n_edges, 8 * n_edges * batch),
            "ldpc_variable": _bound(
                16 * n_par * batch + 2 * 4 * nldpc * batch
                + 4 * dv * nldpc, (2 * n_edges + nldpc) * batch)}


def ldpc_message_bounds(batch: int, nldpc: int,
                        n_edges: int) -> dict[str, float]:
    """The message yardstick, ms: the same iteration carrying one float
    message per real edge, as a padded message table does but counted
    over the real edges.  Check: totals read, each message read and
    written, its slot read; variable: each message and its slot read, llr
    read, totals written."""
    return {"ldpc_check": (4 * (nldpc + 1) * batch + 8 * n_edges * batch
                           + 8 * n_edges) / HBM_BYTES_PER_S * 1e3,
            "ldpc_variable": (4 * n_edges * batch + 4 * n_edges
                              + 8 * nldpc * batch) / HBM_BYTES_PER_S * 1e3}


def _span_ms(fn) -> float:
    """Device ms between CUDA events around one call of ``fn`` (made once
    untimed first), host gaps included: for a plain version whose
    thousands of launches fill the launch queue, which no spin kernel
    ahead of them can hide."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def _timed(kernel_sets: list, plain, library=None) -> dict:
    """Device ms per call between CUDA events: the kernel cold (DEC_TIMED
    calls rotating over distinct input sets) and warm (one set), and where
    one exists the one-call library yardstick, each queued behind a spin
    (``_queued_ms``); the plain version over one call (``_span_ms``).
    ``kernel_sets`` holds one zero-argument call per set."""
    t = {"cold": _queued_ms([kernel_sets[i % len(kernel_sets)]
                             for i in range(DEC_TIMED)]),
         "warm": _queued_ms([kernel_sets[0]] * DEC_TIMED),
         "plain": _span_ms(plain)}
    t["library"] = (_queued_ms([library] * DEC_TIMED) if library else None)
    return t


def _report(name: str, label: str, t: dict, bound: tuple[float, str],
            card: str) -> None:
    lib = (f"; library {t['library']:.5f} ms" if t["library"] is not None
           else "")
    print(f"{name} ({label}): cold {t['cold']:.5f} ms ({bound[0] / t['cold']:.3f} "
          f"of the {bound[0]:.5f} ms bound, {bound[1]}), warm "
          f"{t['warm']:.5f} ms; plain version {t['plain']:.3f} ms{lib}; "
          f"on {card}")


def check_viterbi_kernels(label: str, args: tuple, card: str,
                          instr_per_s: float) -> dict:
    """The ACS and traceback kernels against their plain versions on the
    card, on the main path's pairs: packed decisions, final metrics and
    bits bit for bit; then their times beside their bounds (operations at
    ``instr_per_s``, and the 67 TFLOP/s yardstick) and ns per
    trellis step."""
    from dtv_utils_torch.ops import viterbi

    pairs, k, g1, g2 = args
    L, B, _ = pairs.shape
    S = 1 << (k - 1)
    packed, final = viterbi._acs(pairs, k, g1, g2)
    decs, want_final = viterbi.acs_reference(pairs, k, g1, g2)
    want_packed = viterbi.pack_decisions(decs)
    del decs
    _equal_on(f"{label} ACS packed decisions", packed.cpu(),
              want_packed.cpu())
    _equal_on(f"{label} ACS final metrics", final.cpu(), want_final.cpu())
    bits = viterbi._traceback(packed, final, k)
    want_bits = viterbi.traceback_reference(packed, final, k)
    _equal_on(f"{label} traceback bits", bits.cpu(), want_bits.cpu())
    print(f"viterbi kernels, {label} (K={k}, L={L}, B={B}): packed "
          f"decisions ({packed.numel()} bytes, {int(packed.bool().sum())} "
          f"non-zero), final metrics and bits equal the plain versions' on "
          f"the card")
    err = {"viterbi_acs": max(_max_abs_diff(packed, want_packed),
                              _max_abs_diff(final, want_final)),
           "viterbi_traceback": _max_abs_diff(bits, want_bits)}
    del want_packed
    pair_sets = [pairs] + [pairs.clone() for _ in range(DEC_SETS - 1)]
    tb_sets = [(packed, final)] + [(packed.clone(), final.clone())
                                   for _ in range(DEC_SETS - 1)]
    bounds = viterbi_bounds(L, B, S, instr_per_s)
    flops = viterbi_bounds(L, B, S)
    out = {}
    for name, sets, plain in (
            ("viterbi_acs",
             [functools.partial(viterbi._acs, p, k, g1, g2)
              for p in pair_sets],
             lambda: viterbi.acs_reference(pairs, k, g1, g2)),
            ("viterbi_traceback",
             [functools.partial(viterbi._traceback, d, f, k)
              for d, f in tb_sets],
             lambda: viterbi.traceback_reference(packed, final, k))):
        t = _timed(sets, plain)
        _report(name, label, t, bounds[name], card)
        print(f"{name} ({label}): {1e6 * t['cold'] / L:.2f} ns per trellis "
              f"step cold, {1e6 * t['warm'] / L:.2f} warm; the bound above "
              f"counts operations at the fp32 instruction rate; "
              f"{flops[name][0] / t['cold']:.3f} of the {flops[name][0]:.5f}"
              f" ms bound at 67 TFLOP/s ({flops[name][1]})")
        out[name] = dict(t, bound=flops[name], instr_bound=bounds[name],
                         max_abs_err=err[name], shape=dict(L=L, B=B, K=k))
    return out


def rs_bounds(batch: int, n: int, nroots: int, in_bytes: int,
              out_bytes: int, lookups_per_s: float) -> tuple[float, str]:
    """Least ms for the RS kernel: codewords read once and corrected
    words, n_err (int32) and ok (bool) written once; and a clean
    codeword's shared-memory table lookups (a log per symbol, an exp per
    symbol and root), which every codeword needs, at ``lookups_per_s``."""
    return _bound(batch * (n * (in_bytes + out_bytes) + 5),
                  batch * n * (nroots + 1), lookups_per_s)


def _captured_rs(fn) -> list[tuple]:
    """Run ``fn()`` and return (decoder, codewords, out dtype) of each of
    its calls to ``ops.rs_decode.RsDecoder._decode``: what the main path
    gives the RS kernel."""
    from dtv_utils_torch.ops import rs_decode

    seen, decode = [], rs_decode.RsDecoder._decode

    def keep(self, cw, out_dtype):
        seen.append((self, cw, out_dtype))
        return decode(self, cw, out_dtype)

    with _patched(rs_decode.RsDecoder, "_decode", keep):
        fn()
    return seen


def rs_args(dev, dvbt_iq: np.ndarray, j83b_iq: np.ndarray) -> dict:
    """The (decoder, codewords, out dtype) the receivers hand the RS
    kernel, by case, with a label: the flagship's 2 superframes at
    RX_DVBT_SNR_DB and J.83B's 2 superblocks at RX_J83B_SNR_DB."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.rx import dvbt as rxd
    from dtv_utils_torch.rx import j83b as rxq

    noisy = awgn(dvbt_iq, RX_DVBT_SNR_DB, RX_NOISE_SEED)
    (dvbt,) = _captured_rs(
        lambda: rxd.demodulate_stream(dvbt_flagship(), noisy, device=dev))
    jnoisy = awgn(j83b_iq, RX_J83B_SNR_DB, RX_NOISE_SEED)
    (j83b,) = _captured_rs(
        lambda: rxq.demodulate_stream(J83bConfig(), jnoisy, device=dev))
    return {"dvbt": ("dvbt flagship 2 superframes", dvbt),
            "j83b": ("j83b 2 superblocks", j83b)}


def check_rs_kernel(label: str, args: tuple, card: str,
                    instr_per_s: float) -> dict:
    """The RS kernel against its plain version on the card, on the
    codewords a receiver hands it and on the same words with 0..2t+4
    symbol errors each: corrected words, n_err and ok bit for bit; then
    its time beside its bound (lookups at 32 per SM and clock, a quarter
    of ``instr_per_s``)."""
    dec, cw, out_dtype = args
    batch = cw.shape[0]
    rng = np.random.default_rng(RS_ERROR_SEED)
    n_errs = np.arange(batch) % (2 * dec.t + 5)
    hit = rng.random((batch, dec.n)).argsort(1) < n_errs[:, None]
    flips = np.where(hit, rng.integers(1, dec.gf.q, hit.shape), 0)
    bad = cw ^ torch.from_numpy(flips).to(cw.device, cw.dtype)
    for case, words in (("served", cw), ("corrupted", bad)):
        got = dec._decode(words, out_dtype)
        c, n_err, ok = dec.decode_reference(words)
        want = (c.to(out_dtype), n_err, ok)
        for g, w, name in zip(got, want, ("corrected", "n_err", "ok")):
            if not torch.equal(g, w):
                raise AssertionError(f"RS kernel ({label}, {case}): {name} "
                                     "differs from the plain version")
        print(f"RS kernel ({label}, {case}, [{batch}, {dec.n}] "
              f"{str(cw.dtype)[6:]} -> {str(out_dtype)[6:]}): corrected "
              f"words, n_err and ok equal the plain version's on the card; "
              f"{int(n_err.sum())} symbols corrected, "
              f"{int((~ok).sum())} words flagged")
    sets = [cw] + [cw.clone() for _ in range(DEC_SETS - 1)]
    t = _timed([functools.partial(dec._decode, w, out_dtype) for w in sets],
               lambda: dec.decode_reference(cw))
    bound = rs_bounds(batch, dec.n, dec.nroots, cw.element_size(),
                      torch.empty((), dtype=out_dtype).element_size(),
                      instr_per_s / 4)
    _report("rs_decode", label, t, bound, card)
    return dict(t, bound=bound, max_abs_err=0.0,
                shape=dict(batch=batch, n=dec.n, nroots=dec.nroots))


def check_ldpc_kernels(label: str, cfg, llr: torch.Tensor,
                       card: str) -> dict:
    """The check and variable kernels against their plain versions on the
    card, on LLRs [batch, nldpc] of ``cfg``'s code: the check state (m1,
    m2, meta), the messages it rebuilds and the totals after the first and
    the last of LDPC_ITERATIONS iterations, hard bits and ok, and
    ``decode``; then their times beside their bounds and the decoder's
    peak memory."""
    from dtv_utils_torch.ops import ldpc_decode as LD

    dg, llr_s, totals, state = LD._start(cfg, llr)
    p_totals, p_state = totals.clone(), tuple(x.clone() for x in state)
    err = 0.0
    for it in range(1, LDPC_ITERATIONS + 1):
        LD._variable_totals(dg, llr_s, state, totals)
        state = LD._check_update(dg, totals, state)
        p_state = LD.minsum_iteration_reference(dg, llr_s, p_state, p_totals)
        if it in (1, LDPC_ITERATIONS):
            _equal_on(f"{label} totals, iteration {it}", totals.cpu(),
                      p_totals.cpu())
            _equal_on(f"{label} state (m1, m2, meta), iteration {it}",
                      tuple(x.cpu() for x in state),
                      tuple(x.cpu() for x in p_state))
            c2v, p_c2v = LD.expand_c2v(dg, state), LD.expand_c2v(dg, p_state)
            _equal_on(f"{label} messages, iteration {it}", c2v.cpu(),
                      p_c2v.cpu())
            err = max(err, _max_abs_diff(c2v, p_c2v),
                      _max_abs_diff(totals, p_totals),
                      *(_max_abs_diff(x, y) for x, y in zip(state, p_state)))
            del c2v, p_c2v
    LD._variable_totals(dg, llr_s, state, totals)
    LD.variable_totals_reference(dg, llr_s, p_state, p_totals)
    err = max(err, _max_abs_diff(totals, p_totals))
    hard, ok = LD._finish(dg, totals)
    _equal_on(f"{label} hard bits and ok", (hard, ok),
              tuple(x.cpu() for x in LD._finish(dg, p_totals)))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = LD.decode(cfg, llr, LDPC_ITERATIONS)
    peak = torch.cuda.max_memory_allocated() - held
    _equal_on(f"{label} decode", got, (hard.cpu(), ok.cpu()))
    batch = llr.shape[0]
    print(f"ldpc kernels, {label} ({batch} FEC blocks, D={dg['D']}, "
          f"{-(-batch // dg['cols'])} slices of {dg['cols']}): state, "
          f"messages and totals after iterations 1 and {LDPC_ITERATIONS}, "
          f"hard bits and ok ({int(ok.sum())} converged) equal the plain "
          f"versions' on the card; decode's peak {peak / 1e6:.3f} MB above "
          f"its input (check state {sum(x.nbytes for x in state) / 1e6:.3f}"
          " MB)")
    g = LD._graph(cfg)
    bounds = ldpc_bounds(batch, cfg.nldpc, dg["n_par"], g["n_edges"],
                         dg["var_pairs"].shape[0])
    old = ldpc_message_bounds(batch, cfg.nldpc, g["n_edges"])
    state_sets = [state] + [tuple(x.clone() for x in state)
                            for _ in range(DEC_SETS - 1)]
    tot_sets = [totals] + [totals.clone() for _ in range(DEC_SETS - 1)]
    acc = totals.view(cfg.nldpc, batch).clone()
    c2v = LD.expand_c2v(dg, state)
    out = {}
    for name, sets, plain, library in (
            ("ldpc_check",
             [functools.partial(LD._check_update, dg, tt, ss)
              for tt, ss in zip(tot_sets, state_sets)],
             lambda: LD.check_update_reference(dg, totals, state), None),
            ("ldpc_variable",
             [functools.partial(LD._variable_totals, dg, llr_s, ss, tt)
              for tt, ss in zip(tot_sets, state_sets)],
             lambda: LD.variable_totals_reference(dg, llr_s, state,
                                                  p_totals),
             lambda: acc.index_add_(0, dg["edge_var"], c2v))):
        t = _timed(sets, plain, library)
        _report(name, label, t, bounds[name], card)
        print(f"  {name} ({label}) against the uncompressed message "
              f"bytes, one float per real edge: {old[name]:.5f} ms, "
              f"{old[name] / t['cold']:.3f} of it")
        out[name] = dict(t, bound=bounds[name], message_bound_ms=old[name],
                         max_abs_err=err, decode_peak_mb=peak / 1e6,
                         shape=dict(n_par=dg["n_par"], D=dg["D"],
                                    batch=batch, cols=dg["cols"]))
    return out


def time_ldpc_slices(cfg, llr: torch.Tensor, card: str) -> dict:
    """The check and variable kernels at 32 and 64 codewords per slice, in
    turns (32, 64, 64, 32), cold and warm on one input after 3 iterations;
    the two widths' messages must be equal.  Returns the mean cold ms by
    width and kernel."""
    from dtv_utils_torch.ops import ldpc_decode as LD

    runs, c2v = {}, {}
    for cols in (32, 64):
        dg, llr_s, totals, state = LD._start(cfg, llr, cols)
        for _ in range(3):
            LD._variable_totals(dg, llr_s, state, totals)
            state = LD._check_update(dg, totals, state)
        c2v[cols] = LD.expand_c2v(dg, state)
        sets = [(totals, state)] + [
            (totals.clone(), tuple(x.clone() for x in state))
            for _ in range(DEC_SETS - 1)]
        runs[cols] = {
            "ldpc_check": [functools.partial(LD._check_update, dg, tt, ss)
                           for tt, ss in sets],
            "ldpc_variable": [functools.partial(LD._variable_totals, dg,
                                                llr_s, ss, tt)
                              for tt, ss in sets]}
    _equal_on("ldpc messages at 32 and 64 codewords per slice",
              c2v[64].cpu(), c2v[32].cpu())
    del c2v
    res = {cols: collections.defaultdict(list) for cols in runs}
    for cols in (32, 64, 64, 32):
        for name, sets in runs[cols].items():
            res[cols][name].append(_queued_ms(
                [sets[i % len(sets)] for i in range(DEC_TIMED)]))
            res[cols][name + "_warm"].append(_queued_ms([sets[0]]
                                                        * DEC_TIMED))
    for cols, r in res.items():
        times = "; ".join(f"{k} " + " / ".join(f"{x:.5f}" for x in v)
                          + " ms" for k, v in r.items())
        print(f"ldpc slices of {cols} ({llr.shape[0]} FEC blocks): {times}; "
              f"on {card}")
    return {cols: {k: sum(v) / len(v) for k, v in r.items()}
            for cols, r in res.items()}


def coded_llrs(cfg, blocks: int, es_n0_db: float, seed: int,
               dev) -> torch.Tensor:
    """LLRs [blocks, nldpc] of random codewords of ``cfg``'s code through
    BPSK and host ``default_rng`` noise at ``es_n0_db``."""
    from dtv_utils_torch.tx import dvbt2 as t2

    rng = np.random.default_rng(seed)
    bb = torch.from_numpy(rng.integers(0, 2, (blocks, cfg.kbch)).astype(
        np.uint8)).to(dev)
    fec = t2.fec_encode(cfg, bb).float()
    sigma = np.sqrt(1 / (2 * 10 ** (es_n0_db / 10)))
    noise = torch.from_numpy(rng.normal(0, sigma, tuple(fec.shape)).astype(
        np.float32)).to(dev)
    return 2 * (1.0 - 2.0 * fec + noise) / sigma ** 2


def viterbi_args(dev, dvbt_iq: np.ndarray, j83b_iq: np.ndarray) -> dict:
    """The (pairs, k, g1, g2) the receivers hand ``ops.viterbi._acs``, by
    case, with a label: the flagship's 2 superframes at RX_DVBT_SNR_DB
    (K=7) and J.83B's 2 superblocks at RX_J83B_SNR_DB (K=5)."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.rx import dvbt as rxd
    from dtv_utils_torch.rx import j83b as rxq

    noisy = torch.from_numpy(awgn(dvbt_iq, RX_DVBT_SNR_DB,
                                  RX_NOISE_SEED)).to(dev)
    (dvbt,) = _captured_acs(
        lambda: rxd.demodulate_stream(dvbt_flagship(), noisy, device=dev))
    del noisy
    jnoisy = torch.from_numpy(awgn(j83b_iq, RX_J83B_SNR_DB,
                                   RX_NOISE_SEED)).to(dev)
    (j83b,) = _captured_acs(
        lambda: rxq.trellis_decode(rxq.front(J83bConfig(), jnoisy)))
    return {"dvbt": ("dvbt flagship 2 superframes", dvbt),
            "j83b": ("j83b 2 superblocks", j83b)}


def check_decoder_kernels(dev, card: str, dvbt_iq: np.ndarray,
                          j83b_iq: np.ndarray, dvbt2_iq: np.ndarray,
                          instr_per_s: float) -> dict:
    """Each decoder kernel against its plain version on the card at full
    width, bit for bit, and timed: the Viterbi on the flagship's 2
    superframes at RX_DVBT_SNR_DB (K=7) and on J.83B's 2 superblocks at
    RX_J83B_SNR_DB (K=5), the pairs the receivers hand the ACS; the
    min-sum kernels on one BBC frame's 202 soft blocks at RX_DVBT2_SNR_DB
    (also timed at 32 and 64 codewords per slice) and on pure noise, on
    blade's 31 coded blocks (a ragged slice) and on pure noise of the
    SHORT 5/6 code (D = 42); the RS kernel on the codewords both receivers
    hand it.  Returns the timings by kernel and case."""
    from dtv_utils_torch.core.config import T2CodeRate, T2FrameSize
    from dtv_utils_torch.models.dvbt2 import PROFILES
    from dtv_utils_torch.rx import dvbt2 as rx2
    from dtv_utils_torch.tx import dvbt2 as t2

    res = {case: check_viterbi_kernels(label, args, card, instr_per_s)
           for case, (label, args) in viterbi_args(dev, dvbt_iq,
                                                   j83b_iq).items()}
    for case, (label, args) in rs_args(dev, dvbt_iq, j83b_iq).items():
        res[f"rs_{case}"] = {"rs_decode": check_rs_kernel(label, args, card,
                                                          instr_per_s)}
    bbc = dvbt2_bbc()
    spf = t2.samples_per_frame(bbc)
    body = awgn(dvbt2_iq, RX_DVBT2_SNR_DB, RX_NOISE_SEED)[2048:spf]
    _, cells = rx2._cells(bbc, torch.from_numpy(body).to(dev))
    llr = rx2.soft_llrs(bbc, cells)
    g = torch.Generator(device=dev).manual_seed(DEC_NOISE_SEED)
    res["dvbt2_awgn"] = check_ldpc_kernels(
        f"bbc frame at {RX_DVBT2_SNR_DB} dB", bbc, llr, card)
    res["ldpc_slices"] = time_ldpc_slices(bbc, llr, card)
    res["dvbt2_noise"] = check_ldpc_kernels(
        "bbc frame of pure noise", bbc,
        torch.randn(llr.shape, generator=g, device=dev), card)
    blade = PROFILES["blade"]
    res["dvbt2_blade"] = check_ldpc_kernels(
        f"blade's {blade.fec_blocks} blocks at {LDPC_ES_N0_DB} dB Es/N0",
        blade, coded_llrs(blade, blade.fec_blocks, LDPC_ES_N0_DB,
                          DEC_NOISE_SEED, dev), card)
    short = dataclasses.replace(blade, frame_size=T2FrameSize.SHORT,
                                code_rate=T2CodeRate.R5_6)
    res["dvbt2_short_5_6"] = check_ldpc_kernels(
        "short 5/6 pure noise", short,
        torch.randn(llr.shape[0], short.nldpc, generator=g, device=dev),
        card)
    torch.cuda.empty_cache()
    return res


def _serve(dev, fn, init_state, block_bytes: int,
           samples_per_block: int) -> tuple[list[float], list[float]]:
    """bench.py's serving shape: 4 streams round-robin, one block per
    launch, a distinct device-resident input per launch, warm-up excluded.
    Returns three repeats each of Msamples/s (4 streams) and of ms per
    block on one stream."""
    from dtv_utils_torch.utils.timing import timed_stream

    g = torch.Generator(device=dev).manual_seed(2)

    def inputs(count):
        ts = torch.randint(0, 256, (count, block_bytes), generator=g,
                           device=dev, dtype=torch.uint8)
        ts[:, ::188] = 0x47
        return list(ts)

    msps, ms = [], []
    for _ in range(3):
        states = [init_state() for _ in range(N_STREAMS)]
        sec = timed_stream(fn, inputs(N_STREAMS * (1 + TIMED_ROUNDS)), states)
        msps.append(TIMED_ROUNDS * N_STREAMS * samples_per_block / sec / 1e6)
        sec = timed_stream(fn, inputs(1 + TIMED_ROUNDS), [init_state()])
        ms.append(sec / TIMED_ROUNDS * 1e3)
    return msps, ms


def serve(dev) -> tuple[list[float], list[float]]:
    """J.83B serving, one superblock per launch."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.tx import j83b as txq

    cfg = J83bConfig()
    return _serve(dev, lambda x, st: txq.modulate_superblock(cfg, x, st),
                  lambda: txq.init_state(cfg, device=dev),
                  txq.SUPERBLOCK_BYTES, 2 * txq.SUPERBLOCK_SYMBOLS)


def serve_dvbt(dev) -> tuple[list[float], list[float]]:
    """DVB-T flagship serving, one superframe per launch."""
    from dtv_utils_torch.tx import dvbt as txd

    cfg = dvbt_flagship()
    return _serve(dev, lambda x, st: txd.modulate_superframe(cfg, x, st),
                  lambda: txd.init_state(cfg, device=dev),
                  cfg.ts_bytes_per_superframe, cfg.samples_per_superframe)


def serve_dvbt2(dev) -> tuple[list[float], list[float]]:
    """DVB-T2 BBC serving, one T2 frame per launch."""
    from dtv_utils_torch.tx import dvbt2 as t2

    cfg = dvbt2_bbc()
    return _serve(dev, lambda x, st: t2.modulate_frame(cfg, x, st),
                  lambda: t2.init_state(cfg, device=dev),
                  cfg.payload_bytes_per_frame, t2.samples_per_frame(cfg))


def _union_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _trace_summary(prof):
    """Read a finished profiler session: its trace events, its device
    activities (kernels, copies, sets), their busy time (union of the
    intervals) and summed time in µs, and the host ops that launched device
    work as (self CUDA µs, calls, name), largest first."""
    from torch.autograd import DeviceType

    with tempfile.TemporaryDirectory() as d:
        trace = Path(d, "trace.json")
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    acts = [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not acts:
        raise AssertionError("the profiler recorded no device activity")
    busy_us = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in acts])
    rows = []
    for ev in prof.key_averages():        # host ops, each with its kernels
        self_us = getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type == DeviceType.CPU and self_us > 0:
            rows.append((self_us, ev.count, ev.key))
    # kernels no host op launched (the port's own, through ctypes), by name
    op_ids = {e["args"].get("External id") for e in events
              if e.get("cat") == "cpu_op"}
    bare: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in acts:
        if e.get("args", {}).get("External id") not in op_ids:
            bare[e["name"]][0] += e["dur"]
            bare[e["name"]][1] += 1
    rows += [(us, n, name) for name, (us, n) in bare.items()]
    return (events, acts, busy_us, sum(e["dur"] for e in acts),
            sorted(rows, reverse=True))


def profile_chain(dev, label: str, fn, init_state, block_bytes: int,
                  unit: str, detail=None) -> tuple[float, float]:
    """torch.profiler over PROFILE_ROUNDS rounds of 4-stream serving of
    ``out, st = fn(ts, st)``: prints the top device ops by self CUDA time;
    returns device-busy ms per block (union of kernel intervals) and
    device activities per block.  ``detail(events, n_blk, total_us)``, if
    given, reads more from the same run's trace events (with input
    shapes)."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(3)
    n = N_STREAMS * (1 + PROFILE_ROUNDS)
    ts = torch.randint(0, 256, (n, block_bytes), generator=g, device=dev,
                       dtype=torch.uint8)
    states = [init_state() for _ in range(N_STREAMS)]
    for s in range(N_STREAMS):                       # warm-up round
        _, states[s] = fn(ts[s], states[s])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=detail is not None) as prof:
        for i in range(N_STREAMS, n):
            s = i % N_STREAMS
            _, states[s] = fn(ts[i], states[s])
        torch.cuda.synchronize()
    n_blk = n - N_STREAMS
    events, kernels, busy_us, total, rows = _trace_summary(prof)
    busy_ms = busy_us / 1e3 / n_blk
    print(f"{label} profile: {n_blk} {unit}s, {len(kernels)} device "
          f"activities ({len(kernels) / n_blk:.1f} per {unit}), busy "
          f"{busy_ms:.4f} ms per {unit}; top ops by self CUDA time:")
    for self_us, count, key in rows[:12]:
        print(f"  {self_us / 1e3:9.3f} ms {100 * self_us / total:5.1f} % "
              f"{count / n_blk:5.1f}/{unit}  {key[:70]}")
    if detail is not None:
        detail(events, n_blk, total)
    return busy_ms, len(kernels) / n_blk


def _shapes(x):
    """Every [a, b] pair of ints in a profiler event's nested input shapes."""
    if isinstance(x, (list, tuple)):
        if len(x) == 2 and all(isinstance(v, int) for v in x):
            yield list(x)
        else:
            for v in x:
                yield from _shapes(v)


def profile_j83b(dev) -> dict[str, float]:
    """J.83B under the profiler, per superblock: device-busy ms, device
    activities, the FIR kernel's share of device time, and the launches
    and share of ``cat`` ops that join the 49-sample history to the
    superblock's cells (the concatenation the split FIR entry removed)."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.ops import fir
    from dtv_utils_torch.tx import j83b as txq

    cfg = J83bConfig()
    n = txq.SUPERBLOCK_SYMBOLS
    got: dict[str, float] = {}

    def detail(events, n_blk, total_us):
        kernels = [e for e in events if e.get("cat") == "kernel"]
        fir_us = sum(e["dur"] for e in kernels
                     if "fir_interp2" in e.get("name", ""))
        cats = set()
        for e in events:
            dims = list(_shapes(e.get("args", {}).get("Input Dims")))
            if e.get("name") == "aten::cat" and [2, fir.HIST] in dims \
                    and [2, n] in dims:
                cats.add(e["args"].get("External id"))
        cat_count = len(cats)
        cat_us = sum(e["dur"] for e in kernels
                     if e.get("args", {}).get("External id") in cats)
        got.update(fir_share=fir_us / total_us, cat_share=cat_us / total_us,
                   cat_per_block=cat_count / n_blk)
        print(f"j83b profile: FIR kernel {100 * fir_us / total_us:.2f} % of "
              f"device time ({fir_us / n_blk / 1e3:.5f} ms per superblock); "
              f"cat [2, {fir.HIST}] ++ [2, {n}]: {cat_count / n_blk:.1f} per "
              f"superblock, {100 * cat_us / total_us:.2f} % of device time")

    busy_ms, acts = profile_chain(
        dev, "j83b", lambda x, st: txq.modulate_superblock(cfg, x, st),
        lambda: txq.init_state(cfg, device=dev), txq.SUPERBLOCK_BYTES,
        "superblock", detail)
    return dict(busy_ms=busy_ms, activities=acts, **got)


def profile_dvbt(dev) -> tuple[float, float]:
    """The DVB-T flagship under the profiler, per superframe."""
    from dtv_utils_torch.tx import dvbt as txd

    cfg = dvbt_flagship()
    return profile_chain(
        dev, "dvbt", lambda x, st: txd.modulate_superframe(cfg, x, st),
        lambda: txd.init_state(cfg, device=dev),
        cfg.ts_bytes_per_superframe, "superframe")


def profile_dvbt2(dev) -> tuple[float, float]:
    """DVB-T2 BBC under the profiler, per T2 frame."""
    from dtv_utils_torch.tx import dvbt2 as t2

    cfg = dvbt2_bbc()
    return profile_chain(
        dev, "dvbt2", lambda x, st: t2.modulate_frame(cfg, x, st),
        lambda: t2.init_state(cfg, device=dev),
        cfg.payload_bytes_per_frame, "frame")


Batched = collections.namedtuple(
    "Batched", "label L block_bytes samples call pos0 serial state0")
Batched.__doc__ = """One chain's batched call: ``call(x [L, block_bytes],
pos)`` → (IQ of the L blocks, the stream position after them); ``pos0`` is
the position at a stream's block 0; ``serial(block, state)`` → (IQ, state)
is the one-block chain from ``state0()``; ``samples`` are complex samples
per block."""


def batched_dvbt(dev, L: int) -> Batched:
    """The DVB-T flagship through the eager batched call
    (``modulate_dvbt_blocks``, what ``batched_dvbt_modulator`` captures): a
    stream's position is (the previous superframe's 12-packet tail, its
    index, a 0-d int32 tensor)."""
    from dtv_utils_torch.parallel import stream as ps
    from dtv_utils_torch.tx import dvbt as txd

    cfg = dvbt_flagship()
    halo = ps.HALO_PACKETS * 188

    def call(x, pos):
        return (ps.modulate_dvbt_blocks(cfg, x, *pos),
                (x[-1, -halo:], pos[1] + x.shape[0]))
    return Batched(f"dvbt flagship L={L}", L, cfg.ts_bytes_per_superframe,
                   cfg.samples_per_superframe, call,
                   (torch.zeros(halo, dtype=torch.uint8, device=dev),
                    ps.block_index(0, dev)),
                   lambda b, st: txd.modulate_superframe(cfg, b, st),
                   lambda: txd.init_state(cfg, device=dev))


def batched_dvbt2(dev, L: int) -> Batched:
    """DVB-T2 BBC through the port's eager batched call
    (``modulate_dvbt2_blocks``, bench.py's shape at L = 4): a stream's
    position is (the last 187 raw bytes, frame index, a 0-d int32
    tensor)."""
    from dtv_utils_torch.parallel import stream as ps
    from dtv_utils_torch.tx import dvbt2 as t2

    cfg = dvbt2_bbc()

    def call(x, pos):
        return (ps.modulate_dvbt2_blocks(cfg, x, *pos),
                (x[-1, -ps.T2_HALO_BYTES:], pos[1] + x.shape[0]))
    return Batched(f"dvbt2 bbc L={L}", L, cfg.payload_bytes_per_frame,
                   t2.samples_per_frame(cfg), call,
                   (torch.zeros(ps.T2_HALO_BYTES, dtype=torch.uint8,
                                device=dev), ps.block_index(0, dev)),
                   lambda b, st: t2.modulate_frame(cfg, b, st),
                   lambda: t2.init_state(cfg, device=dev))


def batched_j83b(dev, L: int) -> Batched:
    """J.83B: L superblocks through ``modulate_superblock`` in one call
    (rails [2, L·2n], one FIR launch); the position is the chain state."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.tx import j83b as txq

    cfg = J83bConfig()

    def call(x, st):
        return txq.modulate_superblock(cfg, x.reshape(-1), st)
    return Batched(f"j83b L={L}", L, txq.SUPERBLOCK_BYTES,
                   2 * txq.SUPERBLOCK_SYMBOLS, call,
                   txq.init_state(cfg, device=dev),
                   lambda b, st: txq.modulate_superblock(cfg, b, st),
                   lambda: txq.init_state(cfg, device=dev))


def batched_chains(dev) -> list[Batched]:
    """The batched calls the script checks and times: DVB-T at each of
    BATCH_DVBT, DVB-T2 BBC and J.83B at BATCH_L."""
    return ([batched_dvbt(dev, L) for L in BATCH_DVBT]
            + [batched_dvbt2(dev, BATCH_L), batched_j83b(dev, BATCH_L)])


def _as_blocks(iq: torch.Tensor, L: int) -> torch.Tensor:
    """Batched IQ → [L, ...] per block (J.83B rails [2, L·2n] → [L, 2, 2n])."""
    if iq.is_complex():
        return iq.reshape(L, -1)
    return iq.reshape(2, L, -1).transpose(0, 1)


def check_batched(dev, b: Batched) -> tuple[torch.Tensor, torch.Tensor]:
    """Two calls of ``b`` over 2L consecutive blocks of seeded TS (block 0
    on, then a continuation) equal the serial one-block chain over the
    same blocks, bit for bit; both calls run again, warm, under
    ``set_sync_debug_mode("error")``.  A J.83B call must launch the FIR
    kernel exactly once.  Returns the first call's input and output."""

    ts = torch.from_numpy(seeded_ts(BATCH_SEED, 2 * b.L * b.block_bytes)
                          ).to(dev).reshape(2 * b.L, b.block_bytes)
    st, want = b.state0(), []
    for blk in ts:
        iq, st = b.serial(blk, st)
        want.append(iq)
    want = torch.stack(want)                # [2L, samples] or [2L, 2, 2n]
    got = []
    for sync_mode in (0, "error"):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(sync_mode)
        try:
            pos, got = b.pos0, []
            for x in (ts[:b.L], ts[b.L:]):
                launches = _build.LAUNCHES["fir_interp2"]
                iq, pos = b.call(x, pos)
                launches = _build.LAUNCHES["fir_interp2"] - launches
                if not iq.is_complex() and launches != 1:
                    raise AssertionError(f"{b.label}: {launches} FIR launches "
                                         "in one call")
                got.append(_as_blocks(iq, b.L))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    got_all = torch.cat(got)
    if not torch.equal(got_all, want):
        bad = (got_all != want).reshape(2 * b.L, -1).any(1).nonzero()
        raise AssertionError(f"{b.label}: batched IQ differs from the serial "
                             f"chain in blocks {bad.reshape(-1).tolist()}")
    print(f"{b.label}: 2 batched calls ({2 * b.L} blocks, the second a "
          "continuation) equal the serial chain bit for bit, no host sync"
          + (", 1 FIR launch per call" if not want.is_complex() else ""))
    return ts[:b.L], got[0]


def _call_activities(calls: dict, inputs) -> dict[str, tuple[float, float]]:
    """For each ``calls[name](x)``: (device activities, busy µs) per call
    under the profiler, over ``inputs[1:]`` after an untimed call on
    ``inputs[0]``, so no profiled call reads an input a call before it
    read.  Each call runs alone in a ``record_function`` range and its
    activities are those launched inside it; spin kernels before and after
    keep the calls away from the edges of the profiler's window, where a
    short profiler session was seen to lose a third of them."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn(inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PROFILE_PAD_CYCLES)
        for x in inputs[1:]:
            for name, fn in calls.items():
                with record_function(name):
                    fn(x)
                torch.cuda.synchronize()
        torch.cuda._sleep(PROFILE_PAD_CYCLES)
        torch.cuda.synchronize()
    events, acts, _, _, _ = _trace_summary(prof)
    n = len(inputs) - 1
    out = {}
    for name in calls:
        inside = _range_activities(events, acts, name)
        out[name] = (len(inside) / n, _union_us(
            [(e["ts"], e["ts"] + e["dur"]) for e in inside]) / n)
    return out


def _batch_inputs(dev, b: Batched, count: int) -> list[torch.Tensor]:
    g = torch.Generator(device=dev).manual_seed(4)
    ts = torch.randint(0, 256, (count, b.L, b.block_bytes), generator=g,
                       device=dev, dtype=torch.uint8)
    ts[:, :, ::188] = 0x47
    return list(ts)


def serve_batched(dev, card: str, b: Batched, one: Batched) -> list[float]:
    """Batched serving of one stream, L blocks per call, on the step-8
    protocol (a distinct device-resident input per call, warm-up excluded,
    CUDA events, 3 repeats of BATCH_ROUNDS calls); device activities and
    busy time per call under the profiler (BATCH_PROFILED calls on
    distinct inputs), at L and at 1 (fails if the L call makes
    BATCH_MAX_GROWTH times the L = 1 call's activities or more); peak
    memory of one call.  Every profiled and measured call continues its
    stream, as every timed call does.  Prints one line, ending with the
    card; returns the repeats' Msamples/s."""
    from dtv_utils_torch.utils.timing import timed_stream

    msps, call_ms = [], []
    for _ in range(3):
        sec = timed_stream(b.call, _batch_inputs(dev, b, 1 + BATCH_ROUNDS),
                           [b.pos0])
        msps.append(BATCH_ROUNDS * b.L * b.samples / sec / 1e6)
        call_ms.append(sec / BATCH_ROUNDS * 1e3)
    xs = _batch_inputs(dev, b, 1 + BATCH_PROFILED)
    pos = {"batched_call": b.pos0, "one_block_call": one.pos0}

    def continuing(name: str, c: Batched):
        def fn(x):
            _, pos[name] = c.call(x[:c.L], pos[name])
        return fn
    got = _call_activities({"batched_call": continuing("batched_call", b),
                            "one_block_call": continuing("one_block_call",
                                                         one)}, xs)
    (acts, busy_us), (acts1, _) = got["batched_call"], got["one_block_call"]
    _, peak = _peak(dev, lambda: b.call(xs[0], pos["batched_call"]))
    busy_ms = busy_us / 1e3
    share = busy_ms / sorted(call_ms)[1]
    print(f"{b.label} batched serving, {_tf32()}: {_repeats(msps)} "
          f"Msamples/s (one stream, {b.L} blocks per call, {BATCH_ROUNDS} "
          f"timed calls each); {sorted(call_ms)[1]:.4f} ms per call, device "
          f"{busy_ms / b.L:.4f} ms per block, busy share {share:.3f}; "
          f"{acts:.1f} device activities per call ({acts1:.1f} at L=1); "
          f"peak {peak / 1e9:.3f} GB per call; on {card}")
    if acts >= BATCH_MAX_GROWTH * acts1:
        raise AssertionError(f"{b.label}: {acts} device activities per call "
                             f"against {acts1} at L=1")
    return msps


def check_sharded(dev, firsts: dict[str, tuple]) -> None:
    """World size 1 in an NCCL process group (file rendezvous in a temp
    dir, closed afterwards): each sharded modulator equals the batched
    call on the same blocks (``firsts``: label → (input, batched IQ)).
    Then ``entry`` and ``dryrun_multichip(1)``."""
    import torch.distributed as dist

    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.entry import dryrun_multichip, entry
    from dtv_utils_torch.parallel import multihost as mh
    from dtv_utils_torch.parallel import stream as ps
    from dtv_utils_torch.tx import dvbt as txd

    shard = {"dvbt": ps.sharded_dvbt_modulator, "dvbt2":
             ps.sharded_dvbt2_modulator, "j83b": ps.sharded_j83b_modulator}
    cfgs = {"dvbt": dvbt_flagship(), "dvbt2": dvbt2_bbc(),
            "j83b": J83bConfig()}
    with tempfile.TemporaryDirectory() as d:
        mh.initialize(Path(d, "rendezvous").as_uri(), 1, 0, device=dev)
        try:
            backend = dist.get_backend()
            for label, (x, want) in firsts.items():
                name = label.split()[0]
                got = shard[name](cfgs[name])(x)
                if not torch.equal(got, want):
                    raise AssertionError(f"{label}: sharded at world size 1 "
                                         "differs from batched")
                print(f"{label}: sharded ({backend}, world size 1) equals "
                      "batched")
        finally:
            dist.destroy_process_group()
    fn, args = entry(device="cuda")
    iq, _ = fn(*args)
    want, _ = txd.modulate_superframe(dvbt_flagship(), *args)
    if not torch.equal(iq, want):
        raise AssertionError("entry() differs from modulate_superframe")
    t0 = time.perf_counter()
    dryrun_multichip(1)
    print(f"entry(device='cuda') equals modulate_superframe; "
          f"dryrun_multichip(1) ok in {time.perf_counter() - t0:.1f} s")


def time_papr(dev) -> list[float]:
    """bench.py's PAPR shape: a 64M-complex chunk generated on the card,
    pass 1 + pass 2 with 13 levels; three repeats of GSa/s."""
    from dtv_utils_torch.analysis import papr
    from dtv_utils_torch.utils.timing import time_cuda

    g = torch.Generator(device=dev).manual_seed(5)
    raw = torch.randn(2 * PAPR_CHUNK, generator=g, device=dev)
    levels = torch.from_numpy(np.power(10.0, np.arange(PAPR_LEVELS) / 10.0)
                              .astype(np.float32)).to(dev)
    return [PAPR_CHUNK / time_cuda(
        lambda: (papr._pass1_chunk(raw), papr._pass2_chunk(raw, levels)),
        iters=10) / 1e6 for _ in range(3)]


def profile_stages(dev, card: str, fir_t: dict, serve_busy: dict) -> None:
    """Step 12: ``utils/profile.py``'s chains on the card, TF32 off, one
    chain at a time (DVB-T at the flagship, the others at the reference's
    configs).  Each row must lie within PROFILE_MAX_PCT of the H100's
    roofline, have a finite time and have run on the card: allocated there,
    and device time per call > 0 with PROFILE_QUEUED more calls queued
    behind a spin kernel, so no host gap enters (``_queued_ms``; the
    profiler, asked per stage, lost most activities after the serving
    profiles).  The FIR kernel must launch in
    every call of the J.83B rows that run it and in no other row; the
    ``rrc_interpolate`` row may be no faster than PROFILE_FIR_FLOOR of step
    3's warm kernel, and each FULL row no faster than PROFILE_FULL_FLOOR
    of the device-busy ms per block that steps 8-9 measured."""
    from dtv_utils_torch.utils import profile

    real = profile.profile_fn
    seen: list[tuple] = []

    def checked(name, fn, args, n_variants=6):
        before = _build.LAUNCHES["fir_interp2"]
        rep = real(name, fn, args, n_variants)
        launches = _build.LAUNCHES["fir_interp2"] - before
        seen.append((rep, launches, n_variants, _queued_ms(
            [functools.partial(fn, *args)] * PROFILE_QUEUED)))
        return rep

    torch.backends.cuda.matmul.allow_tf32 = False
    bound_ms = max(fir_bounds_ms(FIR_SIZES[0]))
    with _patched(profile, "profile_fn", checked):
        for chain in PROFILE_CHAINS:
            seen.clear()
            if chain == "j83b":
                _build.LAUNCHES["fir_interp2"] = 0
            t0 = time.perf_counter()
            if chain == "dvbt":
                reps = profile.dvbt_stages(dvbt_flagship(), device=dev)
            else:
                reps = profile.CHAINS[chain](device=dev)
            if [r.name for r in reps] != [r.name for r, *_ in seen]:
                raise AssertionError(f"{chain}: rows {[r.name for r in reps]}")
            print(f"== profile {chain} ({time.perf_counter() - t0:.1f} s), "
                  f"{_tf32()}, on {card} ==")
            print(profile.format_table(reps))
            for r, launches, n_var, device_ms in seen:
                print(f"  {r.name:<26} temp {r.temp_bytes / 1e6:9.3f} MB, "
                      f"device {device_ms:.4f} ms per queued call "
                      f"({device_ms / r.ms:.3f} of the row's ms), FIR "
                      f"launches {launches}")
                if not (np.isfinite(r.ms) and r.ms > 0):
                    raise AssertionError(f"{chain} {r.name}: ms {r.ms}")
                if r.roofline_pct is None or r.roofline_pct > PROFILE_MAX_PCT:
                    raise AssertionError(
                        f"{chain} {r.name}: {r.roofline_pct} % of the "
                        "roofline")
                if not (device_ms > 0 and r.temp_bytes > 0):
                    raise AssertionError(f"{chain} {r.name}: no device work")
                runs_fir = chain == "j83b" and r.name in PROFILE_FIR_ROWS
                if runs_fir and launches < n_var - 1 or \
                        not runs_fir and launches:
                    raise AssertionError(f"{chain} {r.name}: {launches} FIR "
                                         f"launches for {n_var - 1} timed "
                                         "calls")
            if chain == "j83b":
                rrc = next(r for r in reps if r.name == "rrc_interpolate")
                if rrc.ms < PROFILE_FIR_FLOOR * fir_t["kernel_warm"]:
                    raise AssertionError(
                        f"rrc_interpolate row {rrc.ms:.5f} ms is faster "
                        "than step 3's warm kernel "
                        f"{fir_t['kernel_warm']:.5f}")
                print(f"profile j83b rrc_interpolate: {rrc.ms:.5f} ms, "
                      f"{bound_ms / rrc.ms:.3f} of the {bound_ms:.5f} ms "
                      f"bound (step 3's kernel cold: "
                      f"{bound_ms / fir_t['kernel_cold']:.3f}, warm "
                      f"{fir_t['kernel_warm']:.5f} ms), {_build.LAUNCHES['fir_interp2']} "
                      f"FIR launches in the chain")
            if chain in serve_busy:
                full = next(r for r in reps if r.name.startswith("FULL"))
                ratio = full.ms / serve_busy[chain]
                print(f"profile {chain} {full.name}: {full.ms:.4f} ms, "
                      f"{ratio:.3f} x the {serve_busy[chain]:.4f} ms device "
                      "busy per block of one-block serving (steps 8-9)")
                if ratio < PROFILE_FULL_FLOOR:
                    raise AssertionError(f"{chain} {full.name} is faster "
                                         "than the card's busy time")


def check_profile_cli(card: str) -> None:
    """``dtv profile -j papr`` in a subprocess: one JSON row per stage on
    stdout, each scored against the roofline."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "dtv_utils_torch.cli",
                          "profile", "-j", "papr"], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    if run.returncode:
        raise AssertionError(f"dtv profile -j papr: {run.returncode}\n"
                             f"{run.stderr[-2000:]}")
    rows = [json.loads(ln) for ln in run.stdout.splitlines()
            if ln.startswith("{")]
    names = [r["metric"] for r in rows]
    if names != ["profile.papr.pass1 (power+peaks+rails)",
                 "profile.papr.pass2 (ccdf histogram)"] or any(
                     r["roofline_pct"] is None for r in rows):
        raise AssertionError(f"dtv profile -j papr printed {rows}")
    for r in rows:
        print(f"cli {r['metric']}: {r['value']} ms, {r['roofline_pct']} % "
              f"of the roofline ({r['bound']}), tf32={r['tf32']}, on {card}")
    print(f"dtv profile -j papr: {time.perf_counter() - t0:.1f} s")


def check_rates_native() -> None:
    """The rate oracles through the port's CLI, and the native analyzers
    built by the port, against ``tests/golden`` byte for byte."""
    import io

    from dtv_utils_torch.analysis import native
    from dtv_utils_torch.cli import main as cli

    golden_dir = ROOT / "tests" / "golden"
    for argv, golden in RATE_CASES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        if rc or buf.getvalue().encode() != (golden_dir / golden).read_bytes():
            raise AssertionError(f"dtv {' '.join(argv)}: exit {rc}, output "
                                 f"differs from {golden}")
    print(f"rates: {len(RATE_CASES)} dvbtrate/dvbs2rate/atsc3rate reports "
          "equal their goldens")
    t0 = time.perf_counter()
    d = native.ensure_built()
    print(f"native tools built in {time.perf_counter() - t0:.1f} s "
          f"({d.relative_to(ROOT)})")
    sys.path.insert(0, str(ROOT / "tests"))
    import h264_gen
    import l1_gen
    import ts_gen

    with tempfile.TemporaryDirectory() as tmp:
        cases = []
        for name, make in sorted(l1_gen.SCENARIOS.items()):
            f = Path(tmp, f"{name}.b64")
            f.write_bytes(make())
            cases.append(("l1dump", [str(f)], f"l1dump_{name}.txt"))
        f = Path(tmp, "progressive_main.264")
        f.write_bytes(h264_gen.make_stream(interlaced=False, profile=77))
        cases.append(("flags264", [str(f)], "flags264_progressive_main.txt"))
        f = Path(tmp, "in.ts")
        f.write_bytes(ts_gen.make_ts())
        cases.append(("xport", [str(f), "1", "1", "1"], "xport_basic.txt"))
        for tool, args, golden in cases:
            run = native.run(tool, args, capture_output=True, cwd=tmp,
                             timeout=120)
            if run.returncode or \
                    run.stdout != (golden_dir / golden).read_bytes():
                raise AssertionError(f"{tool} {args}: exit {run.returncode},"
                                     f" output differs from {golden}")
    print(f"native: {len(cases)} l1dump/flags264/xport outputs equal their "
          "goldens")


Chain = collections.namedtuple(
    "Chain", "label blocks block_bytes samples graph eager state0 static")
Chain.__doc__ = """One captured chain of the graphs step: ``graph(x, st)``
and ``eager(x, st)`` → (IQ, next st) on the same inputs, ``x`` uint8
[blocks * block_bytes] (or [blocks, block_bytes]); ``state0()`` a stream's
start; ``static(x, st)`` the ``StaticCall`` the graph runs; ``samples``
per block."""


def graph_chains(dev) -> list[Chain]:
    """The graphs step's chains at full width: DVB-T flagship, DVB-T2 BBC
    at one frame per call (``jit_modulator``), the blade profile with tone
    reservation (``--papr``: the ``_tr_step`` loop inside the graph),
    J.83B, and BBC at bench.py's 4 frames through the captured batched
    runner (a stream's state is the last 187 raw bytes and the frame
    index, a 0-d int32 tensor)."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.parallel import stream as ps
    from dtv_utils_torch.tx import dvbt as txd
    from dtv_utils_torch.tx import dvbt2 as t2
    from dtv_utils_torch.tx import j83b as txq

    out = []
    for label, mod, cfg, eager, blk, spb in (
            ("dvbt flagship", txd, dvbt_flagship(), txd.modulate_superframe,
             dvbt_flagship().ts_bytes_per_superframe,
             dvbt_flagship().samples_per_superframe),
            ("dvbt2 bbc", t2, dvbt2_bbc(), t2.modulate_frame,
             dvbt2_bbc().payload_bytes_per_frame,
             t2.samples_per_frame(dvbt2_bbc())),
            ("dvbt2 blade papr", t2, dvbt2_papr(), t2.modulate_frame,
             dvbt2_papr().payload_bytes_per_frame,
             t2.samples_per_frame(dvbt2_papr())),
            ("j83b", txq, J83bConfig(), txq.modulate_superblock,
             txq.SUPERBLOCK_BYTES, 2 * txq.SUPERBLOCK_SYMBOLS)):
        fn = mod.jit_modulator(cfg, device=dev)
        out.append(Chain(label, 1, blk, spb, fn, functools.partial(
            eager, cfg), functools.partial(mod.init_state, cfg, device=dev),
            fn.static_call))
    cfg = dvbt2_bbc()
    run = ps._batched_dvbt2_modulator(cfg, device=dev)
    jit = ps._jit_blocks(ps.modulate_dvbt2_blocks, cfg, dev)

    def advance(x, pos):
        return x[-1, -ps.T2_HALO_BYTES:], pos[1] + x.shape[0]

    def state0():
        return (torch.zeros(ps.T2_HALO_BYTES, dtype=torch.uint8, device=dev),
                ps.block_index(0, dev))
    out.append(Chain(
        f"dvbt2 bbc L={BATCH_L} batched", BATCH_L,
        cfg.payload_bytes_per_frame, t2.samples_per_frame(cfg),
        lambda x, pos: (run(x, *pos), advance(x, pos)),
        lambda x, pos: (ps.modulate_dvbt2_blocks(cfg, x, *pos),
                        advance(x, pos)),
        state0, lambda x, pos: jit.static_call(x, *pos)))
    return out


def _leaves(x) -> list[torch.Tensor]:
    """The tensors of a state (a dataclass or a tuple)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    return [t for v in x for t in _leaves(v)]


def _graph_inputs(dev, c: Chain, count: int) -> list[torch.Tensor]:
    g = torch.Generator(device=dev).manual_seed(GRAPH_SEED)
    ts = torch.randint(0, 256, (count, c.blocks, c.block_bytes),
                       generator=g, device=dev, dtype=torch.uint8)
    ts[:, :, ::188] = 0x47
    return list(ts if c.blocks > 1 else ts.reshape(count, -1))


def _timed_calls(fn, inputs: list, states: list) -> tuple[float, float]:
    """Host µs per call to enqueue ``out, states[s] = fn(x, states[s])``
    round-robin over ``inputs`` (one untimed round first), and the device
    window's ms per call between CUDA events around them."""
    n = len(states)
    for s, x in enumerate(inputs[:n]):
        _, states[s] = fn(x, states[s])
    timed = inputs[n:]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    t0 = time.perf_counter()
    for i, x in enumerate(timed):
        _, states[i % n] = fn(x, states[i % n])
    host_s = time.perf_counter() - t0
    ev[1].record()
    torch.cuda.synchronize()
    return host_s / len(timed) * 1e6, ev[0].elapsed_time(ev[1]) / len(timed)


class GraphLaunches:
    """The kernel launches of the graph calls alone: ``wrap(fn)`` is
    ``fn`` with the change of every launch count around each of its calls
    added to ``counts``; the eager calls made beside them add nothing."""

    def __init__(self):
        self.counts = dict.fromkeys(_build.LAUNCHES, 0)

    def wrap(self, fn):
        def counted(*args):
            before = dict(_build.LAUNCHES)
            out = fn(*args)
            for k, n in _build.LAUNCHES.items():
                self.counts[k] += n - before[k]
            return out
        return counted


def check_graph_chain(dev, card: str, c: Chain, tally: GraphLaunches
                      ) -> dict:
    """One chain of the graphs step: GRAPH_CALLS calls × N_STREAMS streams
    round-robin through the graph (the first captures, under
    ``set_sync_debug_mode("error")`` like every graph call here) and the
    eager chain on the same inputs, IQ and state equal bit for bit after
    every call; the bounded table caches cleared after the first round
    (the graph keeps reading what it was captured on); the first call's
    result unchanged after the last; J.83B's FIR launched once per call;
    then host µs per call and Msamples/s, eager and graph in alternating
    pairs, device ms per block queued behind a spin, capture seconds and
    the shared pool's MiB.  Every graph call goes through ``tally``.
    Returns the figures."""
    from dtv_utils_torch.tx import dvbt as txd
    from dtv_utils_torch.tx import dvbt2 as t2
    from dtv_utils_torch.utils import graph

    inputs = _graph_inputs(dev, c, GRAPH_CALLS * N_STREAMS)
    graph_fn = tally.wrap(c.graph)
    gs = [c.state0() for _ in range(N_STREAMS)]
    es = [c.state0() for _ in range(N_STREAMS)]
    first, junk = None, []
    pool0 = graph.pool_bytes(dev)
    for i, x in enumerate(inputs):
        s = i % N_STREAMS
        if i == N_STREAMS:      # after the capture: evict, reuse memory
            txd.dispersal_rows.cache_clear()
            t2._stream_plan.cache_clear()
            junk = [torch.full((1 << k,), 0xA5, dtype=torch.uint8,
                               device=dev)
                    for k in range(9, 27) for _ in range(GRAPH_JUNK)]
        elif i == 2 * N_STREAMS:
            junk.clear()
        launches = _build.LAUNCHES["fir_interp2"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            iq, gs[s] = graph_fn(x, gs[s])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        fir_launches = _build.LAUNCHES["fir_interp2"] - launches
        want, es[s] = c.eager(x, es[s])
        if not (torch.equal(iq, want) and all(
                torch.equal(a, b) for a, b in zip(_leaves(gs[s]),
                                                  _leaves(es[s])))):
            raise AssertionError(f"{c.label}: call {i} (stream {s}) of the "
                                 "graph differs from the eager chain")
        if c.label == "j83b" and fir_launches != 1:
            raise AssertionError(f"{c.label}: call {i} launched the FIR "
                                 f"{fir_launches} times")
        if first is None:
            first = (iq, gs[s], iq.clone(), [t.clone() for t in
                                            _leaves(gs[s])])
    if not (torch.equal(first[0], first[2]) and all(
            torch.equal(a, b) for a, b in zip(_leaves(first[1]), first[3]))):
        raise AssertionError(f"{c.label}: a later call changed the first "
                             "call's result")
    sc = c.static(inputs[0], c.state0())
    digest = sha256(*(t.cpu().numpy() for s in gs for t in _leaves(s)))
    if digest != sha256(*(t.cpu().numpy() for s in es for t in _leaves(s))):
        raise AssertionError(f"{c.label}: state digests differ")
    pool = graph.pool_bytes(dev)
    runs: dict[str, list] = {"eager": [], "graph": []}
    for side in ("eager", "graph", "graph", "eager", "eager", "graph"):
        fn = c.eager if side == "eager" else graph_fn
        runs[side].append(_timed_calls(
            fn, inputs, [c.state0() for _ in range(N_STREAMS)]))
    dev_ms = {}
    for side, fn in (("eager", c.eager), ("graph", graph_fn)):
        st = c.state0()
        dev_ms[side] = _queued_ms([functools.partial(fn, x, st)
                                   for x in inputs[:GRAPH_QUEUED]]) / c.blocks
    res = {"label": c.label, "capture_s": sc.capture_s,
           "pool_mib": pool / 2**20, "pool_added_mib": (pool - pool0) / 2**20,
           "launches_per_replay": sc.launches,
           "state_sha256": digest}
    for side in ("eager", "graph"):
        host = [h for h, _ in runs[side]]
        window = [w for _, w in runs[side]]
        res[side] = {
            "host_us_per_call": host,
            "msps": [c.blocks * c.samples / w / 1e3 for w in window],
            "device_ms_per_block": dev_ms[side],
            "busy_share": [dev_ms[side] * c.blocks / w for w in window]}
    print(f"graphs {c.label}: {GRAPH_CALLS} calls x {N_STREAMS} streams "
          f"equal to the eager chain bit for bit (IQ and state, state "
          f"sha256 {digest[:16]}), the first call's result unchanged, "
          f"captured in {sc.capture_s:.3f} s, launches per replay "
          f"{res['launches_per_replay']}, pool {res['pool_mib']:.1f} MiB "
          f"(+{res['pool_added_mib']:.1f}); on {card}")
    for side in ("eager", "graph"):
        r = res[side]
        print(f"graphs {c.label} {side}, {_tf32()}: host "
              f"{', '.join(f'{v:.1f}' for v in r['host_us_per_call'])} µs "
              f"per call; {', '.join(f'{v:.3f}' for v in r['msps'])} "
              f"Msamples/s ({N_STREAMS} streams, pairs eager/graph in "
              f"turns); device {r['device_ms_per_block']:.4f} ms per block, "
              f"busy share {', '.join(f'{v:.3f}' for v in r['busy_share'])}"
              f"; on {card}")
    return res


def check_jit_decode(dev, card: str, tally: GraphLaunches) -> dict:
    """``jit_decode`` on BBC's 2 frames (404 codewords of the BBC code,
    BPSK at LDPC_ES_N0_DB) equal to ``decode``'s hard bits and ``ok``, on
    the capture and on a replay on other LLRs; each replay makes 61
    min-sum launches.  Every graph call goes through ``tally``.  Returns
    host ms and device ms per call, graph and eager."""
    from dtv_utils_torch.ops import ldpc_decode as ld

    cfg = dvbt2_bbc()
    fn = tally.wrap(ld.jit_decode(cfg, LDPC_ITERATIONS, device=dev))
    llrs = [coded_llrs(cfg, 2 * cfg.fec_blocks, LDPC_ES_N0_DB, seed, dev)
            for seed in (GRAPH_SEED, GRAPH_SEED + 1)]
    for llr in llrs:
        before = dict(_build.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            hard, ok = fn(llr)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        made = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                if n != before[k]}
        want_hard, want_ok = ld.decode(cfg, llr, LDPC_ITERATIONS)
        if not (torch.equal(hard, want_hard) and torch.equal(ok, want_ok)):
            raise AssertionError("jit_decode differs from decode")
        if made != {"ldpc_check": LDPC_ITERATIONS,
                    "ldpc_variable": LDPC_ITERATIONS + 1}:
            raise AssertionError(f"jit_decode launched {made}")
    res = {}
    for side, f in (("eager", lambda x: ld.decode(cfg, x, LDPC_ITERATIONS)),
                    ("graph", fn)):
        f(llrs[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f(llrs[1])
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        res[side] = {"host_ms": host_ms,
                     "device_ms": _queued_ms([functools.partial(f, llrs[1])]
                                             * 3)}
    print(f"graphs jit_decode bbc, {llrs[0].shape[0]} codewords: equal to "
          f"decode (hard bits, ok) on the capture and a replay, "
          f"{LDPC_ITERATIONS} check + {LDPC_ITERATIONS + 1} variable "
          f"launches per replay, all ok {bool(ok.all())}; host ms per call "
          f"eager {res['eager']['host_ms']:.3f}, graph "
          f"{res['graph']['host_ms']:.3f}; device ms eager "
          f"{res['eager']['device_ms']:.4f}, graph "
          f"{res['graph']['device_ms']:.4f}; on {card}")
    return res


def check_graphs(dev, card: str) -> dict:
    """Step 12b: the captured calls at full width (``graph_chains`` and
    ``jit_decode``).  The kernel launches of the graph calls alone are
    counted, from 0 (the eager calls they are compared with count
    nothing); fails if the FIR or a min-sum kernel was launched in no
    graph.  Returns each chain's figures and those launches."""
    from dtv_utils_torch.utils import graph

    t0 = time.perf_counter()
    graph.release(dev)
    torch.cuda.empty_cache()
    print(f"host probe: {host_probe_us(dev):.3f} µs per tiny launch, on "
          f"{card}")
    tally = GraphLaunches()
    chains = [check_graph_chain(dev, card, c, tally)
              for c in graph_chains(dev)]
    decode = check_jit_decode(dev, card, tally)
    launches = {k: tally.counts[k] for k in GRAPH_KERNELS}
    if not all(launches.values()) or any(
            n for k, n in tally.counts.items() if k not in GRAPH_KERNELS):
        raise AssertionError(f"graphs: the graphs' kernel launches "
                             f"{tally.counts}, want {GRAPH_KERNELS} and no "
                             "other")
    print(f"graphs kernel launches (in graph replays only): {launches}; pool "
          f"{graph.pool_bytes(dev)} bytes; graphs phase "
          f"{time.perf_counter() - t0:.1f} s")
    graph.release(dev)
    torch.cuda.empty_cache()
    return {"chains": chains, "jit_decode": decode, "launches": launches}


def check_bench(card: str, steps: dict[str, float]) -> int:
    """Step 13: the port's bench surfaces on the card.  ``bench_j83b`` in
    this process with a short deadline: its line, and one FIR kernel
    launch per superblock it launched (the FIR's count set to 0 first).
    Then ``python -m dtv_utils_torch.bench --stress`` as a child: exit 0,
    each of the four metrics' last line finite, value > 0, vs_baseline > 1,
    naming this card, printed beside ``steps``' median of the same shape;
    and ``python -m dtv_utils_torch.scaling_bench --gpu``'s row.  Returns
    the FIR's launches in ``bench_j83b``."""
    from dtv_utils_torch import bench
    from dtv_utils_torch.utils.metrics import Metrics

    t0 = time.perf_counter()
    sink = io.StringIO()
    _build.LAUNCHES["fir_interp2"] = 0
    bench.bench_j83b(Metrics(json_out=sink, suppress_human=True),
                     time.perf_counter() + BENCH_J83B_S)
    launches = _build.LAUNCHES["fir_interp2"]
    if not sink.getvalue():
        raise AssertionError("bench_j83b emitted no line")
    last = json.loads(sink.getvalue().splitlines()[-1])
    superblocks = bench.N_STREAMS * (1 + 2 * last["segments_completed"])
    if launches != superblocks:
        raise AssertionError(f"bench_j83b launched {superblocks} "
                             f"superblocks and the FIR kernel {launches} "
                             "times")
    print(f"bench_j83b in process: {last['value']:.3f} {last['unit']} over "
          f"{last['segments_completed']} segments, {launches} FIR launches "
          f"for {superblocks} superblocks, on {last['device']}")

    run = subprocess.run(
        [sys.executable, "-m", "dtv_utils_torch.bench", "--stress",
         str(BENCH_STRESS_S)], capture_output=True, text=True, cwd=ROOT,
        timeout=len(bench.ORDER) * BENCH_STRESS_S + 60)
    lines = {}
    for ln in run.stdout.splitlines():
        if ln.startswith("{"):
            rec = json.loads(ln)
            lines[rec["metric"]] = rec
    if run.returncode or set(lines) != set(bench.METRIC_OF.values()):
        raise AssertionError(f"bench --stress {BENCH_STRESS_S}: exit "
                             f"{run.returncode}, lines for {sorted(lines)}"
                             f"\n{run.stderr[-3000:]}")
    for name in bench.ORDER:
        rec = lines[bench.METRIC_OF[name]]
        if not (math.isfinite(rec["value"]) and rec["value"] > 0
                and rec["vs_baseline"] > 1 and rec["device"] == card):
            raise AssertionError(f"bench {name}: {rec}")
        print(f"bench --stress {BENCH_STRESS_S:g} {rec['metric']}: "
              f"{rec['value']:.3f} {rec['unit']} (vs_baseline "
              f"{rec['vs_baseline']:.3f}, {rec['segments_completed']} "
              f"segments, runs {', '.join(f'{v:.3f}' for v in rec['runs'])},"
              f" blocks per launch {rec.get('blocks_per_dispatch', '-')}, "
              f"tf32={rec['tf32']}) beside the step's median "
              f"{steps[name]:.3f}, on {rec['device']}")
        print(f"bench line: {json.dumps(rec)}")

    run = subprocess.run(
        [sys.executable, "-m", "dtv_utils_torch.scaling_bench", "--gpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    rows = [json.loads(ln) for ln in run.stdout.splitlines()
            if ln.startswith("{")]
    if run.returncode or not any(r["world"] == 1 for r in rows):
        raise AssertionError(f"scaling_bench --gpu: exit {run.returncode}, "
                             f"rows {rows}\n{run.stderr[-3000:]}")
    for r in rows:
        print(f"scaling_bench --gpu: {json.dumps(r)}")
    for ln in run.stderr.splitlines():
        if "no row" in ln:
            print(ln)
    print(f"bench phase: {time.perf_counter() - t0:.1f} s")
    return launches


def _tf32() -> str:
    return f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"


def _repeats(vals: list[float], fmt: str = ".3f") -> str:
    return (f"median {sorted(vals)[1]:{fmt}} "
            f"(repeats {', '.join(f'{v:{fmt}}' for v in vals)})")


def host_probe_us(dev) -> float:
    """Host µs per launch of HOST_PROBE_LAUNCHES tiny in-place adds,
    enqueued back to back (the card runs each faster than the host
    enqueues it): the launch cost every eager chain pays."""
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_PROBE_LAUNCHES):
        x.add_(1)
    us = (time.perf_counter() - t0) / HOST_PROBE_LAUNCHES * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    from dtv_utils_torch import resolve_device
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.tx import j83b as txq
    from dtv_utils_torch.utils import graph

    golden = json.loads(GOLDEN.read_text())
    dvbt_golden = json.loads(DVBT_GOLDEN.read_text())
    dvbt2_golden = json.loads(DVBT2_GOLDEN.read_text())
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(dev)

    # 1. device
    card = card_line(dev)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # 2. build, and ptxas's report of registers, shared memory and spills
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"built {Path(lib._name).name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if line.strip():
            print(f"  {line.strip()}")

    # 3. FIR kernel against its plain version, without TF32 in the plain one
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    taps = txq.rrc_taps(J83bConfig())
    max_err = check_fir(dev, taps)
    t = time_fir(dev, taps)
    bytes_ms, ops_ms = fir_bounds_ms(FIR_SIZES[0])
    bound_ms = max(bytes_ms, ops_ms)
    for side in ("kernel", "plain", "library"):
        print(f"fir n={FIR_SIZES[0]} {side}: cold {t[side + '_cold']:.5f} ms "
              f"({bound_ms / t[side + '_cold']:.3f} of the bound), warm "
              f"{t[side + '_warm']:.5f} ms, on {card}")
    print(f"fir bounds on an H100 SXM: HBM {bytes_ms:.5f} ms, FMA "
          f"{ops_ms:.5f} ms")

    # 4. the J.83B slice, then the same input through the CLI
    launches, iq = check_slice(dev, golden)
    if launches != golden["superblocks"]:
        raise AssertionError(f"the FIR kernel ran {launches} times for "
                             f"{golden['superblocks']} superblocks")
    check_cli(golden, iq, "cuda")

    # 5. the DVB-T slice, its CLI with state resume, and PAPR
    dvbt_iq, _ = check_dvbt_slice(dev, dvbt_golden)
    check_dvbt_cli(dvbt_golden, dvbt_iq, "cuda")
    check_papr(dev, dvbt_golden, dvbt_iq)

    # 6. DVB-T2: BBC host plan, the stand-in tables, the BBC slice and a
    # tone-reservation frame against the golden, then dvbt2-mod
    plan_s, upload_s = time_dvbt2_plan(dev)
    print(f"dvbt2 bbc host plan: {plan_s:.3f} s to build the tables, "
          f"{upload_s:.3f} s to upload them")
    check_dvbt2_tables(dvbt2_golden)
    dvbt2_iq, _ = check_dvbt2_slice(dev, dvbt2_golden)
    check_dvbt2_papr(dev, dvbt2_golden)
    check_dvbt2_cli(dvbt2_golden, dvbt2_iq, "cuda")
    graph.release(dev)      # steps 6b-12 run as before, with no graph pool
    torch.cuda.empty_cache()

    # 6b. the decoder kernels (Viterbi ACS and traceback, K=7 and K=5; the
    # min-sum check and variable kernels; RS) against their plain versions on
    # the card at full width, bit for bit, and their times beside their
    # bounds
    t_dec = time.perf_counter()
    instr_per_s = fp32_instruction_rate(dev)
    print(f"fp32 instruction rate: {instr_per_s / 1e12:.3f} T/s "
          f"({FP32_LANES_PER_SM} per SM and clock at the card's maximum SM "
          f"clock), on {card}")
    dec = check_decoder_kernels(dev, card, dvbt_iq, iq, dvbt2_iq,
                                instr_per_s)
    print(f"decoder kernel phase: {time.perf_counter() - t_dec:.1f} s")

    # 7. the receivers: loop-back of the IQ above, clean and through AWGN,
    # each with its kernels' launches counted, the card against the port's
    # CPU stage by stage, the CLIs, receive throughput and profiles: DVB-T
    # and J.83B, a long DVB-T call under a memory cap, then DVB-T2 (hard
    # and soft, BBC and blade)
    rx_kernels = ("viterbi_acs", "viterbi_traceback", "rs_decode")
    t_rx = time.perf_counter()
    rx_launches: dict[str, dict] = {}
    with _main_path(rx_launches, "dvbt rx", rx_kernels):
        dvbt_rx, dvbt_noisy = check_dvbt_rx(dev, dvbt_golden, dvbt_iq)
    with _main_path(rx_launches, "j83b rx", rx_kernels):
        j83b_rx, j83b_noisy = check_j83b_rx(dev, golden, iq)
    check_rx_stages(dev, dvbt_noisy, iq, j83b_noisy)
    _rx_cli("dvbt-rx", dvbt_iq, dvbt_rx.ts, "cuda")
    _rx_cli("qam-rx", iq, j83b_rx.ts, "cuda")
    call_s = time_rx(dev, card, dvbt_golden, dvbt_iq, iq)
    profile_dvbt_rx(dev, card, dvbt_iq, call_s)
    check_dvbt_rx_capped(dev, card, dvbt_golden)
    with _main_path(rx_launches, "dvbt2 rx",
                    ("ldpc_check", "ldpc_variable")):
        dvbt2_rx, dvbt2_noisy = check_dvbt2_rx(dev, dvbt2_golden, dvbt2_iq)
    check_dvbt2_stages(dev, dvbt2_iq, dvbt2_noisy)
    _rx_cli("dvbt2-rx", dvbt2_iq, dvbt2_rx.ts, "cuda", ["--profile", "bbc"])
    t2_s = time_dvbt2_rx(dev, card, dvbt2_iq)
    profile_dvbt2_rx(dev, card, dvbt2_iq, t2_s["soft"])
    del dvbt_rx, j83b_rx, dvbt_noisy, j83b_noisy, dvbt2_rx, dvbt2_noisy
    torch.cuda.empty_cache()        # the serving timings start as before
    print(f"receiver phase: {time.perf_counter() - t_rx:.1f} s")

    # 8. serving throughput, J.83B then DVB-T (TF32 off, then on: the
    # GF(2) products are exact either way), after the host's cost per
    # launch, which sets these host-bound timings
    print(f"host probe: {host_probe_us(dev):.3f} µs per tiny launch, on "
          f"{card}")
    msps, sb_ms = serve(dev)
    step_medians = {"j83b": sorted(msps)[1]}
    print(f"j83b serving, {_tf32()}: {_repeats(msps)} Msamples/s "
          f"({N_STREAMS} streams, {TIMED_ROUNDS} timed rounds each) on {card}")
    print(f"j83b one stream, {_tf32()}: {_repeats(sb_ms)} ms/superblock on "
          f"{card}")
    serve_busy = {"j83b": profile_j83b(dev)["busy_ms"]}
    busy_ms = serve_busy["j83b"]
    print(f"j83b device busy share: {busy_ms / sorted(sb_ms)[1]:.3f} of one "
          f"stream's {sorted(sb_ms)[1]:.4f} ms/superblock, on {card}")
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        msps, sf_ms = serve_dvbt(dev)
        print(f"dvbt serving, {_tf32()}: "
              f"{_repeats(msps)} Msamples/s ({N_STREAMS} streams, "
              f"{TIMED_ROUNDS} timed rounds each; real time is "
              f"{DVBT_FLOOR_MSPS:.6f} per stream) on {card}")
        print(f"dvbt one stream, {_tf32()}: "
              f"{_repeats(sf_ms)} ms/superframe on {card}")
        busy_ms, _ = profile_dvbt(dev)
        if not tf32:
            serve_busy["dvbt"] = busy_ms
            step_medians["dvbt"] = sorted(msps)[1]
        sf4_ms = (dvbt_flagship().samples_per_superframe
                  / (sorted(msps)[1] * 1e3))
        print(f"dvbt device busy share, {_tf32()}: "
              f"{busy_ms / sorted(sf_ms)[1]:.3f} of one stream's "
              f"{sorted(sf_ms)[1]:.4f} ms/superframe, "
              f"{busy_ms / sf4_ms:.3f} of 4-stream serving's "
              f"{sf4_ms:.4f} ms/superframe, on {card}")
    torch.backends.cuda.matmul.allow_tf32 = False

    # 9. DVB-T2 BBC serving, one frame per launch, then bench.py's shape:
    # 4 frames per launch through the batched modulator (TF32 off)
    from dtv_utils_torch.tx import dvbt2 as t2
    spf = t2.samples_per_frame(dvbt2_bbc())
    air_ms = float(1e3 * spf / dvbt2_bbc().sample_rate)
    msps, fr_ms = serve_dvbt2(dev)
    print(f"dvbt2 bbc serving, {_tf32()}: {_repeats(msps)} Msamples/s "
          f"({N_STREAMS} streams, {TIMED_ROUNDS} timed rounds each, one "
          f"frame per launch) on {card}")
    print(f"dvbt2 bbc one stream, {_tf32()}: {_repeats(fr_ms, '.4f')} "
          f"ms/frame (air time {air_ms:.3f} ms) on {card}")
    busy_ms, _ = profile_dvbt2(dev)
    serve_busy["dvbt2-bbc"] = busy_ms
    fr4_ms = spf / (sorted(msps)[1] * 1e3)
    print(f"dvbt2 device busy share, {_tf32()}: "
          f"{busy_ms / sorted(fr_ms)[1]:.3f} of one stream's "
          f"{sorted(fr_ms)[1]:.4f} ms/frame, {busy_ms / fr4_ms:.3f} of "
          f"4-stream serving's {fr4_ms:.4f} ms/frame, on {card}")
    dvbt_1, dvbt_4, dvbt_8, t2_4, j83b_4 = (
        batched_dvbt(dev, 1), *batched_chains(dev))
    step_medians["dvbt2"] = sorted(serve_batched(   # 4 frames per launch
        dev, card, t2_4, batched_dvbt2(dev, 1)))[1]

    # 10. batched and sharded streaming at full width: batched equal to the
    # serial chain (DVB-T L = 4 and 8, DVB-T2 BBC and J.83B L = 4, each
    # with a continuation) with no host sync, launches that do not grow
    # with L, batched serving; sharded equal to batched at world size 1
    # under NCCL; entry() and dryrun_multichip(1)
    t_batch = time.perf_counter()
    firsts = {b.label: check_batched(dev, b)
              for b in (dvbt_4, dvbt_8, t2_4, j83b_4)}
    serve_batched(dev, card, dvbt_4, dvbt_1)
    serve_batched(dev, card, dvbt_8, dvbt_1)
    serve_batched(dev, card, j83b_4, batched_j83b(dev, 1))
    j83b_x = firsts[j83b_4.label][0]
    _build.LAUNCHES["fir_interp2"] = 0
    j83b_4.call(j83b_x, j83b_4.pos0)
    j83b_batched_launches = _build.LAUNCHES["fir_interp2"]
    check_sharded(dev, firsts)
    print(f"batched and sharded phase: {time.perf_counter() - t_batch:.1f} s")

    # 11. PAPR scan throughput
    gsps = time_papr(dev)
    step_medians["papr"] = sorted(gsps)[1]
    print(f"papr pass 1 + pass 2 ({PAPR_LEVELS} levels, {PAPR_CHUNK} complex "
          f"per chunk), {_tf32()}: {_repeats(gsps, '.4f')} GSa/s on {card}")

    # 12. the stage profiler (utils/profile.py) on every chain, TF32 off:
    # rows within the H100's roofline and run on the card, the FIR kernel
    # in the J.83B rows that run it, FULL rows no faster than steps 8-9's
    # device time per block; `dtv profile -j papr`; then the rate oracles
    # and the native analyzers (built by the port) against their goldens
    t_prof = time.perf_counter()
    profile_stages(dev, card, t, serve_busy)
    check_profile_cli(card)
    check_rates_native()
    print(f"profiler, rates and native phase: "
          f"{time.perf_counter() - t_prof:.1f} s")

    # 12b. the captured calls (utils/graph): each modulator's graph and
    # jit_decode at full width against the eager chain bit for bit, the
    # FIR launched once per J.83B replay, eager and graph timed in turns
    graphs = check_graphs(dev, card)

    # 13. the bench surfaces: bench_j83b in this process with its FIR
    # launches counted, `python -m dtv_utils_torch.bench --stress` beside
    # steps 8, 9 and 11's medians of the same shapes, and
    # `python -m dtv_utils_torch.scaling_bench --gpu`
    bench_fir_launches = check_bench(card, step_medians)

    kernels = [{
        "name": "fir_interp2", "route": "cuda",
        "source": "dtv_utils_torch/csrc/fir_interp2.cu",
        "replaces": "dtv_utils_tpu/ops/fir.py:66",
        "launches": launches,
        "launches_per_batched_j83b_call": j83b_batched_launches,
        "launches_in_bench_j83b": bench_fir_launches,
        "launches_in_graphs": graphs["launches"]["fir_interp2"],
        "batched_j83b_superblocks": j83b_x.shape[0], "max_abs_err": max_err,
        "ms": t["kernel_cold"], "cold_ms": t["kernel_cold"],
        "warm_ms": t["kernel_warm"], "plain_ms": t["plain_cold"],
        "plain_warm_ms": t["plain_warm"], "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_share_cold": bound_ms / t["kernel_cold"],
        "library_ms": t["library_cold"],
        "library_warm_ms": t["library_warm"]}]
    ldpc_extra = ("dvbt2_noise", "dvbt2_blade", "dvbt2_short_5_6")
    for name, source, replaces, case, runs, extra in (
            ("viterbi_acs", "viterbi.cu", "viterbi.py:153", "dvbt",
             ("dvbt rx", "j83b rx"), ("j83b",)),
            ("viterbi_traceback", "viterbi.cu", "viterbi.py:173", "dvbt",
             ("dvbt rx", "j83b rx"), ("j83b",)),
            ("ldpc_check", "ldpc_minsum.cu", "ldpc_decode.py:112",
             "dvbt2_awgn", ("dvbt2 rx",), ldpc_extra),
            ("ldpc_variable", "ldpc_minsum.cu", "ldpc_decode.py:113",
             "dvbt2_awgn", ("dvbt2 rx",), ldpc_extra),
            ("rs_decode", "rs_decode.cu", None, "rs_dvbt",
             ("dvbt rx", "j83b rx"), ("rs_j83b",))):
        m = dec[case][name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"dtv_utils_torch/csrc/{source}",
            "replaces": replaces and f"dtv_utils_tpu/ops/{replaces}",
            "launches": sum(rx_launches[r][name] for r in runs),
            "launches_by_run": {r: rx_launches[r][name] for r in runs},
            "launches_in_graphs": graphs["launches"].get(name, 0),
            "max_abs_err": max(dec[c][name]["max_abs_err"]
                               for c in (case, *extra)),
            "ms": m["cold"], "cold_ms": m["cold"], "warm_ms": m["warm"],
            "plain_ms": m["plain"], "bound_ms": m["bound"][0],
            "bound_by": m["bound"][1], "library_ms": m["library"],
            "shape": m["shape"]}
        if "instr_bound" in m:
            entry |= {"instr_bound_ms": m["instr_bound"][0],
                      "instr_bound_by": m["instr_bound"][1],
                      "ns_per_step_cold": 1e6 * m["cold"] / m["shape"]["L"]}
        if "message_bound_ms" in m:
            entry |= {"message_bound_ms": m["message_bound_ms"],
                      "decode_peak_mb": m["decode_peak_mb"],
                      "cold_ms_by_slice_cols": {
                          c: r[name] for c, r in dec["ldpc_slices"].items()}}
        for c in extra:
            x = dec[c][name]
            entry[c] = {k: x[k] for k in ("cold", "warm", "plain", "library",
                                          "shape")} | {
                "bound_ms": x["bound"][0]}
            if "instr_bound" in x:
                entry[c] |= {"instr_bound_ms": x["instr_bound"][0],
                             "ns_per_step_cold":
                             1e6 * x["cold"] / x["shape"]["L"]}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def profile_only(package_root: str) -> int:
    """Profile J.83B serving with the ``dtv_utils_torch`` found under
    ``package_root``; print the result as the last line, one JSON object."""
    sys.path.insert(0, str(Path(package_root).resolve()))
    import dtv_utils_torch

    dev = torch.device("cuda", 0)
    print(f"package {Path(dtv_utils_torch.__file__).parent}")
    print(json.dumps(profile_j83b(dev)))
    return 0


def j83b_ab(parent_root: str) -> int:
    """J.83B's profile with the package of ``parent_root`` (another tree of
    this repository) and with this one, in turns: parent, this, this,
    parent, each in its own process on the same card."""
    res: dict[str, list[dict]] = {"parent": [], "this": []}
    card = card_line(torch.device("cuda", 0))
    for side in ("parent", "this", "this", "parent"):
        root = parent_root if side == "parent" else str(ROOT)
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--profile-only", root], capture_output=True,
                             text=True, timeout=600, check=True)
        print(run.stdout, end="")
        res[side].append(json.loads(run.stdout.strip().splitlines()[-1]))
    for key in ("busy_ms", "activities", "fir_share", "cat_per_block"):
        print(f"j83b a/b {key}: parent " + ", ".join(
            f"{r[key]:.5f}" for r in res["parent"]) + "; this " + ", ".join(
            f"{r[key]:.5f}" for r in res["this"]) + f" (on {card})")
    saved = (sum(r["busy_ms"] for r in res["parent"])
             - sum(r["busy_ms"] for r in res["this"])) / 2
    print(f"j83b device time saved per superblock: {saved:.5f} ms "
          f"(means of two turns each, on {card})")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--j83b-ab", metavar="TREE",
                    help="only profile J.83B, with TREE's package and this "
                    "one in turns (TREE: e.g. `git archive` of the parent)")
    ap.add_argument("--profile-only", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs an "
              "NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    if args.profile_only:
        sys.exit(profile_only(args.profile_only))
    sys.exit(j83b_ab(args.j83b_ab) if args.j83b_ab else main())
