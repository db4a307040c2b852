"""DVB-T transmitter CLI (port of ``dtv_utils_tpu/models/dvbt.py``).

``dvbt-mod [options] input-file``: the reference's argv surface (mode,
channel, constellation, Viterbi rate, guard interval, frequency, bladeRF
gains, output file, superframe count, state load/save) plus ``--device``
(default ``cuda``; asking for CUDA without a GPU is an error, never a
fall-back).  SDR output is out of scope: ``-f/--freq``, ``--txvga1`` and
``--txvga2`` are accepted and ignored.  ``-o/--output`` writes gr_complex
(interleaved float32 IQ).  The input TS is consumed in whole superframes,
cycled to fill the last one.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from dtv_utils_torch.core.config import (CodeRate, Constellation, DvbtConfig,
                                         GuardInterval, TransmissionMode)

_MODES = {"t2k": TransmissionMode.M2K, "t8k": TransmissionMode.M8K}
_CONS = {"qpsk": Constellation.QPSK, "qam16": Constellation.QAM16,
         "qam64": Constellation.QAM64}
_RATES = {"1/2": CodeRate.R1_2, "2/3": CodeRate.R2_3, "3/4": CodeRate.R3_4,
          "5/6": CodeRate.R5_6, "7/8": CodeRate.R7_8}
_GUARDS = {"1/32": GuardInterval.G1_32, "1/16": GuardInterval.G1_16,
           "1/8": GuardInterval.G1_8, "1/4": GuardInterval.G1_4}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtv dvbt-mod",
        description="Modulate a DVB-T signal (PyTorch/CUDA)")
    p.add_argument("-m", "--mode", default="t8k",
                   help="# of carriers. Options: t2k, t8k (default).")
    p.add_argument("-c", "--channel", default=8, type=int, metavar="CH",
                   help="channel width in MHz. Options: 5, 6, 7, 8 (default).")
    p.add_argument("-C", "--cons", default="qam64", metavar="TYPE",
                   help="constellation. qpsk, qam16, qam64 (default).")
    p.add_argument("-r", "--rate", default="7/8",
                   help="Viterbi rate. 1/2, 2/3, 3/4, 5/6, 7/8 (default).")
    p.add_argument("-g", "--guard", dest="interval", default="1/32",
                   metavar="D",
                   help="guard interval. 1/32 (default), 1/16, 1/8, 1/4.")
    p.add_argument("-f", "--freq", default=429e6, type=float,
                   help="center frequency (Hz). Ignored (no SDR output).")
    p.add_argument("--txvga1", default=-6, type=int, metavar="gain",
                   help="bladeRF TXVGA1 gain. Ignored (no SDR output).")
    p.add_argument("--txvga2", default=9, type=int, metavar="gain",
                   help="bladeRF TXVGA2 gain. Ignored (no SDR output).")
    p.add_argument("-o", "--output", dest="outfile", default=None,
                   metavar="OUT", help="write IQ (gr_complex) to file.")
    p.add_argument("-n", "--superframes", default=None, type=int,
                   help="number of superframes to emit "
                        "(default: ceil(file/superframe), input cycled).")
    p.add_argument("--load-state", default=None, metavar="NPZ",
                   help="resume a long stream from a saved chain state.")
    p.add_argument("--save-state", default=None, metavar="NPZ",
                   help="checkpoint the chain state after modulating.")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("infile", metavar="input-file", help="Input TS file")
    return p


def config_from_args(args: argparse.Namespace) -> DvbtConfig:
    def pick(table, key, what):
        try:
            return table[key.lower()]
        except KeyError:
            sys.stderr.write(f"Invalid {what} provided.\n")
            raise SystemExit(255)
    if args.channel not in (5, 6, 7, 8):
        sys.stderr.write("Invalid channel provided.\n")
        raise SystemExit(255)
    return DvbtConfig(mode=pick(_MODES, args.mode, "mode"),
                      bandwidth_mhz=args.channel,
                      constellation=pick(_CONS, args.cons, "constellation"),
                      code_rate=pick(_RATES, args.rate, "Viterbi rate"),
                      guard=pick(_GUARDS, args.interval, "guard interval"))


def load_ts_cycled(path: str, block_bytes: int,
                   n_blocks: int | None) -> np.ndarray:
    """Read a TS file and cycle it to ``n_blocks`` whole blocks (default:
    as many as the file starts)."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        sys.stderr.write(f"empty input file: {path}\n")
        raise SystemExit(255)
    if n_blocks is None:
        n_blocks = max(1, -(-raw.size // block_bytes))
    total = n_blocks * block_bytes
    reps = -(-total // raw.size)
    return np.tile(raw, reps)[:total]


def cli(argv: list[str]) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    from dtv_utils_torch.tx import dvbt as txd
    from dtv_utils_torch.utils import checkpoint
    from dtv_utils_torch.utils.device import resolve_device
    from dtv_utils_torch.utils.metrics import Metrics

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"dvbt-mod: {e}\n")
        return 255
    ts = load_ts_cycled(args.infile, cfg.ts_bytes_per_superframe,
                        args.superframes)
    state = None
    if args.load_state:
        state = checkpoint.load_state(args.load_state,
                                      txd.init_state(cfg, device=dev),
                                      kind="dvbt")
    t0 = time.perf_counter()
    iq, state = txd.modulate_stream(cfg, ts, state, device=dev)
    dt = time.perf_counter() - t0
    if args.save_state:
        checkpoint.save_state(args.save_state, state, kind="dvbt")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    m = Metrics()
    m.emit("dvbt_mod_throughput", round(iq.size / dt / 1e6, 3),
           unit="Msamples/s", ts_bytes=int(ts.size), iq_samples=int(iq.size),
           device=name)
    m.emit("dvbt_ts_rate", round(float(cfg.useful_bitrate) / 1e6, 6),
           unit="Mbps", sample_rate_msps=round(float(cfg.sample_rate) / 1e6, 6))
    if args.outfile:
        iq.astype(np.complex64).tofile(args.outfile)
    return 0
