"""DVB-T receiver CLI (port of ``dtv_utils_tpu/models/dvbt_rx.py``).

``dvbt-rx [options] input-file``: the reference's flags (mode, channel,
constellation, Viterbi rate, guard interval, ``-o``) plus ``--device``
(default ``cuda``; asking for CUDA without a GPU is an error, never a
fall-back).  It reads the gr_complex IQ that ``dvbt-mod -o`` writes, in
whole superframes, and emits the recovered TS and two metric lines:
throughput and receiver health (RS corrections, TPS BCH, pilot-phase lock).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from dtv_utils_torch.models.dvbt import add_config_args, config_from_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtv dvbt-rx",
        description="Demodulate a DVB-T IQ stream back to TS (PyTorch/CUDA)")
    add_config_args(p)
    p.add_argument("-o", "--output", dest="outfile", default=None,
                   metavar="OUT", help="write the recovered TS to a file.")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("infile", metavar="input-file",
                   help="gr_complex (float32 interleaved IQ) input file")
    return p


def cli(argv: list[str]) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    from dtv_utils_torch.rx import dvbt as rxd
    from dtv_utils_torch.utils.device import resolve_device
    from dtv_utils_torch.utils.metrics import Metrics

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"dvbt-rx: {e}\n")
        return 255
    iq = np.fromfile(args.infile, dtype=np.complex64)
    spf = cfg.symbols_per_superframe * (cfg.fft_size + cfg.guard_samples)
    n_sf = len(iq) // spf
    if n_sf == 0:
        sys.stderr.write(f"input shorter than one superframe "
                         f"({spf} samples)\n")
        return 255
    iq = iq[:n_sf * spf]

    t0 = time.perf_counter()
    res = rxd.demodulate_stream(cfg, iq, device=dev)
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    m = Metrics()
    m.emit("dvbt_rx_throughput", round(len(iq) / dt / 1e6, 3),
           unit="Msamples/s", includes_setup=True, device=name)
    m.emit("dvbt_rx_status",
           int(res.rs_ok.all() and res.phase_ok and res.tps["all_bch_ok"]),
           unit="ok", ts_bytes=int(res.ts.size),
           rs_packets=int(res.rs_ok.size),
           rs_uncorrectable=int((~res.rs_ok).sum()),
           rs_corrected_bytes=int(res.rs_errors.sum()),
           phase_lock=bool(res.phase_ok),
           tps_bch_ok=bool(res.tps["all_bch_ok"]))
    if args.outfile:
        res.ts.tofile(args.outfile)
    return 0
