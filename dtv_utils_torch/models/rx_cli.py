"""J.83B receiver CLI (port of ``qam_rx_cli`` in
``dtv_utils_tpu/models/rx_cli.py``; its ``dvbt2_rx_cli`` waits for the
DVB-T2 receiver).

``qam-rx [-o OUT] input_file [--device DEV]`` reads the gr_complex IQ that
``qam-mod`` writes, in whole superblocks, and emits the recovered TS and
two metric lines: throughput and receiver health.  ``--device`` defaults to
``cuda``; asking for CUDA without a GPU is an error, never a fall-back.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def qam_rx_cli(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        prog="dtv qam-rx",
        description="Demodulate an ITU-T J.83B 64-QAM IQ stream back to TS "
                    "(PyTorch/CUDA)")
    p.add_argument("-o", "--output", dest="outfile", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("infile", metavar="input_file")
    args = p.parse_args(argv)

    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.rx import j83b as rxq
    from dtv_utils_torch.utils.device import resolve_device
    from dtv_utils_torch.utils.metrics import Metrics

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"qam-rx: {e}\n")
        return 255
    iq = np.fromfile(args.infile, dtype=np.complex64)
    blk = rxq.SUPERBLOCK_SAMPLES
    n = len(iq) // blk
    if n == 0:
        sys.stderr.write(f"input shorter than one superblock ({blk})\n")
        return 255
    t0 = time.perf_counter()
    res = rxq.demodulate_stream(J83bConfig(), iq[:n * blk], device=dev)
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    m = Metrics()
    m.emit("j83b_rx_throughput", round(n * blk / dt / 1e6, 3),
           unit="Msamples/s", includes_setup=True, device=name)
    all_ok = (res.fsync_ok and bool(res.rs_ok.all())
              and bool(res.ext_ok.all()) and bool(res.checksum_ok.all()))
    m.emit("j83b_rx_status", int(all_ok), unit="ok",
           ts_bytes=int(res.ts.size), fsync=res.fsync_ok,
           control_word=res.control_word,
           rs_corrected=int(res.rs_errors.sum()),
           rs_uncorrectable=int((~res.rs_ok).sum()))
    if args.outfile:
        res.ts.tofile(args.outfile)
    return 0
