"""ITU-T J.83B 64-QAM cable transmitter CLI (port of
``dtv_utils_tpu/models/j83b.py``).

``qam-mod input_file [output_file] [--device DEV]``: the reference's argv
surface plus ``--device`` (default ``cuda``; asking for CUDA without a GPU
is an error, never a fall-back).  All chain parameters are fixed as
qam-blade.py fixes them.  ``output_file`` receives gr_complex IQ at
10.113882 Msps, byte-identical in layout to the reference's output.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from dtv_utils_torch.core.config import J83bConfig
from dtv_utils_torch.models.dvbt import load_ts_cycled


def cli(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        prog="dtv qam-mod",
        description="Modulate a J.83B 64-QAM signal (PyTorch/CUDA)")
    p.add_argument("infile", metavar="input_file")
    p.add_argument("outfile", metavar="output_file", nargs="?")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    from dtv_utils_torch.tx import j83b as txq
    from dtv_utils_torch.utils.device import resolve_device
    from dtv_utils_torch.utils.metrics import Metrics

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"qam-mod: {e}\n")
        return 255
    cfg = J83bConfig()
    ts = load_ts_cycled(args.infile, txq.SUPERBLOCK_BYTES, None)
    t0 = time.perf_counter()
    iq, _state = txq.modulate_stream(cfg, ts, device=dev)
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    m = Metrics()
    m.emit("j83b_mod_throughput", round(iq.size / dt / 1e6, 3),
           unit="Msamples/s", ts_bytes=int(ts.size), iq_samples=int(iq.size),
           device=name)
    m.emit("j83b_sample_rate", round(float(cfg.sample_rate) / 1e6, 6),
           unit="Msps")
    if args.outfile:
        iq.astype(np.complex64).tofile(args.outfile)
    return 0
