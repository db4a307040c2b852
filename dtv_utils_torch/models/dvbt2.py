"""DVB-T2 transmitter CLI (port of ``dtv_utils_tpu/models/dvbt2.py``).

``dvbt2-mod [options] input_file [output_file]``: the reference's argv
surface (``--profile``, ``-n/--frames``, ``--papr``, ``--tables``) plus
``--device`` (default ``cuda``; asking for CUDA without a GPU is an error,
never a fall-back).  ``output_file`` receives gr_complex (interleaved
float32) IQ.  The input TS is consumed in whole T2 frames, cycled to fill
the last one.  Like the reference, the CLI keeps no state across runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from dtv_utils_torch.core.config import (Dvbt2Config, T2CodeRate,
                                         T2Constellation, T2Guard,
                                         T2PilotPattern)

PROFILES = {
    "blade": Dvbt2Config(),
    # BBC reference mux (`dvbt2rate 8 32 4 59 202 3 4 0 1 7 3`): 40.2 Mbps —
    # 32K extended, 256QAM, rate 2/3, GI 1/128, PP7, L1 64QAM, 59 data
    # symbols, 202 FEC blocks.
    "bbc": Dvbt2Config(fft_size=32768, extended_carriers=True,
                       code_rate=T2CodeRate.R2_3,
                       constellation=T2Constellation.QAM256,
                       guard=T2Guard.G1_128,
                       pilot_pattern=T2PilotPattern.PP7,
                       l1_constellation=3,
                       data_symbols=59, fec_blocks=202, ti_blocks=3),
}


def _print_tables(cfg: Dvbt2Config, profile: str) -> int:
    """Annex-table provenance report: whether the IQ this profile generates
    runs on installed EN 302 755 data or on structure-exact stand-ins.
    Exit 0 when every pure-data table is installed, 3 otherwise (a
    scriptable compliance gate)."""
    from dtv_utils_torch.tx import t2_annex
    rows = t2_annex.table_status(cfg)
    width = max(len(r["name"]) for r in rows)
    print(f"# annex-table provenance for profile '{profile}' "
          f"(fft={cfg.fft_size}, {cfg.constellation.name}, "
          f"rate {cfg.code_rate.fraction})")
    standins = 0
    for r in rows:
        flag = {"installed": "INSTALLED", "derived": "DERIVED",
                "config": "CONFIG", "stand-in": "STAND-IN"}[r["state"]]
        standins += r["state"] == "stand-in"
        print(f"{r['name']:<{width}}  {flag:<9}  {r['file']}")
        print(f"{'':<{width}}  {'':<9}  {r['detail']}")
    if standins:
        print(f"# {standins} stand-in table(s) active: generated IQ is "
              "self-consistent but NOT decodable by standard receivers")
    else:
        print("# all pure-data tables installed")
    return 3 if standins else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtv dvbt2-mod",
        description="Modulate a DVB-T2 signal (PyTorch/CUDA)")
    p.add_argument("--profile", default="blade", choices=sorted(PROFILES),
                   help="parameter profile: blade (default) or bbc")
    p.add_argument("-n", "--frames", default=None, type=int,
                   help="number of T2 frames (default: fit file, cycled)")
    p.add_argument("--papr", action="store_true",
                   help="enable tone-reservation PAPR reduction "
                        "(vclip 3.3, 3 iterations)")
    p.add_argument("--tables", action="store_true",
                   help="print, per annex table the chain would use, "
                        "whether installed standard data or a stand-in is "
                        "active (with file provenance), then exit")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("infile", metavar="input_file", nargs="?")
    p.add_argument("outfile", metavar="output_file", nargs="?")
    return p


def cli(argv: list[str]) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    cfg = PROFILES[args.profile]
    if args.papr:
        cfg = dataclasses.replace(cfg, papr_tr=True)
    if args.tables:
        return _print_tables(cfg, args.profile)
    if args.infile is None:
        p.error("input_file is required unless --tables is given")

    from dtv_utils_torch.models.dvbt import load_ts_cycled
    from dtv_utils_torch.tx import dvbt2 as txt2
    from dtv_utils_torch.utils.device import resolve_device
    from dtv_utils_torch.utils.metrics import Metrics

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"dvbt2-mod: {e}\n")
        return 255
    ts = load_ts_cycled(args.infile, cfg.payload_bytes_per_frame,
                        args.frames)
    t0 = time.perf_counter()
    iq, _state = txt2.modulate_stream(cfg, ts, device=dev)
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    m = Metrics()
    m.emit("dvbt2_mod_throughput", round(iq.size / dt / 1e6, 3),
           unit="Msamples/s", profile=args.profile,
           ts_bytes=int(ts.size), iq_samples=int(iq.size), device=name)
    m.emit("dvbt2_sample_rate",
           round(float(cfg.sample_rate) / 1e6, 6), unit="Msps")
    if args.outfile:
        iq.astype(np.complex64).tofile(args.outfile)
    return 0
