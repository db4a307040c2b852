#!/usr/bin/env python3
"""Where the DVB-T2 soft receiver stops converging on chip_smoke.py's input.

Modulates ``chip_smoke.py``'s 2 BBC frames (its seeded TS), adds its AWGN
(``chip_smoke.awgn``, seed ``RX_NOISE_SEED``) at each SNR given, and runs
``rx.dvbt2.demodulate_stream(..., soft=True)``; prints per SNR whether the
TS is exact and how many of the 404 FEC blocks fail the LDPC syndrome,
BCH or BB-header CRC, and the L1 CRCs.  ``chip_smoke.RX_DVBT2_SNR_DB`` is
set with margin above the lowest SNR where every block converges.

Run from the repository root:
``python3 tools/dvbt2_soft_margin.py 20 21 22 23`` (on the card;
``--device cpu`` runs it on the CPU, about 50 s per SNR).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dtv_utils_torch.rx import dvbt2 as rx2  # noqa: E402
from dtv_utils_torch.tx import dvbt2 as t2  # noqa: E402
from dtv_utils_torch.utils.device import resolve_device  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    ap.add_argument("snr_db", type=float, nargs="+")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = cs.dvbt2_bbc()
    g = json.loads(cs.DVBT2_GOLDEN.read_text())
    ts = cs.seeded_ts(g["seed"], g["frames"] * cfg.payload_bytes_per_frame)
    iq, _ = t2.modulate_stream(cfg, ts, device=dev)
    for snr in args.snr_db:
        t0 = time.perf_counter()
        r = rx2.demodulate_stream(cfg, cs.awgn(iq, snr, cs.RX_NOISE_SEED),
                                  soft=True, device=dev)
        print(f"{snr:g} dB: TS exact {np.array_equal(r.ts, ts)}; blocks "
              f"failing LDPC {int((~r.ldpc_ok).sum())}, BCH "
              f"{int((~r.bch_ok).sum())}, BB CRC {int((~r.bb_crc_ok).sum())} "
              f"of {r.ldpc_ok.size}; sync chain {r.sync_crc_ok}; L1-pre CRC "
              f"{r.l1_pre['crc_ok']}, L1-post CRC {r.l1_post['crc_ok']} "
              f"({time.perf_counter() - t0:.1f} s on {dev})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
