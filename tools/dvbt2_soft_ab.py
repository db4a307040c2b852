#!/usr/bin/env python3
"""Soft DVB-T2 BBC receive with two trees' packages, in turns, on one card.

Run from the repository root on a machine with an NVIDIA GPU:
``python3 tools/dvbt2_soft_ab.py TREE`` where TREE is another tree of this
repository (e.g. the parent commit unpacked by ``git archive`` into an
ignored directory).  Each turn (TREE, this, this, TREE) is its own process
that imports ``dtv_utils_torch`` from its tree, modulates 2 BBC frames
(``chip_smoke.seeded_ts``, seed 7) and receives them soft, as
``chip_smoke.time_dvbt2_rx`` does, and prints one JSON line:

* ``call_ms``: host ms of a 2-frame ``demodulate_stream`` call (median of
  3 after a warm-up);
* ``device_ms``, ``ldpc_ms``, ``activities``: one call under
  ``torch.profiler``: the device's busy time (the union of its
  activities), the summed time of the kernels named ``ldpc_``, and the
  number of device activities;
* ``decode_peak_mb``: peak allocation of ``ldpc_decode.decode`` on one
  frame's 202 blocks of LLRs, above what was held before it;
* ``frame_peak_mb``: the same for one frame's soft ``_decode_frame``.

The first turn of this tree also prints the 15 functions with the most
host time in one call (cProfile).  Then it prints each metric per turn and
the mean of each side.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("call_ms", "device_ms", "ldpc_ms", "activities", "decode_peak_mb",
        "frame_peak_mb")


def one_side(tree: str, host_profile: bool) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import dtv_utils_torch
    from dtv_utils_torch.models.dvbt2 import PROFILES
    from dtv_utils_torch.ops import ldpc_decode
    from dtv_utils_torch.rx import dvbt2 as rx2
    from dtv_utils_torch.tx import dvbt2 as t2

    sys.path.insert(1, str(ROOT))
    from chip_smoke import _trace_summary, seeded_ts

    print(f"package {Path(dtv_utils_torch.__file__).parent}",
          file=sys.stderr)
    dev = torch.device("cuda", 0)
    cfg = PROFILES["bbc"]
    ts = seeded_ts(7, 2 * cfg.payload_bytes_per_frame)
    iq, _ = t2.modulate_stream(cfg, ts, device=dev)
    x = torch.from_numpy(np.asarray(iq)).to(dev)
    spf = t2.samples_per_frame(cfg)

    def call():
        return rx2.demodulate_stream(cfg, x, soft=True, device=dev)

    res = call()
    if not np.array_equal(res.ts, ts):
        raise AssertionError("the soft receive lost the TS")
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    _, acts, busy_us, _, _ = _trace_summary(prof)
    out = dict(call_ms=1e3 * statistics.median(secs), device_ms=busy_us / 1e3,
               ldpc_ms=sum(e["dur"] for e in acts
                           if "ldpc_" in e["name"]) / 1e3,
               activities=len(acts))
    _, cells = rx2._cells(cfg, x[2048:spf])
    llr = rx2.soft_llrs(cfg, cells)
    del cells
    for key, fn in (("decode_peak_mb", lambda: ldpc_decode.decode(cfg, llr)),
                    ("frame_peak_mb", lambda: rx2._decode_frame(
                        cfg, x[2048:spf], True, 30))):
        fn()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        out[key] = (torch.cuda.max_memory_allocated(dev) - held) / 1e6
    if host_profile:
        host = cProfile.Profile()
        host.enable()
        call()
        torch.cuda.synchronize()
        host.disable()
        buf = io.StringIO()
        pstats.Stats(host, stream=buf).sort_stats("tottime").print_stats(15)
        print(buf.getvalue(), file=sys.stderr)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", help="the other tree (e.g. the parent commit)")
    ap.add_argument("--side", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--host-profile", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        print(json.dumps(one_side(args.side, args.host_profile)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("dvbt2_soft_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line
    card = card_line(torch.device("cuda", 0))
    res: dict[str, list[dict]] = {"tree": [], "this": []}
    for turn, side in enumerate(("tree", "this", "this", "tree")):
        root = args.tree if side == "tree" else str(ROOT)
        cmd = [sys.executable, str(Path(__file__).resolve()), args.tree,
               "--side", root] + (["--host-profile"] if turn == 1 else [])
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900, check=True)
        print(run.stderr, end="", file=sys.stderr)
        res[side].append(json.loads(run.stdout.strip().splitlines()[-1]))
    print(f"soft DVB-T2 BBC receive, 2 frames per call; {args.tree} and "
          f"this tree in turns (tree, this, this, tree); on {card}")
    for key in KEYS:
        per = {s: [r[key] for r in res[s]] for s in res}
        print(f"  {key}: tree " + " / ".join(f"{v:.3f}" for v in per["tree"])
              + " (mean " + f"{statistics.mean(per['tree']):.3f}); this "
              + " / ".join(f"{v:.3f}" for v in per["this"]) + " (mean "
              + f"{statistics.mean(per['this']):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
