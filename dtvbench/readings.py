"""The readings that the limits of ``correct`` are set from: runs of one
cell over many seeds in one process, the program's own and, with
``--plants``, its controls and faults.  The benchmark's own runs never
plant anything.  Plants: "control" (the reference in bfloat16 in the
modulator's place), "control-<precision>" (a receiver's stated stage one
precision lower: DVB-T "bfloat16" or "hard" LLRs, J.83B a "bfloat16"
matched filter), "state" (a channel's state left unchanged),
"half" (half of a call left out) and "altered" (one answer altered).

    python3 dtvbench/readings.py --workload NAME --seeds 1,2,3 \\
        --seconds 2 [--plants none,control,state,half,altered]

prints one JSON line per run: the plant, the seed, ``correct``, each
number compared, and the driver's readings beside the check.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dtvbench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--plants", default="none")
    a = p.parse_args(argv)
    for plant in a.plants.split(","):
        for seed in (int(s) for s in a.seeds.split(",")):
            t0 = time.perf_counter()
            info = {}
            line = run.execute(a.workload, seed, a.seconds, False,
                               plant=None if plant == "none" else plant,
                               t_start=t0, info=info)
            print(json.dumps({"plant": plant, "seed": seed,
                              "correct": line["correct"],
                              "checks": line["checks"], "info": info,
                              "attempted": line["attempted"],
                              "metrics": line["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
