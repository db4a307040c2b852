#!/usr/bin/env python3
"""The host memory that the Viterbi's plain version takes per trellis step.

Run from the repository root: ``python3 tools/viterbi_plain_peak.py``.  It
needs no GPU.  On a CPU tensor ``ops/viterbi`` decodes by its plain
version (``acs_reference``, ``pack_decisions``, ``traceback_reference``),
in passes sized at ``utils/device.VITERBI_PLAIN_BYTES_PER_STEP``.  This
decodes random DVB-T rate-7/8 LLRs of a few hundred blocks, one pass each,
and prints the peak resident memory above the input per trellis step of a
block, the quantity that constant bounds.  The script runs itself again
with glibc's mmap threshold at 64 KiB, so that every tensor is mapped on
allocation and unmapped on release and the resident peak follows the live
tensors; the peak is reset through ``/proc/self/clear_refs`` (Linux).
"""

from __future__ import annotations

import os
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BLOCKS = (200, 400)
RATE = (7, 8)
MMAP_THRESHOLD = "65536"


def _hwm() -> int:
    """Peak resident bytes of this process since the last reset."""
    status = Path("/proc/self/status").read_text()
    return int(re.search(r"VmHWM:\s+(\d+) kB", status).group(1)) << 10


def _rss() -> int:
    status = Path("/proc/self/status").read_text()
    return int(re.search(r"VmRSS:\s+(\d+) kB", status).group(1)) << 10


def main() -> int:
    if os.environ.get("MALLOC_MMAP_THRESHOLD_") != MMAP_THRESHOLD:
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  dict(os.environ, MALLOC_MMAP_THRESHOLD_=MMAP_THRESHOLD))
    import inspect

    import numpy as np
    import torch

    from dtv_utils_torch.ops import viterbi
    from dtv_utils_torch.ops.convcode import PUNCTURE_PATTERNS
    from dtv_utils_torch.utils import device as udev

    torch.set_num_threads(2)
    xp, yp = PUNCTURE_PATTERNS[RATE]
    period, kept = len(xp), int(sum(xp) + sum(yp))
    block = inspect.signature(
        viterbi.viterbi_decode_punctured).parameters["block"].default
    L = block + 2 * viterbi.seam_overlap(viterbi.DVBT_K, *RATE)
    rng = np.random.default_rng(0)
    viterbi.viterbi_decode_punctured(
        torch.from_numpy(rng.normal(size=kept * 64).astype(np.float32)),
        RATE)                                             # warm-up
    worst = 0.0
    for nb in BLOCKS:
        n_kept = nb * block // period * kept
        z = torch.from_numpy(rng.normal(size=n_kept).astype(np.float32))
        steps = -(-(n_kept // kept * period) // block) * L
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        held = _rss()
        viterbi.viterbi_decode_punctured(z, RATE)
        got = (_hwm() - held) / steps
        worst = max(worst, got)
        print(f"{nb} blocks of {L} steps (K={viterbi.DVBT_K}, rate "
              f"{RATE[0]}/{RATE[1]}), one pass: peak {got:.1f} bytes per "
              f"trellis step above the input")
        del z
    bound = udev.VITERBI_PLAIN_BYTES_PER_STEP
    print(f"utils/device.VITERBI_PLAIN_BYTES_PER_STEP = {bound}: "
          f"{'holds' if worst <= bound else 'too small'}")
    return 0 if worst <= bound else 1


if __name__ == "__main__":
    sys.exit(main())
