#!/usr/bin/env python3
"""What limits the receivers' copy in on the card's host: the fill of
pinned memory per thread count, the copy to the card per chunk size, and
the whole staging (``utils/staging.py``) per chunk, slot and thread count.

Run from the repository root on a machine with a CUDA device:
``python3 tools/staging_limits.py``.  The inputs are the two receive cells'
captures by size (DVB-T's 2 superframes, 4,595,712 samples, 36.8 MB;
J.83B's 2 superblocks, 7,224,840 samples, 57.8 MB), four seeded arrays of
each, sent in turn as the benchmark sends its noise draws, so no array is
in the host's caches when it is read.  Prints one line per measurement:

* ``pageable``: ``torch.from_numpy(x).to(dev)``, host ms per call;
* ``fill``: GB/s of ``np.copyto`` from a capture into pinned memory, cut
  into chunks and spread over a pool of T threads;
* ``copy``: GB/s of one pinned → card copy of a chunk (CUDA events);
* ``stage``: ``CudaStager`` with a chunk, a slot count and T threads: host
  ms per call, and ms until the capture has landed on the card;

then checks the staged copy against ``torch.from_numpy(x).to(dev)``, bit
for bit.
"""

from __future__ import annotations

import os
import statistics
import sys
import time
from concurrent import futures
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dtv_utils_torch.utils import staging          # noqa: E402
from dtv_utils_torch.utils.device import card_line  # noqa: E402

SIZES = {"dvbt": 4_595_712, "j83b": 7_224_840}
MIB = 1 << 20
REPS = 24


def captures(n: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(2 * n, dtype=np.float32).view(np.complex64)
            for _ in range(4)]


def median_ms(fn, caps, reps=REPS) -> float:
    for x in caps:
        fn(x)
    ts = []
    for i in range(reps):
        t = time.perf_counter()
        fn(caps[i % len(caps)])
        ts.append(time.perf_counter() - t)
    return statistics.median(ts) * 1e3


def stage_ms(st, caps, reps=REPS) -> tuple[float, float]:
    """Median host ms of a staging call that finds the card idle, as a
    receive call does, and median ms until its copies have landed."""
    sync = torch.cuda.synchronize
    for x in caps:
        st(x)
    host, landed = [], []
    for i in range(reps):
        sync()
        t = time.perf_counter()
        st(caps[i % len(caps)])
        host.append(time.perf_counter() - t)
        sync()
        landed.append(time.perf_counter() - t)
    return statistics.median(host) * 1e3, statistics.median(landed) * 1e3


def main() -> None:
    dev = torch.device("cuda", 0)
    print(f"# {card_line(dev)}; torch {torch.__version__}; CPUs "
          f"{len(os.sched_getaffinity(0))} (fill_threads "
          f"{staging.fill_threads()})", flush=True)
    for name, n in SIZES.items():
        caps = captures(n, 7)
        nbytes = n * 8
        sync = torch.cuda.synchronize

        ms = median_ms(lambda x: torch.from_numpy(x).to(dev), caps)
        sync()
        print(f"pageable {name} host_ms {ms:.3f} GB/s "
              f"{nbytes / ms / 1e6:.2f}", flush=True)

        whole = torch.empty(n, dtype=torch.complex64, pin_memory=True)
        view = whole.numpy()
        for chunk_mib in (1, 4):
            plan = staging.chunk_plan(n, chunk_mib * MIB // 8)
            for t in (1, 2, 4, 8):
                with futures.ThreadPoolExecutor(t) as pool:
                    def fill(x):
                        list(pool.map(lambda ab: np.copyto(
                            view[ab[0]:ab[1]], x[ab[0]:ab[1]]), plan))
                    ms = median_ms(fill, caps)
                print(f"fill {name} chunk_mib {chunk_mib} threads {t} "
                      f"ms {ms:.3f} GB/s {nbytes / ms / 1e6:.2f}", flush=True)

        dst = torch.empty(n, dtype=torch.complex64, device=dev)
        for chunk_mib in (0.5, 1, 2, 4, 8, 16, nbytes / MIB):
            m = int(chunk_mib * MIB) // 8
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            for _ in range(3):
                dst[:m].copy_(whole[:m], non_blocking=True)
            a.record()
            for _ in range(50):
                dst[:m].copy_(whole[:m], non_blocking=True)
            b.record()
            sync()
            ms = a.elapsed_time(b) / 50
            print(f"copy {name} chunk_mib {chunk_mib:.2f} ms {ms:.4f} GB/s "
                  f"{m * 8 / ms / 1e6:.2f}", flush=True)

        for chunk_mib in (1, 2, 4):
            for slots in (8, 16, 32):
                if chunk_mib * slots > 64:
                    continue
                for t in (1, 2, 4, 8):
                    st = staging.CudaStager(dev, chunk=chunk_mib * MIB // 8,
                                            slots=slots, threads=t)
                    host, ms = stage_ms(st, caps)
                    st.ring.close()
                    print(f"stage {name} chunk_mib {chunk_mib} slots {slots} "
                          f"threads {t} host_ms {host:.3f} landed_ms "
                          f"{ms:.3f} GB/s {nbytes / ms / 1e6:.2f}",
                          flush=True)

        st = staging.CudaStager(dev)
        for x in caps + [caps[0][::2], caps[1][3:]]:
            if not torch.equal(st(x), torch.from_numpy(
                    np.ascontiguousarray(x)).to(dev)):
                raise SystemExit(f"the staged {name} capture differs")
        st.ring.close()
        print(f"equal {name} default ring", flush=True)


if __name__ == "__main__":
    main()
