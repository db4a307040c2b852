#!/usr/bin/env python3
"""Does a row's inverse FFT on the card depend on how many rows the call
holds?  For each length the OFDM chains use, random complex64 rows go
through ``torch.fft.ifft`` (cuFFT) in one call of B rows and in calls of
32 rows; the script prints the batch sizes B whose rows differ in any bit,
then checks that ``ops/cfft.ifft_unnormalized`` (which cuts a batch into
calls of at most ``IFFT_MAX_ROWS[n]`` rows) is batch-invariant at every B.

Run on a machine with a CUDA card, from the repository root:
``python3 tools/cufft_batch_probe.py`` (~10 s).  Exits 1 if the wrapper
is not batch-invariant.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

LENGTHS = (1024, 2048, 4096, 8192, 16384, 32768)
BATCHES = (1, 2, 8, 31, 32, 60, 64, 100, 104, 120, 124, 125, 126, 127, 128,
           129, 130, 140, 150, 160, 180, 200, 240, 248, 256, 300, 416, 480,
           512, 1024, 1088, 2048, 2176, 4200)
CHUNK = 32


def main() -> int:
    from dtv_utils_torch.ops import cfft

    if not torch.cuda.is_available():
        print("cufft_batch_probe: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    g = torch.Generator(device=dev).manual_seed(1)
    ok = True
    for n in LENGTHS:
        rows = min(4200, max(600, (1 << 25) // n))
        x = torch.complex(torch.randn(rows, n, generator=g, device=dev),
                          torch.randn(rows, n, generator=g, device=dev))
        ref = torch.cat([torch.fft.ifft(c, norm="forward")
                         for c in x.split(CHUNK)])
        raw, wrapped = [], []
        for b in (b for b in BATCHES if b <= rows):
            if not torch.equal(torch.fft.ifft(x[:b], norm="forward"), ref[:b]):
                raw.append(b)
            if not torch.equal(cfft.ifft_unnormalized(x[:b]), ref[:b]):
                wrapped.append(b)
        ok &= not wrapped
        print(f"n={n}: batches up to {rows} rows; torch.fft.ifft differs "
              f"from {CHUNK}-row calls at B={raw}; ifft_unnormalized at "
              f"B={wrapped} (max rows per call "
              f"{cfft.IFFT_MAX_ROWS.get(n, 'unlimited')})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
