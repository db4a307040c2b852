#!/usr/bin/env python3
"""What limits the J.83B FIR kernel on the card: its parts timed alone.

Run from the repository root on a machine with an H100 and the CUDA
toolkit: ``python3 tools/fir_limits.py``.  It compiles variants of
``dtv_utils_torch/csrc/fir_interp2.cu`` with one part of the work taken out
and times each, cold (L2 holding none of a launch's data), at the main
path's n = 1,806,210 and at 4n.  The slope between the two sizes is the
steady-state time per superblock, the intercept the fixed cost of a launch
(launch gap, first tile's latency, last tile's drain):

* ``kernel``: the kernel as it ships;
* ``no_fma``: one tap instead of 50 (the memory path alone);
* ``no_load``: no copies into shared memory (compute and stores);
* ``no_store``: no output written (loads and compute);
* ``compute``: neither loads nor stores;
* ``load_only``: loads, one tap, no stores;
* ``stages_2``: the kernel with a ring of 2 stages instead of 3.

Then it times PyTorch's own write, copy and read kernels on similar byte
counts, as yardsticks of what the card's memory gives such traffic.  The
variants compute garbage where a part is missing; ``kernel`` is checked
against the plain version.  Prints one line per variant.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs                                   # noqa: E402
from dtv_utils_torch.core.config import J83bConfig        # noqa: E402
from dtv_utils_torch.ops import _build, fir               # noqa: E402
from dtv_utils_torch.tx import j83b as txq                # noqa: E402

SRC = (ROOT / "dtv_utils_torch" / "csrc" / "fir_interp2.cu").read_text()
N = cs.FIR_SIZES[0]
SETS = 6


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"fir_interp2.cu changed: {old.strip()[:60]!r} "
                         "not found; update tools/fir_limits.py")
    return src.replace(old, new)


def variants() -> dict[str, str]:
    no_load = _sub(SRC, "    const long long g0 = m0 - kHist;",
                   "    return;\n    const long long g0 = m0 - kHist;")
    one_tap = "for (int j = 0; j < 1; ++j) {"
    taps_loop = "for (int j = 0; j < kTaps; ++j) {"
    start = SRC.index("#pragma unroll\n        for (int k2 = 0; "
                      "k2 < kPerThread / 2; ++k2)")
    end = SRC.index("        __syncwarp();\n    }\n}\n", start) \
        + len("        __syncwarp();\n")
    no_store = SRC[:start] + """        float sum = 0.0f;
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) sum += acc0[r] + acc1[r];
        if (sum == 1234.5f) out[lane] = sum;   // keeps the FMAs alive
""" + SRC[end:]
    return {
        "kernel": SRC,
        "no_fma": _sub(SRC, taps_loop, one_tap),
        "no_load": no_load,
        "no_store": no_store,
        "compute": _sub(no_store, "    const long long g0 = m0 - kHist;",
                        "    return;\n    const long long g0 = m0 - kHist;"),
        "load_only": _sub(no_store, taps_loop, one_tap),
        "stages_2": _sub(SRC, "kStages = 3;", "kStages = 2;"),
    }


def build(srcs: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together."""
    procs = {}
    for name, src in srcs.items():
        (out / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"{name}: {'; '.join(regs)}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.fir_interp2_split_launch.argtypes = [vp, ll, vp, ll, vp, ll, ll,
                                                 vp, vp]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("fir_limits: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line(dev)
    torch.backends.cudnn.allow_tf32 = False
    taps = txq.rrc_taps(J83bConfig())
    ph = fir._phase_taps(np.asarray(taps, np.float32).tobytes())
    g = torch.Generator(device=dev).manual_seed(85)
    data = {n: ([torch.randn(2, fir.HIST + n, generator=g, device=dev)
                 for _ in range(sets)],
                [torch.empty(2, 2 * n, device=dev) for _ in range(sets)])
            for n, sets in ((N, SETS), (4 * N, SETS // 2))}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(lib, n, k):
        ext, out = data[n][0][k], data[n][1][k]
        args = (ext.data_ptr(), ext.stride(0),
                ext.data_ptr() + 4 * fir.HIST, ext.stride(0),
                out.data_ptr(), out.stride(0), n,
                ph.ctypes.data_as(ctypes.c_void_p), stream)
        return lambda: lib.fir_interp2_split_launch(*args)

    with tempfile.TemporaryDirectory() as d:
        libs = build(variants(), Path(d))
        call(libs["kernel"], N, 0)()
        torch.testing.assert_close(data[N][1][0], fir.interp2_reference(
            data[N][0][0], taps, N), **cs.FIR_TOL)
        bytes_ms, ops_ms = cs.fir_bounds_ms(N)
        print(f"n = {N}: HBM bound {bytes_ms * 1e3:.2f} us, FMA bound "
              f"{ops_ms * 1e3:.2f} us; cold, {cs.FIR_TIMED} launches per "
              f"time, two turns; on {card}")
        times = {name: [] for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                times[name].append((
                    cs._queued_ms([call(lib, N, i % SETS)
                                   for i in range(cs.FIR_TIMED)]),
                    cs._queued_ms([call(lib, 4 * N, i % (SETS // 2))
                                   for i in range(cs.FIR_TIMED // 2)])))
        for name, runs in times.items():
            t1 = 1e3 * sum(r[0] for r in runs) / len(runs)
            t4 = 1e3 * sum(r[1] for r in runs) / len(runs)
            per_n = (t4 - t1) / 3
            print(f"{name:9s}: n {t1:.2f} us, 4n {t4:.2f} us; steady "
                  f"{per_n:.2f} us per n ({bytes_ms * 1e3 / per_n:.3f} of the "
                  f"HBM bound) + fixed {t1 - per_n:.2f} us")
        ext, out = data[N]
        src = [torch.randn(2, 2 * N, generator=g, device=dev)
               for _ in range(SETS)]
        for name, mk in (
                ("write 28.90 MB (fill_)", lambda k: lambda: out[k].fill_(1)),
                ("read 14.45 MB + write 14.45 MB (copy_)",
                 lambda k: lambda: out[k][:, :N + fir.HIST].copy_(ext[k])),
                ("read 28.90 MB + write 28.90 MB (copy_)",
                 lambda k: lambda: out[k].copy_(src[k]))):
            ms = cs._queued_ms([mk(i % SETS) for i in range(cs.FIR_TIMED)])
            print(f"torch {name}: {ms * 1e3:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
