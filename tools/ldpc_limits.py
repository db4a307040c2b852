#!/usr/bin/env python3
"""What limits the min-sum kernels on the card: variants timed in turns.

Run from the repository root on a machine with an H100 and the CUDA
toolkit: ``python3 tools/ldpc_limits.py`` (~20 s).  It compiles variants
of ``dtv_utils_torch/csrc/ldpc_minsum.cu`` and times each kernel on one
BBC frame (202 FEC blocks of BPSK codewords at 2.5 dB Es/N0, after three
iterations), cold (two input sets in turn), forward and then backward
through the list, beside the kernel as it ships:

* ``check_chunk_N``: the check kernel loading N slots' totals at once
  (ships with 4);
* ``variable_chunk_N``: the variable kernel loading N edges' state at
  once (ships with 2);
* ``variable_thread``: the variable kernel with one thread per variable
  and codeword, each thread loading its own table entries and then only
  the one of m1 and m2 its slot needs (an earlier version of the
  shipped kernel).

Every variant is held to the shipped kernel's output bit for bit first.
Prints one line per variant; the spread between the two turns is the
noise of one call.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs                                   # noqa: E402
from dtv_utils_torch.models.dvbt2 import PROFILES         # noqa: E402
from dtv_utils_torch.ops import _build                    # noqa: E402
from dtv_utils_torch.ops import ldpc_decode as LD         # noqa: E402

SRC = (ROOT / "dtv_utils_torch" / "csrc" / "ldpc_minsum.cu").read_text()
TIMED = 12

THREAD_VARIABLE = """
    const int s = blockIdx.y;
    const int w = min(cols, batch - s * cols);
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= nldpc * w) return;
    const int v = t / w;
    const int lane = t - v * w;
    const long long own = static_cast<long long>(s) * nldpc * cols + t;
    const long long st = static_cast<long long>(s) * n_par * cols + lane;
    float acc = 0.0f;
    for (int d0 = 0; d0 < dv; d0 += 4) {
        int q[4];
        long long at[4];
        unsigned long long meta[4];
        float other[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            q[k] = d0 + k < dv ? var_pairs[(d0 + k) * nldpc + v] : -1;
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (q[k] >= 0) {
                at[k] = st + static_cast<long long>(q[k] >> kPairShift) * w;
                meta[k] = metas[at[k]];
            }
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (q[k] >= 0)
                other[k] = (unique_min(meta[k], q[k] & kSlotMask)
                                ? m2s : m1s)[at[k]];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (q[k] < 0) break;
            const float c = __fmul_rn(scale(meta[k], q[k] & kSlotMask),
                                      other[k]);
            acc = d0 + k == 0 ? c : __fadd_rn(acc, c);
        }
        if (q[3] < 0) break;
    }
    totals[own] = __fadd_rn(llr[own], acc);
}
"""


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"ldpc_minsum.cu changed: {old.strip()[:60]!r} "
                         "not found; update tools/ldpc_limits.py")
    return src.replace(old, new)


def variants() -> dict[str, str]:
    out = {"kernel": SRC}
    for n in (1, 2, 8, 16):
        out[f"check_chunk_{n}"] = _sub(SRC, "kChunk = 4;", f"kChunk = {n};")
    for n in (1, 4, 8):
        out[f"variable_chunk_{n}"] = _sub(SRC, "kVarChunk = 2;",
                                          f"kVarChunk = {n};")
    head = SRC.index("{", SRC.index("ldpc_variable_kernel(")) + 1
    tail = SRC.index("\n}\n", head) + 3
    out["variable_thread"] = SRC[:head] + THREAD_VARIABLE + SRC[tail:]
    return out


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
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"{name}: {'; '.join(regs)}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.ldpc_check_launch.argtypes = [vp] * 6 + [ll] * 5 + [vp]
        lib.ldpc_variable_launch.argtypes = [vp] * 5 + [ll] * 5 + [vp, vp]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ldpc_limits: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line(dev)
    cfg = PROFILES["bbc"]
    llr = cs.coded_llrs(cfg, cfg.fec_blocks, cs.LDPC_ES_N0_DB,
                        cs.DEC_NOISE_SEED, dev)
    dg, llr_s, totals, state = LD._start(cfg, llr)
    for _ in range(3):
        LD._variable_totals(dg, llr_s, state, totals)
        state = LD._check_update(dg, totals, state)
    want_totals = torch.empty_like(totals)
    LD._variable_totals(dg, llr_s, state, want_totals)
    want_state = tuple(x.clone() for x in state)
    LD._check_update(dg, want_totals, want_state)
    sets = [(torch.empty_like(totals), tuple(x.clone() for x in state))
            for _ in range(2)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    dv = dg["var_pairs"].shape[0]

    def variable(lib, k):
        out = sets[k][0]
        args = (llr_s.data_ptr(), *(x.data_ptr() for x in state),
                dg["var_pairs"].data_ptr(), dg["nldpc"], dg["n_par"], dv,
                dg["batch"], dg["cols"], out.data_ptr(), stream)
        return lambda: lib.ldpc_variable_launch(*args)

    def check(lib, k):
        args = (want_totals.data_ptr(), *(x.data_ptr() for x in sets[k][1]),
                dg["chk_start"].data_ptr(), dg["edge_var"].data_ptr(),
                dg["nldpc"], dg["n_par"], dg["D"], dg["batch"], dg["cols"],
                stream)
        return lambda: lib.ldpc_check_launch(*args)

    with tempfile.TemporaryDirectory() as d:
        libs = build(variants(), Path(d))
        runs = []
        for name, lib in libs.items():
            for kind, fn in (("variable", variable), ("check", check)):
                if name != "kernel" and not name.startswith(kind):
                    continue
                for k, (out, st) in enumerate(sets):
                    for x, y in zip(st, state):
                        x.copy_(y)
                    if fn(lib, k)():
                        raise SystemExit(f"{name}: launch failed")
                    torch.cuda.synchronize()
                    got = (out,) if kind == "variable" else st
                    want = ((want_totals,) if kind == "variable"
                            else want_state)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise SystemExit(f"{name} ({kind}) differs from the "
                                         "shipped kernel")
                runs.append((f"{name} ({kind})",
                             [fn(lib, i % 2) for i in range(TIMED)]))
        ms = {label: [] for label, _ in runs}
        for order in (runs, runs[::-1]):
            for label, calls in order:
                ms[label].append(cs._queued_ms(calls))
    print(f"BBC frame, {dg['batch']} FEC blocks, slices of {dg['cols']}; "
          f"cold ms per launch, two turns; on {card}")
    for label, (a, b) in ms.items():
        print(f"  {label:28s} {a:.5f} / {b:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
