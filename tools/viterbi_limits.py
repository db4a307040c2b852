#!/usr/bin/env python3
"""What limits the Viterbi kernels on the card: variants timed in turns.

Run from the repository root on a machine with an H100 and the CUDA
toolkit: ``python3 tools/viterbi_limits.py [--parent TREE [--rx-ab]]
[--only NAMES]`` (a few minutes on 8 cores, most of it ~45 nvcc builds; ~2
more with ``--rx-ab``).  It modulates the DVB-T flagship's 2 superframes
and J.83B's 2 superblocks (``chip_smoke.seeded_ts`` with the goldens'
seeds), captures the pairs their receivers hand the ACS
(``chip_smoke.viterbi_args``: K=7, L = 4656, B = 4218 and K=5, L = 4346,
B = 1412), holds the shipped kernels to their plain versions there, and
compiles variants of ``dtv_utils_torch/csrc/viterbi.cu`` with other
values of its constants:

* ``acs_k7_inplace_tT_pP_...``: K=7 on a kernel this file holds
  (``INPLACE_KERNEL``, a design that loses): the states in place, the
  metrics transposed through shared memory every third step; T threads
  per CTA (32, 64, 128), pairs loaded P steps ahead (6, 12, 24);
* ``acs_k7_lN_tT_pP_sE_..._k5_...``: the shipped kernel, a grid per K
  over lanes per block (``ACS_LANES_K7``: 8, 4; ``ACS_LANES_K5``: 16, 8,
  4), threads per CTA (32, 128), steps of pairs loaded ahead (8, 16) and
  the exchange by shuffles or through shared memory (``ACS_SMEM_K*``: 0,
  1); then, the rest as shipped, 32 and 16 lanes at K=7, 2 and 1 at K=5.
  A build holds a point of each K's list, and both are timed;
* ``tb_kK_threads_N_batch_T_x_R``: the traceback at K with CTAs of N
  threads and a ring of R batches of T steps (``TB_*_K*``; only rings
  within 48 KB);
* ``parent`` (with ``--parent TREE``): TREE's ``viterbi.cu`` as it is,
  e.g. the parent commit unpacked by ``git archive``.

Every variant's output is held to the shipped kernel's bit for bit first
(packed decisions, final metrics, bits).  Each kernel a variant changes
is then timed cold (two input sets in turn, ``chip_smoke._queued_ms``),
forward and then backward through the list: one line per variant and
kernel, ms per launch and ns per trellis step in both turns; for the ACS
also the warps its grid holds per SM, and each step's time in cycles of
the card's maximum SM clock.

With ``--parent TREE --rx-ab`` it then times ``dvbt-rx`` (2 flagship
superframes at 20.0 dB) and ``qam-rx`` (2 J.83B superblocks at 27 dB)
with TREE's package and this one in turns (TREE, this, this, TREE), each
turn its own process: host ms per call (median of 3 after a warm-up),
Msamples/s, and one call under ``torch.profiler``: device busy ms (the
union of its activities) and the summed ms of the kernels named
``viterbi_``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC_PATH = ROOT / "dtv_utils_torch" / "csrc" / "viterbi.cu"
TIMED = 6
TB_RING_BYTES = 48 << 10           # static shared memory a CTA may hold
KERNELS = (("acs", 7), ("acs", 5), ("traceback", 7), ("traceback", 5))
ACS_AXES = ("LANES", "THREADS", "PREFETCH", "SMEM")


def _const(src: str, name: str) -> int:
    m = re.search(rf"\b{name} = (\d+)[,;]", src)
    if not m:
        raise SystemExit(f"viterbi.cu has no constant {name}; update "
                         "tools/viterbi_limits.py")
    return int(m.group(1))


def _set(src: str, **values: int) -> str:
    for name, v in values.items():
        _const(src, name)
        src = re.sub(rf"\b{name} = \d+([,;])", rf"{name} = {v}\1", src)
    return src


def _grid(src: str, axes: dict[str, tuple]) -> list[dict[str, int]]:
    """Every combination of ``axes`` (constant name -> values) but the
    shipped one."""
    combos = [{}]
    for name, values in axes.items():
        combos = [c | {name: v} for c in combos for v in values]
    return [c for c in combos
            if any(_const(src, n) != v for n, v in c.items())]


# A K=7 design that loses to the shipped one, kept here to be timed beside
# it: each lane holds both predecessors of its butterflies, so the
# metrics move between lanes once every three steps (an 8 x 8 transpose
# through shared memory) in place of every step, and the decision rows
# are transposed across lanes in w-bit fields.  tests/
# test_torch_decoder_kernels.py models it in NumPy.
INPLACE_KERNEL = r"""
// K = 7 at 8 lanes per block with the states in place.  A lane that
// holds both predecessors 2j and 2j + 1 of a butterfly computes its two
// successors j and j + 32 with no exchange.  Lane l starts a cycle of
// three steps (phases 0, 1, 2) holding the states whose bits 5..3 are l;
// each step moves those lane bits one place down (the successors of
// registers 2k, 2k + 1 land in registers k, k + 4, in every phase), so
// after three steps they are bits 2..0 and the block's 8 x 8 metrics are
// transposed through shared memory, once per three steps.  A lane's 8
// decisions of a step land in bytes that depend on the phase: the lanes
// that share a byte swap w-bit fields in log2(8 / w) xor-shuffle rounds
// (w = 4, 2, 1 in phases 0, 1, 2: a transpose of the lanes' rows) and
// each lane stores one byte.  The owner normalises its own metrics; the
// block's max goes through shared memory.
template <int G1, int G2, int THREADS, int U>
__global__ void __launch_bounds__(THREADS)
viterbi_acs_inplace_kernel(const float2* __restrict__ pairs, int L, int B,
                           uint8_t* __restrict__ decs,
                           float* __restrict__ final_metrics)
{
    constexpr int K = 7, S = 64, LANES = 8, G = 4, F = 3;
    static_assert(U % F == 0, "whole cycles of three steps per batch");
    __shared__ __align__(16) float tbuf[THREADS / 32][G][72];  // padded
    __shared__ __align__(16) float mbuf[2][THREADS / 32][32];

    const int lane = threadIdx.x & 31;
    const int l = lane % LANES;
    const int seg = lane / LANES;
    const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
    if (warp * G >= B) return;               // the whole warp is past B
    const int b = warp * G + seg;
    const bool active = b < B;
    const int bl = active ? b : B - 1;       // spare lanes read, never store

    // phase φ's successors hold the lane's bits at 2 - φ .. 4 - φ: their
    // codes are the free bits' ^ lane_code[φ], so their metrics are ±A or
    // ±Bm; the lane stores byte rotr3(l, φ + 1) of the step's word
    bool swap_sd[F];
    float sign[F];
    int byte_at[F];
#pragma unroll
    for (int ph = 0; ph < F; ++ph) {
        const int lc = branch_code<K, G1, G2>(l << (F - 1 - ph), 0);
        swap_sd[ph] = ((lc ^ (lc >> 1)) & 1) != 0;
        sign[ph] = (lc & 2) ? -1.0f : 1.0f;
        byte_at[ph] = ((l >> (ph + 1)) | (l << (2 - ph))) & 7;
    }
    uint8_t* out = decs + static_cast<size_t>(bl) * 8;
    const size_t step_bytes = static_cast<size_t>(B) * 8;
    float* tb = &tbuf[threadIdx.x >> 5][seg][0];

    float m[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) m[r] = 0.0f;

    auto step = [&](auto phase, float2 xy, int t) {
        constexpr int PH = decltype(phase)::value;
        // successor register r holds free bits: (r >> (2 - PH)) at
        // 5 - PH .. 5, r's low 2 - PH bits at 0 ..
        constexpr int LOW = F - 1 - PH;
        const float s = __fadd_rn(xy.x, xy.y);
        const float d = __fsub_rn(xy.x, xy.y);
        const float A = __fmul_rn(swap_sd[PH] ? d : s, sign[PH]);
        const float Bm = __fmul_rn(swap_sd[PH] ? s : d, sign[PH]);
        float n[8];
        unsigned chunk = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int lo =
                ((k >> LOW) << (5 - PH)) | (k & ((1 << LOW) - 1));
            const int hi = lo | 32;
            const float l0 = __fadd_rn(
                m[2 * k], lane_metric(branch_code<K, G1, G2>(lo, 0), A, Bm));
            const float l1 = __fadd_rn(
                m[2 * k + 1],
                lane_metric(branch_code<K, G1, G2>(lo, 1), A, Bm));
            const float h0 = __fadd_rn(
                m[2 * k], lane_metric(branch_code<K, G1, G2>(hi, 0), A, Bm));
            const float h1 = __fadd_rn(
                m[2 * k + 1],
                lane_metric(branch_code<K, G1, G2>(hi, 1), A, Bm));
            const bool dl = l1 > l0;
            const bool dh = h1 > h0;
            n[k] = dl ? l1 : l0;
            n[k + 4] = dh ? h1 : h0;
            chunk |= (static_cast<unsigned>(dl) << k) |
                     (static_cast<unsigned>(dh) << (k + 4));
        }
        float mx = fmaxf(fmaxf(fmaxf(n[0], n[1]), fmaxf(n[2], n[3])),
                         fmaxf(fmaxf(n[4], n[5]), fmaxf(n[6], n[7])));
        {
            float* own = &mbuf[t & 1][threadIdx.x >> 5][0];
            own[lane] = mx;
            __syncwarp();
            const float4* blk =
                reinterpret_cast<const float4*>(own + seg * LANES);
            const float4 u = blk[0], v = blk[1];
            mx = fmaxf(fmaxf(fmaxf(u.x, u.y), fmaxf(u.z, u.w)),
                       fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) m[r] = __fsub_rn(n[r], mx);
        // the lanes' rows of w-bit fields, transposed over PH + 1 bits of
        // the lane index
#pragma unroll
        for (int o = 1 << PH; o > 0; o >>= 1) {
            const int sh = o * (4 >> PH);
            const unsigned keep = sh == 4 ? 0x0fu : sh == 2 ? 0x33u : 0x55u;
            const unsigned q = __shfl_xor_sync(kFull, chunk, o, LANES);
            chunk = (l & o) ? (chunk & ~keep & 0xffu) | ((q >> sh) & keep)
                            : (chunk & keep) | ((q & keep) << sh);
        }
        if (active)
            out[static_cast<size_t>(t) * step_bytes + byte_at[PH]] =
                static_cast<uint8_t>(chunk);
        if constexpr (PH == F - 1) {
            // lane l holds states (r << 3) | l; give it (l << 3) | r
            __syncwarp();
#pragma unroll
            for (int r = 0; r < 8; ++r) tb[(r << 3) | l] = m[r];
            __syncwarp();
            const float4 u = reinterpret_cast<const float4*>(tb)[2 * l];
            const float4 v = reinterpret_cast<const float4*>(tb)[2 * l + 1];
            m[0] = u.x, m[1] = u.y, m[2] = u.z, m[3] = u.w;
            m[4] = v.x, m[5] = v.y, m[6] = v.z, m[7] = v.w;
        }
    };
    auto load = [&](int t) {
        return t < L ? pairs[static_cast<size_t>(t) * B + bl]
                     : make_float2(0.0f, 0.0f);
    };
    using P0 = std::integral_constant<int, 0>;
    using P1 = std::integral_constant<int, 1>;
    using P2 = std::integral_constant<int, 2>;

    float2 cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = load(u);
    int t0 = 0;
    for (; t0 + U <= L; t0 += U) {
        float2 nxt[U];
#pragma unroll
        for (int u = 0; u < U; ++u) nxt[u] = load(t0 + U + u);
#pragma unroll
        for (int u = 0; u < U; u += F) {
            step(P0{}, cur[u], t0 + u);
            step(P1{}, cur[u + 1], t0 + u + 1);
            step(P2{}, cur[u + 2], t0 + u + 2);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
    int last = 2;                            // the last step's phase
#pragma unroll
    for (int u = 0; u < U - 1; u += F) {
        if (t0 + u < L) step(P0{}, cur[u], t0 + u), last = 0;
        if (t0 + u + 1 < L) step(P1{}, cur[u + 1], t0 + u + 1), last = 1;
        if (t0 + u + 2 < L) step(P2{}, cur[u + 2], t0 + u + 2), last = 2;
    }
    if (active) {
        // after phase 0 or 1 the lane's bits are at 2 - last .. 4 - last;
        // after phase 2 (transposed) at 3 .. 5
        const int low = last == 2 ? 3 : 2 - last;
        float* f = final_metrics + static_cast<size_t>(b) * S;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int state =
                last == 2 ? (l << 3) | r
                          : ((r >> low) << (5 - last)) | (l << low) |
                                (r & ((1 << low) - 1));
            f[state] = m[r];
        }
    }
}
"""

INPLACE_LAUNCH = r"""
template <int G1, int G2, int THREADS, int U>
int acs_inplace_launch(const void* pairs, int L, int B, void* decs,
                       void* final_metrics, cudaStream_t stream)
{
    const long long warps = (static_cast<long long>(B) + 3) / 4;
    const long long ctas = (warps * 32 + THREADS - 1) / THREADS;
    viterbi_acs_inplace_kernel<G1, G2, THREADS, U>
        <<<static_cast<unsigned>(ctas), THREADS, 0, stream>>>(
            static_cast<const float2*>(pairs), L, B,
            static_cast<uint8_t*>(decs), static_cast<float*>(final_metrics));
    return static_cast<int>(cudaGetLastError());
}
"""


def _inplace(src: str, threads: int, prefetch: int) -> str:
    """``src`` with K=7 dispatched to the in-place kernel."""
    dispatch = "    if (k == 7 && g1 == kG1K7 && g2 == kG2K7)\n"
    for old in ("// cp.async of BYTES", "template <int K, int THREADS, int TB",
                dispatch):
        if old not in src:
            raise SystemExit(f"viterbi.cu changed: {old.strip()!r} not "
                             "found; update tools/viterbi_limits.py")
    src = src.replace("// cp.async of BYTES",
                      INPLACE_KERNEL + "\n// cp.async of BYTES", 1)
    launch = "template <int K, int THREADS, int TB"
    src = src.replace(launch, INPLACE_LAUNCH + "\n" + launch, 1)
    return src.replace(dispatch, (
        f"{dispatch}        return acs_inplace_launch<kG1K7, kG2K7, "
        f"{threads}, {prefetch}>(\n"
        "            pairs, l, b, decs, final_metrics, s);\n" + dispatch), 1)


def _lanes(vsrc: str, k: int) -> int | None:
    """Lanes per block of the ACS that ``vsrc`` builds at K (None where its
    source does not name them)."""
    if k == 7 and "acs_inplace_launch<kG1K7" in vsrc:
        return 8
    m = re.search(rf"\bACS_LANES_K{k} = (\d+)[,;]", vsrc)
    return int(m.group(1)) if m else None


def variants(src: str, parent: str | None) -> dict[str, tuple[str, tuple]]:
    """name -> (source, the kernels it changes).  The ACS lists of the two
    K share builds: build i takes the i-th point of each."""
    out = {"kernel": (src, KERNELS)}
    general = {k: {f"ACS_LANES_K{k}": lanes,
                   f"ACS_THREADS_K{k}": (32, 128),
                   f"ACS_PREFETCH_K{k}": (8, 16),
                   f"ACS_SMEM_K{k}": (0, 1)}
               for k, lanes in ((7, (8, 4)), (5, (16, 8, 4)))}
    points = {
        7: [(t, u) for t in (32, 64, 128) for u in (6, 12, 24)]
        + _grid(src, general[7]) + [{"ACS_LANES_K7": n} for n in (32, 16)],
        5: _grid(src, general[5])
        + [{"ACS_LANES_K5": n} for n in (2, 1)]}
    for i in range(max(map(len, points.values()))):
        vals, inplace, kernels, name = {}, None, [], []
        for k, pts in points.items():
            if i >= len(pts):
                continue
            kernels.append(("acs", k))
            if isinstance(pts[i], tuple):
                inplace = pts[i]
                name.append("k7_inplace_t{}_p{}".format(*inplace))
                continue
            vals |= pts[i]
            point = _set(src, **pts[i])
            name.append(f"k{k}" + "".join(
                f"_{x[0].lower()}{_const(point, f'ACS_{x}_K{k}')}"
                for x in ACS_AXES))
        vsrc = _set(src, **vals)
        out["acs_" + "_".join(name)] = (
            _inplace(vsrc, *inplace) if inplace else vsrc, tuple(kernels))
    for k in (7, 5):
        axes = tuple(f"TB_{x}_K{k}" for x in ("THREADS", "BATCH", "BATCHES"))
        shipped = tuple(_const(src, c) for c in axes)
        for threads in (32, 64):
            for ring in ((16, 4), (32, 2), (32, 4), (32, 6), (16, 8),
                         (64, 3)):
                point = (threads, *ring)
                slot = 8 if k == 7 else 4         # bytes per ring entry
                if (threads * ring[0] * ring[1] * slot > TB_RING_BYTES
                        or point == shipped):
                    continue
                out["tb_k{}_threads_{}_batch_{}_x_{}".format(k, *point)] = (
                    _set(src, **dict(zip(axes, point))),
                    (("traceback", k),))
    if parent:
        psrc = Path(parent, "dtv_utils_torch", "csrc", "viterbi.cu")
        out["parent"] = (psrc.read_text(), KERNELS)
    return out


def build(srcs: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, as many at once as there are cores."""
    from dtv_utils_torch.ops import _build

    def one(name: str) -> tuple[str, str]:
        (out / f"{name}.cu").write_text(srcs[name])
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{res.stdout}"
                             f"{res.stderr}")
        return name, res.stdout + res.stderr

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        logs = dict(pool.map(one, srcs))
    print(f"built {len(srcs)} variants in {time.perf_counter() - t0:.1f} s")
    libs = {}
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in srcs:
        regs = [ln.split(":", 1)[1].strip() for ln in logs[name].splitlines()
                if "registers" in ln]
        print(f"  {name}: {'; '.join(regs)}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.viterbi_acs_launch.argtypes = [i, vp, ll, ll, i, i, vp, vp, vp]
        lib.viterbi_traceback_launch.argtypes = [i, vp, vp, ll, ll, vp, vp]
        libs[name] = lib
    return libs


def flagship_iq(dev):
    """The IQ chip_smoke.py receives: the DVB-T flagship's and J.83B's
    golden inputs, modulated on ``dev``."""
    import chip_smoke as cs
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.tx import dvbt as txd
    from dtv_utils_torch.tx import j83b as txq

    g = json.loads(cs.DVBT_GOLDEN.read_text())
    cfg = cs.dvbt_flagship()
    dvbt_ts = cs.seeded_ts(g["seed"],
                           g["superframes"] * cfg.ts_bytes_per_superframe)
    dvbt_iq, _ = txd.modulate_stream(cfg, dvbt_ts, device=dev)
    jg = json.loads(cs.GOLDEN.read_text())
    j83b_ts = cs.seeded_ts(jg["seed"],
                           jg["superblocks"] * txq.SUPERBLOCK_BYTES)
    j83b_iq, _ = txq.modulate_stream(J83bConfig(), j83b_ts, device=dev)
    return (dvbt_iq, dvbt_ts), (j83b_iq, j83b_ts)


def sweep(parent: str | None, only: str | None) -> None:
    import torch

    import chip_smoke as cs
    from dtv_utils_torch.ops import viterbi as V

    dev = torch.device("cuda", 0)
    card = cs.card_line(dev)
    (dvbt_iq, _), (j83b_iq, _) = flagship_iq(dev)
    cases = {}
    for case, (label, (pairs, k, g1, g2)) in cs.viterbi_args(
            dev, dvbt_iq, j83b_iq).items():
        packed, final = V._acs(pairs, k, g1, g2)
        bits = V._traceback(packed, final, k)
        decs, want_final = V.acs_reference(pairs, k, g1, g2)
        if not (torch.equal(packed, V.pack_decisions(decs))
                and torch.equal(final, want_final)
                and torch.equal(bits, V.traceback_reference(packed, final,
                                                            k))):
            raise SystemExit(f"{label}: the shipped kernels differ from "
                             "the plain versions")
        del decs, want_final
        cases[k] = dict(label=label, g=(g1, g2), want=(packed, final, bits),
                        pairs=[pairs, pairs.clone()],
                        acs_out=[(torch.empty_like(packed),
                                  torch.empty_like(final)) for _ in range(2)],
                        tb_in=[(packed, final), (packed.clone(),
                                                 final.clone())],
                        tb_out=[torch.empty_like(bits) for _ in range(2)])
        print(f"{label} (K={k}, L={pairs.shape[0]}, B={pairs.shape[1]}): "
              "the shipped kernels equal the plain versions")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(lib, kind, k, j):
        c = cases[k]
        L, B = c["pairs"][0].shape[:2]
        if kind == "acs":
            d, f = c["acs_out"][j]
            args = (k, c["pairs"][j].data_ptr(), L, B, *c["g"],
                    d.data_ptr(), f.data_ptr(), stream)
            return lambda: lib.viterbi_acs_launch(*args)
        d, f = c["tb_in"][j]
        args = (k, d.data_ptr(), f.data_ptr(), L, B,
                c["tb_out"][j].data_ptr(), stream)
        return lambda: lib.viterbi_traceback_launch(*args)

    src = SRC_PATH.read_text()
    vs = variants(src, parent)
    if only:
        vs = {n: vs[n] for n in only.split(",")}
    with tempfile.TemporaryDirectory() as d:
        libs = build({n: s for n, (s, _) in vs.items()}, Path(d))
        runs = []
        for name, (vsrc, kernels) in vs.items():
            for kind, k in kernels:
                c = cases[k]
                for j in range(2):
                    if call(libs[name], kind, k, j)():
                        raise SystemExit(f"{name} ({kind}, K={k}): launch "
                                         "failed")
                torch.cuda.synchronize()
                got = ([x for o in c["acs_out"] for x in o] if kind == "acs"
                       else c["tb_out"])
                want = (c["want"][:2] * 2 if kind == "acs"
                        else [c["want"][2]] * 2)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"{name} ({kind}, K={k}) differs from "
                                     "the shipped kernel")
                lanes = _lanes(vsrc, k) if kind == "acs" else None
                runs.append((f"{name} ({kind} K={k})", k, lanes,
                             [call(libs[name], kind, k, i % 2)
                              for i in range(TIMED)]))
        ms = {label: [] for label, *_ in runs}
        for order in (runs, runs[::-1]):
            for label, _, _, calls in order:
                ms[label].append(cs._queued_ms(calls))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = cs.fp32_instruction_rate(dev) / (cs.FP32_LANES_PER_SM * sms * 1e6)
    print(f"cold ms per launch and ns per trellis step, two turns "
          f"(forward, backward); for the ACS its warps per SM ({sms} SMs) "
          f"and cycles per step at {mhz:.0f} MHz; on {card}")
    for label, k, lanes, _ in runs:
        L, B = cases[k]["pairs"][0].shape[:2]
        a, b = ms[label]
        line = (f"  {label:56s} {a:.5f} / {b:.5f} ms  "
                f"{1e6 * a / L:.2f} / {1e6 * b / L:.2f} ns per step")
        if lanes:
            warps = -(-B // (32 // lanes))
            line += (f"  {warps} warps, {warps / sms:.2f} per SM, "
                     f"{a / L * mhz * 1e3:.0f} cycles per step")
        print(line)


def one_side(tree: str) -> dict:
    """dvbt-rx and qam-rx with ``tree``'s package (run in its own
    process)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import dtv_utils_torch
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.rx import dvbt as rxd
    from dtv_utils_torch.rx import j83b as rxq

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    print(f"package {Path(dtv_utils_torch.__file__).parent}",
          file=sys.stderr)
    dev = torch.device("cuda", 0)
    (dvbt_iq, dvbt_ts), (j83b_iq, j83b_ts) = flagship_iq(dev)
    out = {}
    for name, cfg, rx, iq, ts, snr in (
            ("dvbt", cs.dvbt_flagship(), rxd, dvbt_iq, dvbt_ts,
             cs.RX_DVBT_SNR_DB),
            ("j83b", J83bConfig(), rxq, j83b_iq, j83b_ts, cs.RX_J83B_SNR_DB)):
        x = torch.from_numpy(cs.awgn(iq, snr, cs.RX_NOISE_SEED)).to(dev)

        def once():
            return rx.demodulate_stream(cfg, x, device=dev)

        got = once().ts
        if len(got) == 0 or not np.array_equal(got, ts[:len(got)]):
            raise AssertionError(f"{name} rx lost the TS")
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            once()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            once()
            torch.cuda.synchronize()
        _, acts, busy_us, _, _ = cs._trace_summary(prof)
        s = statistics.median(secs)
        out |= {f"{name}_call_ms": 1e3 * s,
                f"{name}_msps": x.numel() / s / 1e6,
                f"{name}_device_ms": busy_us / 1e3,
                f"{name}_viterbi_ms": sum(e["dur"] for e in acts
                                          if "viterbi_" in e["name"]) / 1e3,
                f"{name}_activities": len(acts)}
    return out


def rx_ab(parent: str) -> None:
    import torch

    import chip_smoke as cs
    card = cs.card_line(torch.device("cuda", 0))
    res: dict[str, list[dict]] = {"parent": [], "this": []}
    for side in ("parent", "this", "this", "parent"):
        root = parent if side == "parent" else str(ROOT)
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--side", root], capture_output=True,
                             text=True, timeout=900, check=True)
        print(run.stderr, end="", file=sys.stderr)
        res[side].append(json.loads(run.stdout.strip().splitlines()[-1]))
    print(f"dvbt-rx (2 flagship superframes at {cs.RX_DVBT_SNR_DB} dB) and "
          f"qam-rx (2 superblocks at {cs.RX_J83B_SNR_DB} dB), {parent} and "
          f"this tree in turns (parent, this, this, parent); on {card}")
    for key in res["this"][0]:
        per = {s: [r[key] for r in res[s]] for s in res}
        print(f"  {key}: parent " + " / ".join(f"{v:.3f}" for v in
                                              per["parent"])
              + f" (mean {statistics.mean(per['parent']):.3f}); this "
              + " / ".join(f"{v:.3f}" for v in per["this"])
              + f" (mean {statistics.mean(per['this']):.3f})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="TREE",
                    help="another tree of this repository: its viterbi.cu "
                    "joins the sweep, and the receivers run in turns")
    ap.add_argument("--only", metavar="NAMES",
                    help="comma-separated variants to sweep (e.g. "
                    "kernel,parent); all by default")
    ap.add_argument("--rx-ab", action="store_true",
                    help="also time the receivers with --parent's package "
                    "and this one in turns")
    ap.add_argument("--no-sweep", action="store_true",
                    help="no kernel sweep (with --rx-ab: only the "
                    "receivers)")
    ap.add_argument("--side", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        print(json.dumps(one_side(args.side)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("viterbi_limits: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if not args.no_sweep:
        sweep(args.parent, args.only)
    if args.rx_ab:
        if not args.parent:
            ap.error("--rx-ab needs --parent")
        rx_ab(args.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
