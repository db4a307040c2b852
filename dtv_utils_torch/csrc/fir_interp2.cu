// J.83B RRC interpolate-by-2 polyphase FIR, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in dtv_utils_tpu/ops/fir.py: `_kernel`
// (:40), launched by `_interp2` (:57) through `pl.pallas_call` (:66), public
// wrapper `polyphase_interp2` (:118).  For each rail c (re, im), 0 <= m < n:
//
//     out[c, 2m + p] = sum_{j < 50} h[p][j] * x[c, m + j],   p = 0, 1
//
// where x[c] is 49 history samples (`tail`) followed by the n new cells
// (`cells`), and h[p] = taps[p::2] reversed (the Python wrapper prepares h).
// History and cells are two sources, so the caller never concatenates them.
//
// What bounds it on an H100 SXM.  One J.83B superblock (n = 1,806,210) reads
// 2 * (49 + n) floats (14.45 MB) and writes 2 * 2n floats (28.90 MB): 43.35
// MB, 12.94 us at 3.35 TB/s.  It does 2 rails * 2n outputs * 50 taps = 361.2
// M FMAs (722.5 MFLOP): 10.78 us at 67 TFLOP/s of fp32 outside the tensor
// cores.  The two bounds are within 20 %, so neither may wait for the other:
//   * Overlap.  A persistent grid (as many CTAs as fit on the card at once,
//     split evenly over the two rails) gives each CTA one contiguous range of
//     m, walked in tiles of kTile outputs.  A ring of kStages shared-memory
//     stages is fed by cp.async: while a tile is computed, the next two are
//     in flight.  One __syncthreads per tile both publishes the tile that
//     landed and frees the stage the next copy overwrites.
//   * FMA throughput.  A thread computes kPerThread consecutive m for both
//     phases from a 60-sample register window (15 16-byte shared loads), so
//     each staged sample feeds 2 * kPerThread FMAs: 800 FMAs of ~880
//     instructions per thread per tile.  The 100 taps are a by-value kernel
//     argument, so they live in the constant bank and each FMA reads its
//     tap from there: no load instruction for taps at all.  Sums run
//     j = 0..49 from 0, in the order of the plain version, which the kernel
//     matches bit for bit.
//   * Coalesced stores.  Each warp parks its 2 * 256 interleaved outputs in
//     its own shared buffer (swizzled so that neither side has bank
//     conflicts) and writes them back as float4s of consecutive lanes: 512
//     contiguous bytes per store instruction.  The phases leave interleaved,
//     as the caller wants, so no transpose pass follows (the TPU path
//     transposes afterwards, dtv_utils_tpu/ops/fir.py:129).
//   * Alignment.  A row may start at any 4-byte address.  Each rail's tile
//     grid starts at an origin in (-4, 0] chosen so that every 4-sample
//     chunk of `cells` a tile stages is 16-byte aligned in device memory and
//     in shared memory: those go as 16-byte cp.async.  Chunks that touch the
//     history, precede the first aligned cell or run past the end go as
//     4-byte cp.async with zero fill; no read leaves the rows.  An output
//     run that starts 8 bytes past a 16-byte boundary (the main path's: 49
//     history samples make every tile start at an odd m) is written shifted
//     by one float2, with a float2 at each end of the warp's run.
//   * Ragged ends.  Outputs outside [0, n) and outside the CTA's range are
//     not stored; samples a stored output does not need are not loaded.
// ptxas (nvcc -Xptxas -v, kept by ops/_build.py beside the library): 72
// registers, no spills; 41,584 bytes of dynamic shared memory.  Registers
// let 3 CTAs of 256 threads share an SM, 396 on an H100.  Measured there
// (chip_smoke.py, tools/fir_limits.py): ~23 us per launch with the L2
// cold, 0.56-0.57 of the HBM bound; in steady state (slope between n and
// 4n) 17.3 us per superblock, 0.75 of the bound, about the kernel with one
// tap instead of 50 (16.8 us): HBM traffic, not the FMA pipe (12.4 us
// without loads and stores), sets the pace, and ~5.7 us per launch is
// fixed (launch gap, first tile's loads, last tile's compute and stores).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kTaps = 50;                        // taps per phase
constexpr int kHist = kTaps - 1;                 // history samples
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPerThread = 8;                    // consecutive m per thread
constexpr int kWarpOut = 32 * kPerThread;        // m per warp per tile
constexpr int kTile = kWarps * kWarpOut;         // m per tile (2048)
constexpr int kWindow = 60;                      // >= kPerThread + kHist
constexpr int kStage = kTile - kPerThread + kWindow;  // samples per stage
constexpr int kChunks = kStage / 4;              // 16-byte chunks per stage
constexpr int kStages = 3;                       // ring depth
constexpr int kOutChunks = 2 * kWarpOut / 4;     // float4s per warp per tile
constexpr int kSmemBytes =
    4 * (kStages * kStage + kWarps * 2 * kWarpOut);
constexpr int kMaxDevices = 64;

static_assert(kWindow % 4 == 0 && kWindow >= kPerThread + kHist,
              "window must cover every tap of every output, in float4s");
static_assert(kPerThread % 2 == 0, "a float4 holds two m of both phases");
static_assert(kStage % 4 == 0, "stages must be whole 16-byte chunks");
static_assert(kOutChunks % 32 == 0, "the write-back gives each lane the "
              "same number of float4s");
static_assert(kSmemBytes <= 48 * 1024,
              "above 48 KB a launch needs cudaFuncSetAttribute first");

struct PhaseTaps {
    float h[2][kTaps];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, `bytes` of them read from src and the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// 4 bytes, or a zero when bytes == 0 (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Slot of float4 `c` in a warp's output buffer: the XOR spreads both the
// stores (lane l writes c = 4l + k) and the loads (lane l reads c = l + 32k)
// of eight lanes over the eight 16-byte bank groups.
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

// Stage x[m0 .. m0 + kStage) of one rail; samples from `need_end` on feed
// no stored output and are skipped.
__device__ __forceinline__ void load_tile(float* st, const float* tail,
                                          const float* cells, long long n,
                                          long long m0, long long need_end) {
    const long long g0 = m0 - kHist;             // cells index of x[m0]
    if (g0 >= 0 && g0 + kStage <= n && m0 + kStage <= need_end) {
        const float* src = cells + g0;           // the common, inner tile
        for (int q = threadIdx.x; q < kChunks; q += kThreads)
            cp_async16(st + 4 * q, src + 4 * q, 16);
        return;
    }
    for (int q = threadIdx.x; q < kChunks; q += kThreads) {
        const long long i = m0 + 4 * q;          // sample index in x
        if (i >= need_end) break;
        const long long g = i - kHist;           // index in cells
        float* dst = st + 4 * q;
        if (g >= 0) {                            // 16-byte aligned chunk
            const long long left = n - g;
            const int bytes = left >= 4 ? 16 : left > 0 ? 4 * int(left) : 0;
            cp_async16(dst, bytes ? cells + g : cells, bytes);
            continue;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {            // history or row head
            const long long s = i + e;
            const float* src = cells;
            int bytes = 0;
            if (s >= 0 && s < kHist) {
                src = tail + s;
                bytes = 4;
            } else if (s >= kHist && s - kHist < n) {
                src = cells + (s - kHist);
                bytes = 4;
            }
            cp_async4(dst + e, src, bytes);
        }
    }
}

__global__ void __launch_bounds__(kThreads, 2)
fir_interp2_kernel(const float* __restrict__ tail, long long tail_stride,
                   const float* __restrict__ cells, long long cells_stride,
                   float* __restrict__ out, long long out_stride,
                   long long n, const PhaseTaps taps)
{
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    float* obuf = smem + kStages * kStage + warp * (2 * kWarpOut);
    float4* obuf4 = reinterpret_cast<float4*>(obuf);
    const float2* obuf2 = reinterpret_cast<const float2*>(obuf);

    tail += blockIdx.y * tail_stride;
    cells += blockIdx.y * cells_stride;
    out += blockIdx.y * out_stride;

    // Origin of this rail's tile grid: x[origin + 4k + 49] = cells[g] with
    // cells + g 16-byte aligned.
    const long long a = (reinterpret_cast<uintptr_t>(cells) >> 2) & 3;
    const long long origin = -((a + 3) & 3);
    const long long per =
        ((n - origin + gridDim.x - 1) / gridDim.x + 3) & ~3LL;
    const long long lo = origin + blockIdx.x * per;
    if (lo >= n) return;
    const long long hi = lo + per < n ? lo + per : n;
    const long long keep_lo = lo > 0 ? lo : 0;     // first stored m
    const long long need_end = hi + kHist;
    const int tiles = static_cast<int>((hi - lo + kTile - 1) / kTile);

#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
        if (k < tiles)
            load_tile(smem + k * kStage, tail, cells, n,
                      lo + static_cast<long long>(k) * kTile, need_end);
        cp_async_commit();
    }

    for (int k = 0; k < tiles; ++k) {
        cp_async_wait<kStages - 2>();   // this thread's copies of tile k
        __syncthreads();                // everyone's; stage k-1 is free
        const int kn = k + kStages - 1;
        if (kn < tiles)
            load_tile(smem + (kn % kStages) * kStage, tail, cells, n,
                      lo + static_cast<long long>(kn) * kTile, need_end);
        cp_async_commit();

        const long long m0 = lo + static_cast<long long>(k) * kTile;
        const long long mb = m0 + warp * kWarpOut;      // warp's first m
        if (mb + kWarpOut <= keep_lo || mb >= hi) continue;

        const float4* x4 = reinterpret_cast<const float4*>(
            smem + (k % kStages) * kStage + warp * kWarpOut
            + lane * kPerThread);
        float w[kWindow];
#pragma unroll
        for (int q = 0; q < kWindow / 4; ++q) {
            const float4 v = x4[q];
            w[4 * q + 0] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
        }
        float acc0[kPerThread];
        float acc1[kPerThread];
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) {
            acc0[r] = 0.0f;
            acc1[r] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
#pragma unroll
            for (int r = 0; r < kPerThread; ++r) {
                acc0[r] = fmaf(taps.h[0][j], w[r + j], acc0[r]);
                acc1[r] = fmaf(taps.h[1][j], w[r + j], acc1[r]);
            }
        }
#pragma unroll
        for (int k2 = 0; k2 < kPerThread / 2; ++k2)
            obuf4[swz(lane * (kPerThread / 2) + k2)] = make_float4(
                acc0[2 * k2], acc1[2 * k2], acc0[2 * k2 + 1],
                acc1[2 * k2 + 1]);
        __syncwarp();

        float* o = out + 2 * mb;                 // the warp's 2 * 256 floats
        if (mb >= keep_lo && mb + kWarpOut <= hi) {
            if (((reinterpret_cast<uintptr_t>(o) >> 2) & 3) == 0) {
                float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
                for (int k2 = 0; k2 < kOutChunks / 32; ++k2)
                    o4[lane + 32 * k2] = obuf4[swz(lane + 32 * k2)];
            } else {                             // o is 8 mod 16 bytes
                float4* o4 = reinterpret_cast<float4*>(o + 2);
#pragma unroll
                for (int k2 = 0; k2 < kOutChunks / 32; ++k2) {
                    const int s = lane + 32 * k2;
                    if (s < kOutChunks - 1) {
                        const float2 u = obuf2[2 * swz(s) + 1];
                        const float2 v = obuf2[2 * swz(s + 1)];
                        o4[s] = make_float4(u.x, u.y, v.x, v.y);
                    } else {
                        reinterpret_cast<float2*>(o)[0] = obuf2[2 * swz(0)];
                        reinterpret_cast<float2*>(o)[kWarpOut - 1] =
                            obuf2[2 * swz(kOutChunks - 1) + 1];
                    }
                }
            }
        } else {                                 // a ragged end: per m
            float2* o2 = reinterpret_cast<float2*>(o);
#pragma unroll
            for (int k2 = 0; k2 < kPerThread; ++k2) {
                const int f = lane + 32 * k2;
                const long long m = mb + f;
                if (m >= keep_lo && m < hi)
                    o2[f] = obuf2[2 * swz(f >> 1) + (f & 1)];
            }
        }
        __syncwarp();
    }
}

int g_ctas[kMaxDevices];     // resident CTAs per device, 0 until asked

// As many CTAs as fit on the current device at once: the persistent grid.
cudaError_t resident_ctas(int* ctas) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (g_ctas[dev] == 0) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, fir_interp2_kernel, kThreads, kSmemBytes);
        if (err != cudaSuccess) return err;
        g_ctas[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    *ctas = g_ctas[dev];
    return cudaSuccess;
}

}  // namespace

// tail:  float32 rows [2, >= 49] at row stride tail_stride (floats);
// cells: float32 rows [2, >= n] at row stride cells_stride;
// out:   float32 rows [2, >= 2n] at row stride out_stride, each row 8-byte
//        aligned (out_stride even);
// every row of tail and cells may start at any 4-byte address and is read
// in place; taps_host: host float32 [2][50], phase-major, each phase
// reversed; stream: a cudaStream_t on the current device.  Returns
// cudaGetLastError() after the launch.
extern "C" int fir_interp2_split_launch(const float* tail,
                                        long long tail_stride,
                                        const float* cells,
                                        long long cells_stride,
                                        float* out, long long out_stride,
                                        long long n, const float* taps_host,
                                        void* stream)
{
    if (n <= 0) return static_cast<int>(cudaSuccess);
    if ((reinterpret_cast<uintptr_t>(out) & 7) || (out_stride & 1))
        return static_cast<int>(cudaErrorMisalignedAddress);
    int ctas = 0;
    const cudaError_t err = resident_ctas(&ctas);
    if (err != cudaSuccess) return static_cast<int>(err);
    PhaseTaps taps;
    std::memcpy(&taps, taps_host, sizeof(taps));
    const long long tiles = (n + 3 + kTile - 1) / kTile;
    long long per_rail = ctas / 2;
    if (per_rail > tiles) per_rail = tiles;
    if (per_rail < 1) per_rail = 1;
    const dim3 grid(static_cast<unsigned>(per_rail), 2);
    fir_interp2_kernel<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
        tail, tail_stride, cells, cells_stride, out, out_stride, n, taps);
    return static_cast<int>(cudaGetLastError());
}
