// J.83B RRC interpolate-by-2 polyphase FIR, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in dtv_utils_tpu/ops/fir.py (`_kernel`,
// launched by `_interp2` through `pl.pallas_call`, public wrapper
// `polyphase_interp2`).  For each rail c (re, im) and 0 <= m < n:
//
//     out[c, 2m + p] = sum_{j < 50} h[p][j] * ext[c, m + j],   p = 0, 1
//
// where ext[c] is 49 history samples followed by the n new cells, and
// h[p] = taps[p::2] reversed (the Python wrapper prepares h).
//
// What bounds it on an H100.  For one superblock (n = 1,806,210) the kernel
// must read 2*(n+49) floats (14.4 MB) and write 4n floats (28.9 MB): about
// 13 us at 3.35 TB/s.  It does 2 rails * 2n outputs * 50 = 361 M FMAs:
// about 11 us at the 67 TFLOP/s of plain fp32.  The two bounds are close,
// so the design touches device memory once and keeps the FMA pipe fed:
//   * A block owns one rail and a tile of kTile consecutive m.  It stages
//     ext[c, m0 : m0 + kStage] in shared memory with coalesced loads; the
//     49-sample halo overlaps the next block's tile and comes from L2.
//   * A thread computes kPerThread consecutive m for both phases from a
//     register window filled by 16-byte shared loads, so each staged sample
//     feeds 2 * kPerThread FMAs rather than 2 and the shared-load pipe is
//     not the limit.
//   * The 100 taps are a by-value kernel argument.  Kernel arguments live
//     in the constant bank, and with the loops unrolled each FMA reads its
//     tap straight from there: no load instruction for taps at all.
//   * Both phases of one m leave as one float2 store, in the interleaved
//     order the caller wants, so no transpose pass follows (the TPU path
//     transposes afterwards, dtv_utils_tpu/ops/fir.py:129).
//   * The ragged last tile is masked: zeros past the input on load, no
//     store past n.
// It is a first, simple kernel: no TMA, no cp.async pipeline, no tuning.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kTaps = 50;                    // taps per phase
constexpr int kHist = kTaps - 1;             // history samples before cell 0
constexpr int kThreads = 256;
constexpr int kPerThread = 4;                // consecutive outputs per thread
constexpr int kTile = kThreads * kPerThread; // outputs m per block
constexpr int kWindow = 56;                  // >= kPerThread + kHist, mult. of 4
constexpr int kStage = kTile - kPerThread + kWindow;  // staged samples

static_assert(kWindow % 4 == 0 && kWindow >= kPerThread + kHist,
              "window must cover every tap of every output, in float4s");
static_assert(kStage % 4 == 0, "stage must be a whole number of float4s");

struct PhaseTaps {
    float h[2][kTaps];
};

__global__ void __launch_bounds__(kThreads)
fir_interp2_kernel(const float* __restrict__ ext, long long ext_stride,
                   float* __restrict__ out, long long out_stride,
                   long long n, const PhaseTaps taps)
{
    __shared__ __align__(16) float stage[kStage];

    const long long m0 = static_cast<long long>(blockIdx.x) * kTile;
    const float* x = ext + blockIdx.y * ext_stride + m0;
    const long long avail = n + kHist - m0;  // input samples from m0 on
    for (int i = threadIdx.x; i < kStage; i += kThreads)
        stage[i] = (i < avail) ? x[i] : 0.0f;
    __syncthreads();

    const int t0 = threadIdx.x * kPerThread;
    const float4* s4 = reinterpret_cast<const float4*>(stage + t0);
    float w[kWindow];
#pragma unroll
    for (int q = 0; q < kWindow / 4; ++q) {
        const float4 v = s4[q];
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

    float2* o = reinterpret_cast<float2*>(out + blockIdx.y * out_stride);
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
        const long long m = m0 + t0 + r;
        if (m < n) o[m] = make_float2(acc0[r], acc1[r]);
    }
}

}  // namespace

// ext: float32 [2, ext_stride] with ext_stride >= n + 49 (row-major);
// out: float32 [2, out_stride] with out_stride >= 2n and even;
// taps_host: host float32 [2][50], phase-major, each phase reversed;
// stream: a cudaStream_t.  Returns cudaGetLastError() after the launch.
extern "C" int fir_interp2_launch(const float* ext, long long ext_stride,
                                  float* out, long long out_stride,
                                  long long n, const float* taps_host,
                                  void* stream)
{
    if (n <= 0) return static_cast<int>(cudaSuccess);
    PhaseTaps taps;
    std::memcpy(&taps, taps_host, sizeof(taps));
    const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile), 2);
    fir_interp2_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        ext, ext_stride, out, out_stride, n, taps);
    return static_cast<int>(cudaGetLastError());
}
