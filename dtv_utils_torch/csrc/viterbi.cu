// Block-parallel soft Viterbi for the rate-1/2 mother codes: the
// add-compare-select (ACS) recursion and the traceback, hand-written for
// Hopper (sm_90a), for K = 7 (64 states, DVB-T) and K = 5 (16 states, the
// J.83B trellis component).
//
// Replaces the two lax.scans of dtv_utils_tpu/ops/viterbi.py: the ACS scan
// of `_acs_scan` (:127-154, scan at :153) and the reverse scan of
// `_traceback` (:157-174, scan at :173).  The plain PyTorch versions are
// `acs_reference` and `traceback_reference` in dtv_utils_torch/ops/viterbi.py.
//
// ACS.  pairs float32 [L, B, 2] (x, y LLRs per trellis step and block) ->
// decisions [L, B] words of S bits (bit s set when the survivor into state s
// came from a = 1: bit s & 7 of byte s >> 3, the reference's packing read as
// a little-endian uint64 for K = 7, uint16 for K = 5) and the final metrics
// float32 [B, S].  Per step, in the reference's order with one rounding per
// operation (the __f*_rn intrinsics keep nvcc from contracting anything):
//   s = x + y, d = x - y; bm = s, d, -d or -s by the branch's output bits
//   (exact sign flips of one rounded sum); cand = metric[prev] + bm;
//   dec = cand1 > cand0 (strict: ties take branch 0); new = max(cand);
//   metric = new - max over the block's states (a max is exact in any
//   order).
// Design: S/2 lanes per block of the batch, one butterfly per lane (states
// j and j + S/2 share the predecessors 2j and 2j + 1), the metrics in
// registers, one launch for all L steps.  A lane fetches the predecessors'
// metrics with four shuffles, the per-step max is an xor-shuffle tree, and
// the decisions are two __ballot_sync per step.  Lane i of a block keeps
// step t0 + i's word and stores it once per S/2 steps; it also loads that
// step's (x, y) pair, broadcast by shuffle, one batch ahead.  K = 7 runs one
// block per warp, K = 5 four.
//
// Traceback.  decisions + final metrics -> bits uint8 [L, B], bit t the
// encoder input of step t.  One thread per block: the first-index argmax of
// the final metrics (strict >, as argmax), then L steps back,
// bit = state >> (K - 2), prev = ((state & (S/2 - 1)) << 1) | a.  The words
// a step reads do not depend on the state, so each thread loads 32 steps'
// words at once and walks them in registers; words are step-major, so
// neighbouring threads read and write neighbouring addresses.
//
// What bounds them on an H100 SXM.  The DVB-T flagship's 2 superframes
// decode as B = 4217 blocks of L = 4656 steps.  The ACS reads 157 MB of
// pairs and writes 157 MB of decisions (0.094 ms at 3.35 TB/s) and does
// 6S + 1 = 385 fp32 adds, compares and maxes per step and block (7.6 G,
// 0.113 ms at 67 TFLOP/s): operations bound it.  Its steps are serial, so
// what it reaches is set by the latency of one step's chain of ~9 shuffles
// across the 32 warps each SM holds.  The traceback reads the decisions
// once and writes 20 MB of bits (0.053 ms); it is latency-bound, with one
// thread per block.  chip_smoke.py computes both bounds from the shapes it
// runs and times the kernels beside them.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kAcsThreads = 128;
constexpr int kTbThreads = 128;
constexpr int kTbBatch = 32;           // steps whose words a thread holds

template <int K>
using Word = typename std::conditional<K == 7, uint64_t, uint16_t>::type;

// Branch (ns, a): its predecessor is ((ns & (S/2 - 1)) << 1) | a, its input
// bit ns >> (K - 2); the code is 2·(x output bit) + (y output bit).
template <int K>
__device__ __forceinline__ int branch_code(int ns, int a, int g1, int g2)
{
    const int prev = ((ns & ((1 << (K - 2)) - 1)) << 1) | a;
    const int w = ((ns >> (K - 2)) << (K - 1)) | prev;
    return 2 * (__popc(w & g1) & 1) + (__popc(w & g2) & 1);
}

// Code 0: x + y; 1: x - y; 2: -(x - y); 3: -(x + y).
__device__ __forceinline__ float branch_metric(int code, float s, float d)
{
    const float v = ((code ^ (code >> 1)) & 1) ? d : s;
    return (code & 2) ? -v : v;
}

// The S-bit word of block `seg` of the warp from the ballots of its lanes'
// low states (j) and high states (j + S/2).
template <int K>
__device__ __forceinline__ Word<K> pack_word(unsigned lo, unsigned hi,
                                             int seg)
{
    constexpr int H = 1 << (K - 2);
    if constexpr (H == 32) {
        return static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
    } else {
        constexpr unsigned m = (1u << H) - 1;
        return static_cast<Word<K>>(((lo >> (seg * H)) & m) |
                                    (((hi >> (seg * H)) & m) << H));
    }
}

template <int K>
__global__ void __launch_bounds__(kAcsThreads)
viterbi_acs_kernel(const float2* __restrict__ pairs, int L, int B, int g1,
                   int g2, Word<K>* __restrict__ decs,
                   float* __restrict__ final_metrics)
{
    constexpr int S = 1 << (K - 1);
    constexpr int H = S / 2;                 // lanes per block
    constexpr int G = 32 / H;                // blocks per warp
    const int lane = threadIdx.x & 31;
    const int j = lane % H;
    const int seg = lane / H;
    const int warp = (blockIdx.x * kAcsThreads + threadIdx.x) >> 5;
    if (warp * G >= B) return;               // the whole warp is past B
    const int b = warp * G + seg;
    const bool active = b < B;
    const int bl = active ? b : B - 1;       // spare lanes read, never store

    const int c_lo0 = branch_code<K>(j, 0, g1, g2);
    const int c_lo1 = branch_code<K>(j, 1, g1, g2);
    const int c_hi0 = branch_code<K>(j + H, 0, g1, g2);
    const int c_hi1 = branch_code<K>(j + H, 1, g1, g2);
    // metric of state m: lane m % H, register lo if m < H else hi
    const int src0 = (2 * j) % H;
    const int src1 = (2 * j + 1) % H;
    const bool from_lo = j < H / 2;

    float m_lo = 0.0f, m_hi = 0.0f;
    float2 cur = j < L ? pairs[static_cast<size_t>(j) * B + bl]
                       : make_float2(0.0f, 0.0f);
    for (int t0 = 0; t0 < L; t0 += H) {
        const int tn = t0 + H + j;
        const float2 nxt = tn < L ? pairs[static_cast<size_t>(tn) * B + bl]
                                  : make_float2(0.0f, 0.0f);
        const int n = min(H, L - t0);
        Word<K> keep = 0;
        for (int i = 0; i < n; ++i) {
            const float x = __shfl_sync(kFull, cur.x, i, H);
            const float y = __shfl_sync(kFull, cur.y, i, H);
            const float s = __fadd_rn(x, y);
            const float d = __fsub_rn(x, y);
            const float a0l = __shfl_sync(kFull, m_lo, src0, H);
            const float a0h = __shfl_sync(kFull, m_hi, src0, H);
            const float a1l = __shfl_sync(kFull, m_lo, src1, H);
            const float a1h = __shfl_sync(kFull, m_hi, src1, H);
            const float p0 = from_lo ? a0l : a0h;       // metric[2j]
            const float p1 = from_lo ? a1l : a1h;       // metric[2j + 1]
            const float lo0 = __fadd_rn(p0, branch_metric(c_lo0, s, d));
            const float lo1 = __fadd_rn(p1, branch_metric(c_lo1, s, d));
            const float hi0 = __fadd_rn(p0, branch_metric(c_hi0, s, d));
            const float hi1 = __fadd_rn(p1, branch_metric(c_hi1, s, d));
            const bool d_lo = lo1 > lo0;
            const bool d_hi = hi1 > hi0;
            const float n_lo = d_lo ? lo1 : lo0;
            const float n_hi = d_hi ? hi1 : hi0;
            float mx = fmaxf(n_lo, n_hi);
#pragma unroll
            for (int off = H / 2; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off, H));
            m_lo = __fsub_rn(n_lo, mx);
            m_hi = __fsub_rn(n_hi, mx);
            const unsigned b_lo = __ballot_sync(kFull, d_lo);
            const unsigned b_hi = __ballot_sync(kFull, d_hi);
            if (i == j) keep = pack_word<K>(b_lo, b_hi, seg);
        }
        if (active && t0 + j < L)
            decs[static_cast<size_t>(t0 + j) * B + b] = keep;
        cur = nxt;
    }
    if (active) {
        final_metrics[static_cast<size_t>(b) * S + j] = m_lo;
        final_metrics[static_cast<size_t>(b) * S + j + H] = m_hi;
    }
}

template <int K>
__global__ void __launch_bounds__(kTbThreads)
viterbi_traceback_kernel(const Word<K>* __restrict__ decs,
                         const float* __restrict__ final_metrics, int L,
                         int B, uint8_t* __restrict__ bits)
{
    constexpr int S = 1 << (K - 1);
    constexpr int H = S / 2;
    const int b = blockIdx.x * kTbThreads + threadIdx.x;
    if (b >= B) return;
    const float* f = final_metrics + static_cast<size_t>(b) * S;
    float best = f[0];
    int st = 0;
    for (int s = 1; s < S; ++s) {
        if (f[s] > best) {
            best = f[s];
            st = s;
        }
    }
    for (int t = L - 1; t >= 0; t -= kTbBatch) {
        Word<K> w[kTbBatch];
#pragma unroll
        for (int i = 0; i < kTbBatch; ++i)
            w[i] = t - i >= 0 ? decs[static_cast<size_t>(t - i) * B + b]
                              : Word<K>(0);
#pragma unroll
        for (int i = 0; i < kTbBatch; ++i) {
            if (t - i < 0) break;
            bits[static_cast<size_t>(t - i) * B + b] =
                static_cast<uint8_t>(st >> (K - 2));
            st = ((st & (H - 1)) << 1) | static_cast<int>((w[i] >> st) & 1);
        }
    }
}

template <int K>
int acs_launch(const void* pairs, int L, int B, int g1, int g2, void* decs,
               void* final_metrics, cudaStream_t stream)
{
    constexpr int G = 32 / (1 << (K - 2));
    const long long warps = (static_cast<long long>(B) + G - 1) / G;
    const long long ctas = (warps * 32 + kAcsThreads - 1) / kAcsThreads;
    viterbi_acs_kernel<K><<<static_cast<unsigned>(ctas), kAcsThreads, 0,
                            stream>>>(
        static_cast<const float2*>(pairs), L, B, g1, g2,
        static_cast<Word<K>*>(decs), static_cast<float*>(final_metrics));
    return static_cast<int>(cudaGetLastError());
}

template <int K>
int traceback_launch(const void* decs, const void* final_metrics, int L,
                     int B, void* bits, cudaStream_t stream)
{
    const unsigned ctas = (B + kTbThreads - 1) / kTbThreads;
    viterbi_traceback_kernel<K><<<ctas, kTbThreads, 0, stream>>>(
        static_cast<const Word<K>*>(decs),
        static_cast<const float*>(final_metrics), L, B,
        static_cast<uint8_t*>(bits));
    return static_cast<int>(cudaGetLastError());
}

// Thread and warp indices stay in int range.
bool bad_sizes(long long L, long long B)
{
    return L > INT_MAX || B > (1LL << 26);
}

}  // namespace

// pairs: float32 [L, B, 2], contiguous, 8-byte aligned; decs: [L, B] words
// of 2^(k-1) bits (uint64 for k = 7, uint16 for k = 5), contiguous;
// final_metrics: float32 [B, 2^(k-1)]; g1, g2: the generator polynomials;
// stream: a cudaStream_t on the current device.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// k, B > 2^26 or L past int range).
extern "C" int viterbi_acs_launch(int k, const void* pairs, long long L,
                                  long long B, int g1, int g2, void* decs,
                                  void* final_metrics, void* stream)
{
    if (L <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
    if (bad_sizes(L, B)) return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(pairs) & 7)
        return static_cast<int>(cudaErrorMisalignedAddress);
    const auto s = static_cast<cudaStream_t>(stream);
    const int l = static_cast<int>(L), b = static_cast<int>(B);
    switch (k) {
    case 5: return acs_launch<5>(pairs, l, b, g1, g2, decs, final_metrics, s);
    case 7: return acs_launch<7>(pairs, l, b, g1, g2, decs, final_metrics, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// decs and final_metrics as viterbi_acs_launch writes them; bits: uint8
// [L, B].  Returns cudaGetLastError() after the launch.
extern "C" int viterbi_traceback_launch(int k, const void* decs,
                                        const void* final_metrics,
                                        long long L, long long B, void* bits,
                                        void* stream)
{
    if (L <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
    if (bad_sizes(L, B)) return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    const int l = static_cast<int>(L), b = static_cast<int>(B);
    switch (k) {
    case 5: return traceback_launch<5>(decs, final_metrics, l, b, bits, s);
    case 7: return traceback_launch<7>(decs, final_metrics, l, b, bits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
