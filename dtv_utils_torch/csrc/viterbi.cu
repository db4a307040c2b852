// Block-parallel soft Viterbi for the rate-1/2 mother codes: the
// add-compare-select (ACS) recursion and the traceback, hand-written for
// Hopper (sm_90a), for the DVB-T code (K = 7, 64 states, generators 171,
// 133 octal) and the J.83B trellis component (K = 5, 16 states, 25, 37).
//
// Replaces the two lax.scans of dtv_utils_tpu/ops/viterbi.py: the ACS scan
// of `_acs_scan` (:127-154, scan at :153) and the reverse scan of
// `_traceback` (:157-174, scan at :173).  The plain PyTorch versions are
// `acs_reference` and `traceback_reference` in dtv_utils_torch/ops/viterbi.py.
//
// ACS.  pairs float32 [L, B, 2] (x, y LLRs per trellis step and block) ->
// decisions uint8 [L, B, S/8] (bit s & 7 of byte s >> 3 set when the
// survivor into state s came from a = 1, the reference's packing) and the
// final metrics float32 [B, S].  Per step, in the reference's order with
// one rounding per operation (the __f*_rn intrinsics keep nvcc from
// contracting anything):
//   s = x + y, d = x - y; bm = s, d, -d or -s by the branch's output bits
//   (exact sign flips of one rounded sum); cand = metric[prev] + bm;
//   dec = cand1 > cand0 (strict: ties take branch 0); new = dec ? cand1 :
//   cand0; metric = new - max over the block's states (a max is exact in
//   any order).
// Design: a block of the batch runs on LANES lanes of a warp (a template
// parameter; 32 / LANES blocks share a warp), lane l holding the metrics of
// the SPL = S / LANES consecutive states [SPL·l, SPL·l + SPL) in registers.
// The predecessors of those states, 2·(ns mod S/2) + a, are the 2·SPL
// consecutive states held by lanes 2l and 2l + 1 (mod LANES): a step
// begins with shuffles of uniform register index (of its own registers at
// LANES = 1), or (SMEM) a float4 exchange through shared memory.  The
// metrics travel before the step's normalisation and the receiver
// subtracts the max, so the exchange overlaps the max's reduction.  The
// codes are linear over GF(2) in the state's bits, so a lane's branch
// metrics are ±A or ±B with the sign fixed at compile time, where A and B
// are two of {s, d, -d, -s} picked once per lane; the add takes the sign
// as an operand modifier.  The max is a local tree, then across the
// block's lanes through shared memory.  A lane's SPL
// decisions are bits [SPL·l, SPL·l + SPL) of the step's word, stored as
// they are (or merged across 8 / SPL lanes by shuffles when SPL < 8), so
// each warp writes its blocks' words as one contiguous run per step.  Each
// lane loads its block's pair itself, PREFETCH steps ahead.  One launch
// for all L steps.  As shipped (tools/viterbi_limits.py's sweep on an
// H100): 8 lanes per block at both K (8 states a lane at K = 7, 2 at
// K = 5), so 4 blocks per warp, and one warp per CTA.
//
// Traceback.  decisions + final metrics -> bits uint8 [L, B], bit t the
// encoder input of step t.  One thread per block: the first-index argmax of
// the final metrics (strict >, as argmax), then L steps back,
// bit = state >> (K - 2), prev = ((state & (S/2 - 1)) << 1) | a.  The words
// a step reads do not depend on the state, so each thread copies its
// block's words with cp.async into a ring of NB batches of TB steps in
// shared memory, NB - 1 batches ahead of the walk, and reads each batch
// back into registers when it gets there: the walk no longer waits a
// memory round trip per batch.  Only the thread that copied a word reads
// it, so cp.async.wait_group alone orders them.  CTAs of one or two warps
// spread the B threads over the SMs.  The decisions must be aligned to
// their word (8 bytes at K = 7, 2 at K = 5; else the launch returns
// cudaErrorMisalignedAddress): a K = 5 word is the half of its 4-byte
// slot that bit 1 of its address names.
//
// What bounds them on an H100 SXM.  The DVB-T flagship's 2 superframes
// decode as B = 4218 blocks of L = 4656 steps.  The ACS reads 157 MB of
// pairs and writes 157 MB of decisions (0.094 ms at 3.35 TB/s) and does
// 6S + 1 = 385 fp32 adds, compares, selects, maxes and subtracts per step
// and block (7.6 G: 0.226 ms at the fp32 instruction rate, 128 per SM and
// clock): operations bound it.  Its steps are serial, so what it reaches is
// set by the instructions each block-step issues at 8 warps per SM, about
// 12 per state with the exchange, the decision bits and the max; moving
// the metrics once every three steps in place of every step (the tool's
// in-place variant) does not make it faster.  The traceback reads the
// decisions once and writes 20 MB of bits (0.053 ms); each thread's walk
// is a serial chain of integer operations per step, and with one warp per
// SM that chain, not the memory, sets its time.  chip_smoke.py computes
// both bounds from the shapes it runs and times the kernels beside them.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// The ACS's launch and schedule, by K: threads per CTA, lanes per block,
// steps of pairs loaded ahead, and the predecessors' metrics through
// shared memory (1) or by shuffles (0).  tools/viterbi_limits.py sweeps
// them on the card.
constexpr int ACS_THREADS_K7 = 32, ACS_THREADS_K5 = 32;
constexpr int ACS_LANES_K7 = 8, ACS_LANES_K5 = 8;
constexpr int ACS_PREFETCH_K7 = 16, ACS_PREFETCH_K5 = 16;
constexpr int ACS_SMEM_K7 = 1, ACS_SMEM_K5 = 0;
// The traceback's, by K: threads per CTA, steps per ring batch, batches
// in the ring (the ring's static shared memory stays within 48 KB).
constexpr int TB_THREADS_K7 = 32, TB_THREADS_K5 = 64;
constexpr int TB_BATCH_K7 = 32, TB_BATCH_K5 = 64;
constexpr int TB_BATCHES_K7 = 6, TB_BATCHES_K5 = 3;

// The generator polynomials the kernels are built for, by K.
constexpr int kG1K7 = 0171, kG2K7 = 0133, kG1K5 = 025, kG2K5 = 037;

template <int K>
using Word = typename std::conditional<K == 7, uint64_t, uint16_t>::type;

template <int N>
using Bits = typename std::conditional<
    N <= 8, uint8_t,
    typename std::conditional<
        N <= 16, uint16_t,
        typename std::conditional<N <= 32, uint32_t, uint64_t>::type>::
        type>::type;

__host__ __device__ constexpr int parity(int v)
{
    return v ? (v & 1) ^ parity(v >> 1) : 0;
}

// Branch (ns, a): its predecessor is ((ns & (S/2 - 1)) << 1) | a, its input
// bit ns >> (K - 2); the code is 2·(x output bit) + (y output bit), and
// its metric [s, d, -d, -s][code].  Linear over GF(2) in (ns, a).
template <int K, int G1, int G2>
__host__ __device__ constexpr int branch_code(int ns, int a)
{
    return 2 * parity((((ns >> (K - 2)) << (K - 1)) |
                       ((ns & ((1 << (K - 2)) - 1)) << 1) | a) & G1) +
           parity((((ns >> (K - 2)) << (K - 1)) |
                   ((ns & ((1 << (K - 2)) - 1)) << 1) | a) & G2);
}

// [s, d, -d, -s][c ^ lane_code] from A = [s, d, -d, -s][lane_code] and
// Bm = [s, d, -d, -s][lane_code ^ 1]: c ^ 3 negates, c ^ 1 swaps s and d.
// c is a compile-time constant once the caller's loop is unrolled.
__device__ __forceinline__ float lane_metric(int c, float A, float Bm)
{
    switch (c) {
    case 0: return A;
    case 1: return Bm;
    case 2: return -Bm;
    default: return -A;
    }
}

template <int K, int G1, int G2, int THREADS, int LANES, int U, bool SMEM>
__global__ void __launch_bounds__(THREADS)
viterbi_acs_kernel(const float2* __restrict__ pairs, int L, int B,
                   uint8_t* __restrict__ decs,
                   float* __restrict__ final_metrics)
{
    constexpr int S = 1 << (K - 1);
    constexpr int SPL = S / LANES;           // states per lane
    constexpr int P = 2 * SPL < S ? 2 * SPL : S;  // predecessors a lane reads
    constexpr int G = 32 / LANES;            // blocks per warp
    constexpr int NBYTES = S / 8;            // bytes per decision word
    constexpr int MERGE = SPL < 8 ? 8 / SPL : 1;  // lanes per stored byte
    // the shared-memory exchange moves float4s: lanes of >= 4 states
    constexpr bool kSmem = SMEM && LANES > 1 && SPL >= 4;
    constexpr int Q = SPL / 4;               // float4s per lane
    using Chunk = Bits<SPL>;
    static_assert(LANES >= 1 && LANES <= 32 && S % LANES == 0, "lanes");
    // two buffers, by step parity: [warp][block][float4 q][lane]
    __shared__ float4 xbuf[kSmem ? 2 : 1][THREADS / 32]
                          [kSmem ? G * Q * LANES : 1];
    // the lanes' own maxes, by step parity: [warp][lane]
    __shared__ __align__(16) float mbuf[2][THREADS / 32][32];

    const int lane = threadIdx.x & 31;
    const int l = lane % LANES;
    const int seg = lane / LANES;
    const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
    if (warp * G >= B) return;               // the whole warp is past B
    const int b = warp * G + seg;
    const bool active = b < B;
    const int bl = active ? b : B - 1;       // spare lanes read, never store

    const int src0 = (2 * l) % LANES;
    const int src1 = (2 * l + 1) % LANES;
    // this lane's states are SPL·l | i: their codes are branch_code(i, a)
    // ^ lane_code, so their metrics are ±A or ±Bm
    const int lane_code = branch_code<K, G1, G2>(SPL * l, 0);
    const bool swap_sd = ((lane_code ^ (lane_code >> 1)) & 1) != 0;
    const float sign = (lane_code & 2) ? -1.0f : 1.0f;
    uint8_t* out = decs + static_cast<size_t>(bl) * NBYTES +
                   (SPL >= 8 ? SPL / 8 * l : l / MERGE);
    const bool stores = active && l % MERGE == 0;
    const size_t step_bytes = static_cast<size_t>(B) * NBYTES;

    // m: this lane's metrics before the step's normalisation, mx: the
    // block's max of them.  The metrics travel unnormalised, so the
    // exchange overlaps the max's reduction, and each lane subtracts mx
    // from what it receives: the same operation on the same operands as
    // the reference's subtraction.
    float m[SPL], mx = 0.0f;
#pragma unroll
    for (int i = 0; i < SPL; ++i) m[i] = 0.0f;

    auto step = [&](float2 xy, int t) {
        const float s = __fadd_rn(xy.x, xy.y);
        const float d = __fsub_rn(xy.x, xy.y);
        const float A = __fmul_rn(swap_sd ? d : s, sign);
        const float Bm = __fmul_rn(swap_sd ? s : d, sign);
        float p[P];
        if constexpr (kSmem) {
            float4* x = &xbuf[t & 1][threadIdx.x >> 5][seg * Q * LANES];
#pragma unroll
            for (int q = 0; q < Q; ++q)
                x[q * LANES + l] = make_float4(m[4 * q], m[4 * q + 1],
                                               m[4 * q + 2], m[4 * q + 3]);
            __syncwarp();
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const float4 u = x[q * LANES + src0];
                const float4 v = x[q * LANES + src1];
                p[4 * q] = u.x, p[4 * q + 1] = u.y;
                p[4 * q + 2] = u.z, p[4 * q + 3] = u.w;
                p[SPL + 4 * q] = v.x, p[SPL + 4 * q + 1] = v.y;
                p[SPL + 4 * q + 2] = v.z, p[SPL + 4 * q + 3] = v.w;
            }
        } else {
#pragma unroll
            for (int i = 0; i < P; ++i)
                p[i] = __shfl_sync(kFull, m[i % SPL], i < SPL ? src0 : src1,
                                   LANES);
        }
#pragma unroll
        for (int i = 0; i < P; ++i) p[i] = __fsub_rn(p[i], mx);
        Chunk chunk = 0;
#pragma unroll
        for (int i = 0; i < SPL; ++i) {
            const float c0 = __fadd_rn(
                p[(2 * i) % P],
                lane_metric(branch_code<K, G1, G2>(i, 0), A, Bm));
            const float c1 = __fadd_rn(
                p[(2 * i + 1) % P],
                lane_metric(branch_code<K, G1, G2>(i, 1), A, Bm));
            const bool dec = c1 > c0;
            m[i] = dec ? c1 : c0;
            chunk |= static_cast<Chunk>(dec) << i;
        }
        mx = m[0];
#pragma unroll
        for (int i = 1; i < SPL; ++i) mx = fmaxf(mx, m[i]);
        float* own = &mbuf[t & 1][threadIdx.x >> 5][0];
        own[lane] = mx;
        __syncwarp();
        const float* blk = own + seg * LANES;
        if constexpr (LANES % 4 == 0) {
#pragma unroll
            for (int q = 0; q < LANES / 4; ++q) {
                const float4 v = reinterpret_cast<const float4*>(blk)[q];
                mx = fmaxf(mx, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
            }
        } else {
#pragma unroll
            for (int r = 0; r < LANES; ++r) mx = fmaxf(mx, blk[r]);
        }
        if constexpr (MERGE > 1) {
            unsigned v = chunk;
#pragma unroll
            for (int off = 1; off < MERGE; off <<= 1)
                v |= __shfl_down_sync(kFull, v, off, LANES) << (SPL * off);
            chunk = static_cast<Chunk>(v);
        }
        if (stores)
            *reinterpret_cast<Chunk*>(out + static_cast<size_t>(t) *
                                                step_bytes) = chunk;
    };
    auto load = [&](int t) {
        return t < L ? pairs[static_cast<size_t>(t) * B + bl]
                     : make_float2(0.0f, 0.0f);
    };

    // whole batches of U steps, the next batch's pairs in flight, then
    // the last L mod U steps
    float2 cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = load(u);
    int t0 = 0;
    for (; t0 + U <= L; t0 += U) {
        float2 nxt[U];
#pragma unroll
        for (int u = 0; u < U; ++u) nxt[u] = load(t0 + U + u);
#pragma unroll
        for (int u = 0; u < U; ++u) step(cur[u], t0 + u);
#pragma unroll
        for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < U - 1; ++u)
        if (t0 + u < L) step(cur[u], t0 + u);
    if (active) {
#pragma unroll
        for (int i = 0; i < SPL; ++i)
            final_metrics[static_cast<size_t>(b) * S + SPL * l + i] =
                __fsub_rn(m[i], mx);
    }
}

// cp.async of BYTES from gmem into smem; with on false nothing is read and
// the slot is zero-filled.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem,
                                           bool on)
{
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES), "r"(on ? BYTES : 0)
                 : "memory");
}

__device__ __forceinline__ void commit_async()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_async()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What a ring slot holds: the K = 7 word itself; for K = 5 the aligned
// 4 bytes that hold the 2-byte word (cp.async copies 4, 8 or 16 bytes),
// which never reach past the tensor's aligned ends.
template <int K>
using Slot = typename std::conditional<K == 7, uint64_t, uint32_t>::type;

template <int K, int THREADS, int TB, int NB>
__global__ void __launch_bounds__(THREADS)
viterbi_traceback_kernel(const uint8_t* __restrict__ decs,
                         const float* __restrict__ final_metrics, int L,
                         int B, uint8_t* __restrict__ bits)
{
    constexpr int S = 1 << (K - 1);
    constexpr int H = S / 2;
    constexpr int W = sizeof(Word<K>);
    __shared__ Slot<K> ring[NB][TB][THREADS];
    const int b = blockIdx.x * THREADS + threadIdx.x;
    if (b >= B) return;
    const int nbatches = (L + TB - 1) / TB;
    // bit 1 of the address of word (t, b) is that of t·B + b + odd_at
    const unsigned odd_at =
        static_cast<unsigned>(reinterpret_cast<uintptr_t>(decs) >> 1) + b;

    // batch n holds steps L - 1 - n·TB - i, i < TB, in slot n % NB; the
    // batches are issued in order, g at the next word to copy
    const size_t back = static_cast<size_t>(B) * W;
    const uint8_t* g = decs + (static_cast<size_t>(L - 1) * B + b) * W;
    int t_next = L - 1;
    auto slot_of = [](const uint8_t* word) {
        return reinterpret_cast<const uint8_t*>(
            reinterpret_cast<uintptr_t>(word) & ~(sizeof(Slot<K>) - 1));
    };
    auto issue = [&](int n) {
        if (n < nbatches) {
            Slot<K>* dst = &ring[n % NB][0][threadIdx.x];
            if (t_next >= TB - 1) {
#pragma unroll
                for (int i = 0; i < TB; ++i, g -= back)
                    copy_async<sizeof(Slot<K>)>(dst + i * THREADS,
                                                slot_of(g), true);
            } else {                         // the last batch: steps < 0
#pragma unroll
                for (int i = 0; i < TB; ++i) {
                    const bool on = t_next - i >= 0;
                    copy_async<sizeof(Slot<K>)>(dst + i * THREADS,
                                                on ? slot_of(g) : decs, on);
                    if (t_next - i > 0) g -= back;
                }
            }
            t_next -= TB;
        }
        commit_async();                      // an empty group past the end
    };
#pragma unroll
    for (int n = 0; n < NB - 1; ++n) issue(n);

    const float* f = final_metrics + static_cast<size_t>(b) * S;
    float best = f[0];
    int st = 0;
    for (int s = 1; s < S; ++s) {
        if (f[s] > best) {
            best = f[s];
            st = s;
        }
    }
    // one step back from t: emit its bit, take the survivor's branch
    uint8_t* out = bits + static_cast<size_t>(L) * B + b;
    auto walk = [&](Slot<K> slot, int t) {
        out -= B;
        *out = static_cast<uint8_t>(st >> (K - 2));
        unsigned a;
        if constexpr (K == 7) {
            const unsigned half = (st & 32)
                ? static_cast<unsigned>(slot >> 32)
                : static_cast<unsigned>(slot);
            a = (half >> (st & 31)) & 1u;
        } else {
            // the word is the slot's high half where its address is 2
            // mod 4
            const unsigned odd = (static_cast<unsigned>(t) * B + odd_at) & 1u;
            a = (slot >> (odd * 16 + st)) & 1u;
        }
        st = ((st & (H - 1)) << 1) | static_cast<int>(a);
    };
    for (int n = 0; n < nbatches; ++n) {
        issue(n + NB - 1);
        wait_async<NB - 1>();                // batch n has landed
        const Slot<K>* w = &ring[n % NB][0][threadIdx.x];
        const int t_hi = L - 1 - n * TB;
        if (t_hi >= TB - 1) {                // a whole batch
            Slot<K> v[TB];
#pragma unroll
            for (int i = 0; i < TB; ++i) v[i] = w[i * THREADS];
#pragma unroll
            for (int i = 0; i < TB; ++i) walk(v[i], t_hi - i);
        } else {
            for (int i = 0; i <= t_hi; ++i) walk(w[i * THREADS], t_hi - i);
        }
    }
}

template <int K, int G1, int G2, int THREADS, int LANES, int U, bool SMEM>
int acs_launch(const void* pairs, int L, int B, void* decs,
               void* final_metrics, cudaStream_t stream)
{
    // a lane stores its decisions as one Bits<SPL>
    if (reinterpret_cast<uintptr_t>(decs) &
        (sizeof(Bits<(1 << (K - 1)) / LANES>) - 1))
        return static_cast<int>(cudaErrorMisalignedAddress);
    constexpr int G = 32 / LANES;
    const long long warps = (static_cast<long long>(B) + G - 1) / G;
    const long long ctas = (warps * 32 + THREADS - 1) / THREADS;
    viterbi_acs_kernel<K, G1, G2, THREADS, LANES, U, SMEM>
        <<<static_cast<unsigned>(ctas), THREADS, 0, stream>>>(
            static_cast<const float2*>(pairs), L, B,
            static_cast<uint8_t*>(decs), static_cast<float*>(final_metrics));
    return static_cast<int>(cudaGetLastError());
}

template <int K, int THREADS, int TB, int NB>
int traceback_launch(const void* decs, const void* final_metrics, int L,
                     int B, void* bits, cudaStream_t stream)
{
    if (reinterpret_cast<uintptr_t>(decs) & (sizeof(Word<K>) - 1))
        return static_cast<int>(cudaErrorMisalignedAddress);
    const unsigned ctas = (B + THREADS - 1) / THREADS;
    viterbi_traceback_kernel<K, THREADS, TB, NB><<<ctas, THREADS, 0,
                                                    stream>>>(
        static_cast<const uint8_t*>(decs),
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

// pairs: float32 [L, B, 2], contiguous, 8-byte aligned; decs: uint8
// [L, B, 2^(k-4)], contiguous; final_metrics: float32 [B, 2^(k-1)]; (k, g1,
// g2): (7, 0171, 0133) or (5, 025, 037); stream: a cudaStream_t on the
// current device.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another code, B > 2^26 or L past int range;
// cudaErrorMisalignedAddress for pairs or decs off their alignment).
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
    if (k == 7 && g1 == kG1K7 && g2 == kG2K7)
        return acs_launch<7, kG1K7, kG2K7, ACS_THREADS_K7, ACS_LANES_K7,
                          ACS_PREFETCH_K7, ACS_SMEM_K7 != 0>(
            pairs, l, b, decs, final_metrics, s);
    if (k == 5 && g1 == kG1K5 && g2 == kG2K5)
        return acs_launch<5, kG1K5, kG2K5, ACS_THREADS_K5, ACS_LANES_K5,
                          ACS_PREFETCH_K5, ACS_SMEM_K5 != 0>(
            pairs, l, b, decs, final_metrics, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// decs and final_metrics as viterbi_acs_launch writes them (decs aligned
// to its 2^(k-4)-byte word); bits: uint8 [L, B].  Returns
// cudaGetLastError() after the launch (cudaErrorMisalignedAddress for
// decs off its word's alignment).
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
    case 5:
        return traceback_launch<5, TB_THREADS_K5, TB_BATCH_K5, TB_BATCHES_K5>(
            decs, final_metrics, l, b, bits, s);
    case 7:
        return traceback_launch<7, TB_THREADS_K7, TB_BATCH_K7, TB_BATCHES_K7>(
            decs, final_metrics, l, b, bits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
