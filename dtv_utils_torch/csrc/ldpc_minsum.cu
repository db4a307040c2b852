// One normalized min-sum LDPC iteration for the DVB-T2/S2 IRA codes, as two
// kernels hand-written for Hopper (sm_90a): the check update and the
// variable sum.
//
// Replaces the min-sum lax.scan of dtv_utils_tpu/ops/ldpc_decode.py
// (`one_iter` :90-110, scanned at :112; the final variable sum at :113).
// The plain PyTorch versions are `check_update_reference`,
// `variable_totals_reference` and `minsum_iteration_reference` in
// dtv_utils_torch/ops/ldpc_decode.py, which also describes the tables.
//
// What bounds them on an H100 SXM: bytes.  A min-sum check sends each edge
// one of two magnitudes with a sign, so instead of one float per edge the
// kernels carry a check state of 16 bytes per check and codeword: m1 and
// m2 float32 (the least |v2c| and the least above it, else 1e30) and meta
// int64 (bit j: v2c of slot j < 0; bits 56-61: the slot of a unique
// minimum, else 63).  Slot j's message is rebuilt where it is read:
//   c2v_j = ((popc(neg) ^ bit_j) & 1 ? -0.75 : 0.75) * (j == unique ? m2 : m1)
// which is the reference's product bit for bit.  At BBC (rate 2/3 normal
// frame, 202 FEC blocks: n_par 21,600, 215,999 edges, mean check degree 10)
// the state is 69.8 MB per frame, where one float message per slot of
// checks padded to D = 18 slots would be 314 MB, and the work each kernel
// must move is
//   check:    totals read (52.4 MB) + state read and written (2 x 69.8 MB)
//             + the CSR edge list (0.95 MB)                  ~0.058 ms
//   variable: state read (69.8 MB) + llr read and totals written
//             (2 x 52.4 MB) + the variable table (3.4 MB)    ~0.053 ms
// at 3.35 TB/s.  Each does a few fp32 operations per byte.
//
// Both kernels gather: a check reads its variables' totals, a variable its
// checks' state.  Every tensor is cut into slices of `cols` codewords
// (ops/ldpc_decode.SLICE_COLS), each slice [rows, w] with w = cols but for
// a ragged last slice, so that a warp's read of one row of one slice is one
// aligned 128-byte line (cols = 32, float).  The grid is blockIdx.y = slice,
// and blocks start in order, so the CTAs resident at one time gather from
// one slice: its totals (8.3 MB) and state (11.1 MB) stay in the 50 MB L2,
// and the ~3.3 reads of each total and ~10 reads of each check's state come
// from there, not from HBM.  What is left is the latency of those gathers:
// each kernel keeps a few independent loads in flight per thread (kChunk,
// kVarChunk), fewer than the registers would allow, because more registers
// per thread cost more in resident warps than they gain (measured on the
// card at 1, 2, 3, 4, 8 and 16).
//
// Check update, one thread per (p, b) of the slice, the state in place: for
// each slot j rebuild the old message, v2c = totals[var] - c2v_old (one
// rounding), and in one pass track the minimum m1, the count of slots equal
// to it (and the slot when it is one), the least magnitude above it and the
// sign bits.  Min, counts and bits are exact in any order.
//
// Variable sum, one warp per variable and 32 codewords (cols threads per
// row; lanes past a ragged slice's width idle): the warp's lanes load v's
// (check, slot) pairs at once and a shuffle hands each to all, so the state
// loads wait on one table load only.  totals = llr + (((c_e0 + c_e1) +
// c_e2) + ...), v's edges in ascending edge order, one rounding per add:
// the reference's segment_sum order, so the hard bits equal its own.  No
// atomics.  Each edge gathers its check's whole 16-byte state from the L2,
// four times the bytes of one float message: that traffic, not HBM, holds
// this kernel at about a third of its bound (PERF.md).
//
// __fadd_rn / __fsub_rn / __fmul_rn keep nvcc from contracting a product
// and a sum into an FMA.  chip_smoke.py computes both bounds from the
// shapes it runs and times the kernels beside them.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kScale = 0.75f;        // MINSUM_SCALE
constexpr float kBig = 1e30f;          // the reference's "no second minimum"
constexpr int kSlotShift = 56;         // SLOT_SHIFT: meta's unique-slot field
constexpr unsigned long long kNegMask = (1ULL << kSlotShift) - 1;
constexpr int kNoUnique = 63;          // NO_UNIQUE
constexpr int kMaxDegree = kSlotShift; // MAX_CHECK_DEGREE
constexpr int kPairShift = 6;          // PAIR_SHIFT: check << 6 | slot
constexpr int kSlotMask = (1 << kPairShift) - 1;
constexpr int kChunk = 4;              // check slots' totals loaded together
constexpr int kVarChunk = 2;           // variable edges' state loaded together
constexpr unsigned kFull = 0xffffffffu;

// The sign of slot j's message, times MINSUM_SCALE: negative when the
// parity of the check's sign bits differs from slot j's own.
__device__ __forceinline__ float scale(unsigned long long meta, int j)
{
    return (__popcll(meta & kNegMask) ^ static_cast<int>(meta >> j)) & 1
               ? -kScale : kScale;
}

// Whether slot j holds the check's unique minimum (its message is m2).
__device__ __forceinline__ bool unique_min(unsigned long long meta, int j)
{
    return static_cast<int>(meta >> kSlotShift) == j;
}

__global__ void __launch_bounds__(kThreads)
ldpc_check_kernel(const float* __restrict__ totals, float* __restrict__ m1s,
                  float* __restrict__ m2s,
                  unsigned long long* __restrict__ metas,
                  const int32_t* __restrict__ chk_start,
                  const int32_t* __restrict__ edge_var, int nldpc, int n_par,
                  int batch, int cols)
{
    const int s = blockIdx.y;
    const int w = min(cols, batch - s * cols);
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= n_par * w) return;
    const int p = t / w;
    const int lane = t - p * w;
    const long long own = static_cast<long long>(s) * n_par * cols + t;
    const float* tot =
        totals + static_cast<long long>(s) * nldpc * cols + lane;

    const float o1 = m1s[own], o2 = m2s[own];
    const unsigned long long om = metas[own];
    const int e0 = chk_start[p];
    const int deg = chk_start[p + 1] - e0;
    float m1 = INFINITY, m2 = kBig;
    int n_min = 0, arg = 0;
    unsigned long long neg = 0;
    for (int j0 = 0; j0 < deg; j0 += kChunk) {
        float x[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
            if (j0 + k < deg) x[k] = tot[edge_var[e0 + j0 + k] * w];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            const int j = j0 + k;
            if (j >= deg) break;
            const float c =
                __fmul_rn(scale(om, j), unique_min(om, j) ? o2 : o1);
            const float v2c = __fsub_rn(x[k], c);
            const float mag = fabsf(v2c);
            neg |= static_cast<unsigned long long>(v2c < 0.0f) << j;
            if (mag < m1) {
                m2 = fminf(m2, m1);
                m1 = mag;
                n_min = 1;
                arg = j;
            } else if (mag == m1) {
                ++n_min;
            } else {
                m2 = fminf(m2, mag);
            }
        }
    }
    m1s[own] = m1;
    m2s[own] = m2;
    metas[own] = neg | (static_cast<unsigned long long>(
                            n_min == 1 ? arg : kNoUnique) << kSlotShift);
}

__global__ void __launch_bounds__(kThreads)
ldpc_variable_kernel(const float* __restrict__ llr,
                     const float* __restrict__ m1s,
                     const float* __restrict__ m2s,
                     const unsigned long long* __restrict__ metas,
                     const int32_t* __restrict__ var_pairs, int nldpc,
                     int n_par, int dv, int batch, int cols,
                     float* __restrict__ totals)
{
    const int s = blockIdx.y;
    const int w = min(cols, batch - s * cols);
    const int g = blockIdx.x * kThreads + threadIdx.x;
    const int v = g / cols;
    if (v >= nldpc) return;                  // whole warps: cols % 32 == 0
    const int lane = g - v * cols;
    const bool active = lane < w;            // idle past a ragged slice
    // Lane k of the warp holds v's k-th (check, slot) pair; a shuffle hands
    // each edge to the whole warp.
    const int k32 = threadIdx.x & 31;
    const int mine = k32 < dv ? var_pairs[k32 * nldpc + v] : -1;
    const int deg = __popc(__ballot_sync(kFull, mine >= 0));
    const long long st = static_cast<long long>(s) * n_par * cols + lane;

    float acc = 0.0f;
    for (int d0 = 0; d0 < deg; d0 += kVarChunk) {
        int j[kVarChunk];
        float o1[kVarChunk], o2[kVarChunk];
        unsigned long long meta[kVarChunk];
#pragma unroll
        for (int k = 0; k < kVarChunk; ++k) {
            const int q = __shfl_sync(kFull, mine, (d0 + k) & 31);
            j[k] = q & kSlotMask;
            o1[k] = o2[k] = 0.0f;
            meta[k] = 0;
            if (active && d0 + k < deg) {
                const long long at =
                    st + static_cast<long long>(q >> kPairShift) * w;
                o1[k] = m1s[at];
                o2[k] = m2s[at];
                meta[k] = metas[at];
            }
        }
#pragma unroll
        for (int k = 0; k < kVarChunk; ++k) {
            if (d0 + k >= deg) break;
            const float c = __fmul_rn(scale(meta[k], j[k]),
                                      unique_min(meta[k], j[k]) ? o2[k]
                                                                : o1[k]);
            acc = d0 + k == 0 ? c : __fadd_rn(acc, c);
        }
    }
    if (active) {
        const long long own = static_cast<long long>(s) * nldpc * cols
                              + static_cast<long long>(v) * w + lane;
        totals[own] = __fadd_rn(llr[own], acc);
    }
}

// The grid of a sliced tensor of `rows` rows: x over one slice's threads,
// y over the slices.  Returns false if a size is past what the kernels
// index in int.
bool sliced_grid(long long rows, long long batch, long long cols, dim3* grid)
{
    if (rows <= 0 || cols <= 0 || cols > 1024 || rows * cols > INT_MAX ||
        batch > INT_MAX)
        return false;
    const long long slices = (batch + cols - 1) / cols;
    if (slices > 65535) return false;
    *grid = dim3(
        static_cast<unsigned>((rows * cols + kThreads - 1) / kThreads),
        static_cast<unsigned>(slices));
    return true;
}

}  // namespace

// totals: float32 sliced [nldpc x batch]; m1, m2: float32 and meta: int64,
// each sliced [n_par x batch], updated in place; chk_start: int32
// [n_par + 1]; edge_var: int32 [E]; max_deg: the largest check degree;
// stream: a cudaStream_t on the current device.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue if max_deg exceeds the state's 56
// sign bits or a size is past int range).
extern "C" int ldpc_check_launch(const void* totals, void* m1, void* m2,
                                 void* meta, const void* chk_start,
                                 const void* edge_var, long long nldpc,
                                 long long n_par, long long max_deg,
                                 long long batch, long long cols,
                                 void* stream)
{
    if (batch <= 0) return static_cast<int>(cudaSuccess);
    dim3 grid;
    if (max_deg <= 0 || max_deg > kMaxDegree || nldpc * cols > INT_MAX ||
        !sliced_grid(n_par, batch, cols, &grid))
        return static_cast<int>(cudaErrorInvalidValue);
    ldpc_check_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(totals), static_cast<float*>(m1),
        static_cast<float*>(m2), static_cast<unsigned long long*>(meta),
        static_cast<const int32_t*>(chk_start),
        static_cast<const int32_t*>(edge_var), static_cast<int>(nldpc),
        static_cast<int>(n_par), static_cast<int>(batch),
        static_cast<int>(cols));
    return static_cast<int>(cudaGetLastError());
}

// llr, totals: float32 sliced [nldpc x batch] (totals written); m1, m2,
// meta as above; var_pairs: int32 [dv, nldpc], dv <= 32 (every variable has
// at least one edge); cols a multiple of 32.  Returns cudaGetLastError()
// after the launch.
extern "C" int ldpc_variable_launch(const void* llr, const void* m1,
                                    const void* m2, const void* meta,
                                    const void* var_pairs, long long nldpc,
                                    long long n_par, long long dv,
                                    long long batch, long long cols,
                                    void* totals, void* stream)
{
    if (batch <= 0) return static_cast<int>(cudaSuccess);
    dim3 grid;
    if (dv <= 0 || dv > 32 || cols % 32 != 0 || dv * nldpc > INT_MAX ||
        n_par * cols > INT_MAX || n_par >= (1LL << (31 - kPairShift)) ||
        !sliced_grid(nldpc, batch, cols, &grid))
        return static_cast<int>(cudaErrorInvalidValue);
    ldpc_variable_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(llr), static_cast<const float*>(m1),
        static_cast<const float*>(m2),
        static_cast<const unsigned long long*>(meta),
        static_cast<const int32_t*>(var_pairs), static_cast<int>(nldpc),
        static_cast<int>(n_par), static_cast<int>(dv),
        static_cast<int>(batch), static_cast<int>(cols),
        static_cast<float*>(totals));
    return static_cast<int>(cudaGetLastError());
}
