// One normalized min-sum LDPC iteration for the DVB-T2/S2 IRA codes, as two
// kernels hand-written for Hopper (sm_90a): the check update and the
// variable sum.
//
// Replaces the min-sum lax.scan of dtv_utils_tpu/ops/ldpc_decode.py
// (`one_iter` :90-110, scanned at :112; the final variable sum at :113).
// The plain PyTorch versions are `check_update_reference`,
// `variable_totals_reference` and `minsum_iteration_reference` in
// dtv_utils_torch/ops/ldpc_decode.py.
//
// Layout (ops/ldpc_decode._padded): check-to-variable messages c2v float32
// [n_par, D, batch], check-major with D the largest check degree, batch
// innermost; slot s = p·D + j of check p reads variable slot_var[s] (nldpc,
// a row of +inf, for padding).  totals float32 [nldpc + 1, batch], the last
// row +inf.  var_slots int32 [Dv, nldpc]: variable v's edge slots in
// ascending edge order, -1 past its degree.  A thread owns one (check,
// codeword) or one (variable, codeword); threads run over the batch first,
// so a warp's loads of one slot are consecutive addresses.
//
// Check update, one thread per (p, b), in place: for each slot
// v2c = totals[var] - c2v (one rounding), mag = |v2c|; in one pass the
// minimum m1, the exact count n_min of slots equal to it, the second
// minimum m2 = min(1e30, the least mag above m1) (the reference's
// min(where(is_min, 1e30, mag))) and the parity of the negative signs; then
// c2v = (±0.75) · (mag <= m1 and n_min == 1 ? m2 : m1), the sign negative
// when the parity differs from the slot's own.  v2c waits in shared memory
// between the two passes.  Min, counts and parity are exact in any order.
//
// Variable sum, one thread per (v, b): totals = llr + (((c_e0 + c_e1) +
// c_e2) + ...), v's edges in ascending edge order, one rounding per add:
// the reference's segment_sum order, so the hard bits equal its own.  No
// atomics.
//
// __fadd_rn / __fsub_rn / __fmul_rn keep nvcc from contracting a product
// and a sum into an FMA.
//
// What bounds them on an H100 SXM: bytes.  At BBC (rate 2/3 normal frame,
// 202 FEC blocks: n_par 21,600, D 18, 216k edges) min-sum needs the check
// update to read and write the 216k edges' messages (175 MB each way) and
// read totals (52 MB), ~0.12 ms at 3.35 TB/s; the variable sum reads the
// messages and llr (52 MB) and writes totals (52 MB), ~0.08 ms.  Each does
// a few fp32 operations per byte.  The check kernel moves the padded table
// (314 MB each way): the padding is its own overhead, not part of the
// bound.  chip_smoke.py computes both bounds from the shapes it runs and
// times the kernels beside them.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kScale = 0.75f;        // MINSUM_SCALE
constexpr float kBig = 1e30f;          // the reference's "no second minimum"
constexpr int kMaxSmem = 48 * 1024;    // no opt-in needed below this

__global__ void __launch_bounds__(kThreads)
ldpc_check_kernel(const float* __restrict__ totals, float* __restrict__ c2v,
                  const int64_t* __restrict__ slot_var, int n_par, int D,
                  int batch)
{
    extern __shared__ float v2c_smem[];          // [D][kThreads]
    const long long tid =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (tid >= static_cast<long long>(n_par) * batch) return;
    const long long p = tid / batch;
    const int b = static_cast<int>(tid - p * batch);
    float* mine = v2c_smem + threadIdx.x;
    float m1 = INFINITY, m2 = kBig;
    int n_min = 0, odd = 0;
    for (int j = 0; j < D; ++j) {
        const long long s = p * D + j;
        const float x = __fsub_rn(totals[slot_var[s] * batch + b],
                                  c2v[s * batch + b]);
        mine[j * kThreads] = x;
        const float mag = fabsf(x);
        odd ^= x < 0.0f;
        if (mag < m1) {
            m2 = fminf(m2, m1);
            m1 = mag;
            n_min = 1;
        } else if (mag == m1) {
            ++n_min;
        } else {
            m2 = fminf(m2, mag);
        }
    }
    for (int j = 0; j < D; ++j) {
        const float x = mine[j * kThreads];
        const float mag = fabsf(x);
        const float other = (mag <= m1 && n_min == 1) ? m2 : m1;
        const float sign = (odd ^ (x < 0.0f)) ? -kScale : kScale;
        c2v[(p * D + j) * batch + b] = __fmul_rn(sign, other);
    }
}

__global__ void __launch_bounds__(kThreads)
ldpc_variable_kernel(const float* __restrict__ llr_t,
                     const float* __restrict__ c2v,
                     const int32_t* __restrict__ var_slots, int nldpc, int Dv,
                     int batch, float* __restrict__ totals)
{
    const long long tid =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (tid >= static_cast<long long>(nldpc) * batch) return;
    const int v = static_cast<int>(tid / batch);
    const int b = static_cast<int>(tid - static_cast<long long>(v) * batch);
    float acc = c2v[static_cast<long long>(var_slots[v]) * batch + b];
    for (int d = 1; d < Dv; ++d) {
        const int s = var_slots[static_cast<long long>(d) * nldpc + v];
        if (s < 0) break;                        // past v's degree
        acc = __fadd_rn(acc, c2v[static_cast<long long>(s) * batch + b]);
    }
    totals[tid] = __fadd_rn(llr_t[tid], acc);
}

unsigned ctas_for(long long threads)
{
    return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// totals: float32 [>= max(slot_var) + 1, batch]; c2v: float32 [n_par, D,
// batch], updated in place; slot_var: int64 [n_par · D]; stream: a
// cudaStream_t on the current device.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue if D needs more than 48 KB of shared memory
// or a size is past int range).
extern "C" int ldpc_check_launch(const void* totals, void* c2v,
                                 const void* slot_var, long long n_par,
                                 long long D, long long batch, void* stream)
{
    if (n_par <= 0 || batch <= 0) return static_cast<int>(cudaSuccess);
    const long long smem = D * kThreads * static_cast<long long>(sizeof(float));
    if (D <= 0 || smem > kMaxSmem || n_par > INT_MAX || batch > INT_MAX ||
        n_par * batch > (1LL << 38))
        return static_cast<int>(cudaErrorInvalidValue);
    ldpc_check_kernel<<<ctas_for(n_par * batch), kThreads,
                        static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(totals), static_cast<float*>(c2v),
        static_cast<const int64_t*>(slot_var), static_cast<int>(n_par),
        static_cast<int>(D), static_cast<int>(batch));
    return static_cast<int>(cudaGetLastError());
}

// llr_t: float32 [nldpc, batch]; c2v as above; var_slots: int32 [Dv, nldpc]
// (every variable has at least one edge); totals: float32 [>= nldpc, batch],
// rows 0 .. nldpc - 1 written.  Returns cudaGetLastError() after the launch.
extern "C" int ldpc_variable_launch(const void* llr_t, const void* c2v,
                                    const void* var_slots, long long nldpc,
                                    long long Dv, long long batch,
                                    void* totals, void* stream)
{
    if (nldpc <= 0 || batch <= 0) return static_cast<int>(cudaSuccess);
    if (Dv <= 0 || nldpc > INT_MAX || Dv > INT_MAX || batch > INT_MAX ||
        nldpc * batch > (1LL << 38))
        return static_cast<int>(cudaErrorInvalidValue);
    ldpc_variable_kernel<<<ctas_for(nldpc * batch), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(llr_t), static_cast<const float*>(c2v),
        static_cast<const int32_t*>(var_slots), static_cast<int>(nldpc),
        static_cast<int>(Dv), static_cast<int>(batch),
        static_cast<float*>(totals));
    return static_cast<int>(cudaGetLastError());
}
