// Reed-Solomon decoder for the receivers' outer codes, one kernel
// hand-written for Hopper (sm_90a): syndromes, Berlekamp-Massey, Chien
// search and Forney for each codeword, with no intermediate in device
// memory.
//
// It replaces no TPU kernel: the JAX package decodes RS with XLA ops
// (dtv_utils_tpu/ops/rs_decode.py, `RsDecoder.decode_words`).  It was
// added because the port's plain PyTorch decode of a batch (`decode_reference`
// in dtv_utils_torch/ops/rs_decode.py, the plain version) is 773 small
// launches per DVB-T receive call: a GF(2) syndrome product, 2t unrolled
// Berlekamp-Massey iterations of a dozen ops each, dense [batch, n, .] Chien
// and Forney lookups.  Their device time was small; launching them held the
// host for most of the call.
//
// Generic over the code: GF(2^m) with m <= 8, n <= 2^m - 1 symbols, nroots
// <= 16 consecutive roots alpha^(first_root + j), all given at run time, so
// DVB-T's shortened RS(204,188) over GF(256) (t = 8) and J.83B's (127,122)
// over GF(128) (t = 2) take the same kernel.  The arithmetic is the plain
// version's, step for step, so the corrected words, the error counts and
// `ok` equal it on every input, words with more than t errors included:
//   * GF products in the log domain with a zero sentinel: mul(a, b) =
//     expz[logz[a] + logz[b]], logz[0] = 2(q - 1) and expz zero from there
//     on (the plain version's own tables, copied to shared memory once per
//     CTA);
//   * S_j = XOR_k cw[k] * alpha^((first_root + j)(n - 1 - k)), on the low m
//     bits of each symbol;
//   * the plain version's fixed-shift Berlekamp-Massey: 2t iterations over
//     C and B of nroots + 1 coefficients, B shifted one place each iteration
//     (its top coefficient dropped), the discrepancy over C[0..r], the same
//     `upgrade` (d != 0 and 2L <= r) and `nonzero` rules;
//   * Chien over the n real positions, lam(e) = Lambda(alpha^-e) with
//     degree e = n - 1 - k for codeword index k; omega = S * C mod x^nroots;
//     at each root the magnitude (omega(X^-1) / Lambda'(X^-1)) * X^(1 -
//     first_root), with 1 in place of a zero Lambda'; the patch is applied
//     wherever lam is 0, even where `ok` is false;
//   * ok = clean | (n_found == L & L <= t), n_err = 0 where clean, else
//     n_found.
//
// Design: one warp per codeword, kWarps warps per CTA, the CTAs walking the
// batch grid-stride.  Lane l loads the symbols k = l + 32 i into
// registers.  Syndromes: each lane sums its symbols' terms
// for every root, then a reduce-scatter of shuffles leaves S_j in lanes 2j
// and 2j + 1.  A codeword whose syndromes are all zero (warp-uniform) is
// stored as loaded.  Otherwise lanes 0..nroots hold C_i and B_i through
// Berlekamp-Massey, each discrepancy a shuffle of S and a warp XOR-reduce;
// every lane then holds all of C and omega in registers and evaluates
// Lambda, omega and Lambda' at its own positions, reading each symbol again
// to patch and store it; a ballot counts the roots.
//
// What bounds it on an H100 SXM: neither bytes nor operations.  DVB-T's
// 2-superframe call is 10,573 codewords: 2.2 MB in and 2.2 MB out (about
// 1.3 us at 3.35 TB/s) and some 3.5k shared-memory table lookups per clean
// codeword (a log per symbol, an exp per symbol and root), about 37 M in
// all, ~4.4 us at 32 lookups per SM and clock.  Measured there, it takes
// ~47 us, ~11 of them with the syndrome loop taken out: what bounds it is
// the latency of each warp's chain of lookups and the branch on nroots
// between them, not the bank conflicts of the lookups (a conflict-free,
// lane-minor table was no faster).  Dropping the branch took 9 us off
// DVB-T's call and put 7 on J.83B's, which then sums all 16 roots.  The
// error path keeps its positions in a loop, so the clean path runs at 80
// registers (3 CTAs of 8 warps per SM).  chip_smoke.py step 6b times it
// beside the plain version.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRoots = 16;                  // 2t, nroots <= 16
constexpr int kMaxM = 8;                       // GF(2^m), m <= 8
constexpr int kMaxQ1 = (1 << kMaxM) - 1;       // the largest q - 1
constexpr int kPerLane = (kMaxQ1 + 31) / 32;   // symbols a lane holds
constexpr int kWarps = 8;                      // codewords in flight per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kCtasPerSm = 4;                  // the persistent grid's depth
constexpr int kMaxDevices = 64;

struct Code {
    int n;           // symbols per codeword
    int nroots;      // 2t
    int t;           // nroots / 2
    int q1;          // 2^m - 1, also the symbol mask
    int first_root;  // mod q1
    int xfact;       // 1 - first_root, mod q1: log X^(1 - first_root) / e
};

__device__ __forceinline__ int warp_xor(int v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(kFull, v, o);
    return v;
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
rs_decode_kernel(const In* __restrict__ cw, long long batch, long long ld,
                 Code c, const int* __restrict__ expz_g,
                 const int* __restrict__ logz_g, Out* __restrict__ out,
                 int* __restrict__ n_err, uint8_t* __restrict__ ok)
{
    __shared__ int expz[4 * kMaxQ1 + 1];
    __shared__ int logz[kMaxQ1 + 1];
    const int q1 = c.q1;
    for (int i = threadIdx.x; i <= 4 * q1; i += kThreads) expz[i] = expz_g[i];
    for (int i = threadIdx.x; i <= q1; i += kThreads) logz[i] = logz_g[i];
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const long long warps = static_cast<long long>(gridDim.x) * kWarps;
    for (long long row = static_cast<long long>(blockIdx.x) * kWarps +
                         (threadIdx.x >> 5);
         row < batch; row += warps) {
        const In* src = cw + row * ld;
        int v[kPerLane];
        int s[kMaxRoots];
#pragma unroll
        for (int j = 0; j < kMaxRoots; ++j) s[j] = 0;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
            const int k = lane + 32 * i;
            const bool real = k < c.n;
            v[i] = real ? static_cast<int>(src[k]) : 0;
            // S_j ^= cw[k] * alpha^((first_root + j) e), e = n - 1 - k; a
            // zero symbol (and a lane past n) reads the zero tail of expz
            const int e = real ? c.n - 1 - k : 0;
            const int lv = logz[v[i] & q1];
            int pw = c.first_root * e % q1;
#pragma unroll
            for (int j = 0; j < kMaxRoots; ++j) {
                if (j >= c.nroots) break;
                s[j] ^= expz[lv + pw];
                pw += e;
                pw -= pw >= q1 ? q1 : 0;
            }
        }
        // reduce-scatter over the lanes: at offset o, a lane keeps the half
        // of its partial sums that bit o of its index names and sends the
        // other; after the offsets 16, 8, 4, 2 lane l holds S_(l >> 1)
        // summed over its pair, and offset 1 sums the pair
#pragma unroll
        for (int h = kMaxRoots / 2, o = 16; h >= 1; h >>= 1, o >>= 1) {
            const bool hi = lane & o;
#pragma unroll
            for (int i = 0; i < h; ++i) {
                const int send = hi ? s[i] : s[i + h];
                const int keep = hi ? s[i + h] : s[i];
                s[i] = keep ^ __shfl_xor_sync(kFull, send, o);
            }
        }
        const int syn = s[0] ^ __shfl_xor_sync(kFull, s[0], 1);
        Out* dst = out + row * c.n;
        if (!__any_sync(kFull, syn != 0)) {
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
                const int k = lane + 32 * i;
                if (k < c.n) dst[k] = static_cast<Out>(v[i]);
            }
            if (lane == 0) {
                n_err[row] = 0;
                ok[row] = 1;
            }
            continue;
        }

        // Berlekamp-Massey: lane i <= nroots holds C_i and B_i, the lanes
        // above hold zeros; log S_j is in lanes 2j and 2j + 1
        const int ls = logz[syn];
        int C = lane == 0, B = lane == 0, L = 0, bden = 1;
        for (int r = 0; r < c.nroots; ++r) {
            const int lsr = __shfl_sync(kFull, ls, (2 * (r - lane)) & 31);
            const int d = warp_xor(lane <= r ? expz[logz[C] + lsr] : 0);
            const int inv = expz[q1 - logz[bden == 0 ? 1 : bden]];
            const int coef = expz[logz[d] + logz[inv]];
            int bx = __shfl_up_sync(kFull, B, 1);
            if (lane == 0 || lane > c.nroots) bx = 0;
            const int cn = C ^ expz[logz[coef] + logz[bx]];
            const bool upgrade = d != 0 && 2 * L <= r;
            B = upgrade ? C : bx;
            if (upgrade) {
                L = r + 1 - L;
                bden = d;
            }
            if (d != 0) C = cn;
        }

        // every lane takes log C_j (j <= nroots) and log omega_j (j <
        // nroots), omega_j = XOR_(i <= j) C_i S_(j - i) made in lane j
        int lc[kMaxRoots + 1], lo[kMaxRoots];
        const int lcl = logz[C];
#pragma unroll
        for (int j = 0; j <= kMaxRoots; ++j)
            lc[j] = __shfl_sync(kFull, lcl, j);
        int om = 0;
#pragma unroll
        for (int i = 0; i < kMaxRoots; ++i) {
            const int lsi = __shfl_sync(kFull, ls, (2 * (lane - i)) & 31);
            if (i <= lane && lane < c.nroots) om ^= expz[lc[i] + lsi];
        }
        const int lol = logz[om];
#pragma unroll
        for (int j = 0; j < kMaxRoots; ++j)
            lo[j] = __shfl_sync(kFull, lol, j);

        // Chien and Forney at the lane's positions, one at a time (the
        // error path keeps only C and omega in registers, so the clean path
        // is not held to its registers): with pw = log X^-j for X =
        // alpha^e, lam = XOR_j C_j X^-j, omv = XOR_j omega_j X^-j and dl =
        // Lambda'(X^-1) = XOR_(odd j) C_j X^-(j - 1); the symbol is read
        // again (a cached load) to take its patch
        int found = 0;
#pragma unroll 1
        for (int k0 = 0; k0 < c.n; k0 += 32) {
            const int k = k0 + lane;
            const bool real = k < c.n;
            const int e = real ? c.n - 1 - k : 0;
            const int step = e == 0 ? 0 : q1 - e;
            int lam = 0, omv = 0, dl = 0, pw = 0;
#pragma unroll
            for (int j = 0; j <= kMaxRoots; ++j) {
                lam ^= expz[lc[j] + pw];
                if (j < kMaxRoots) omv ^= expz[lo[j] + pw];
                if (j % 2 == 0 && j < kMaxRoots) dl ^= expz[lc[j + 1] + pw];
                pw += step;
                pw -= pw >= q1 ? q1 : 0;
            }
            const bool root = real && lam == 0;
            found += __popc(__ballot_sync(kFull, root));
            if (real) {
                int sym = static_cast<int>(src[k]);
                if (root) {
                    const int inv = expz[q1 - logz[dl == 0 ? 1 : dl]];
                    const int x = expz[logz[omv] + logz[inv]];
                    sym ^= expz[logz[x] + e * c.xfact % q1];
                }
                dst[k] = static_cast<Out>(sym);
            }
        }
        if (lane == 0) {
            n_err[row] = found;
            ok[row] = found == L && L <= c.t;
        }
    }
}

int g_sms[kMaxDevices];     // SMs per device, 0 until asked

cudaError_t sm_count(int* sms)
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (g_sms[dev] == 0) {
        err = cudaDeviceGetAttribute(&g_sms[dev],
                                     cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
    }
    *sms = g_sms[dev];
    return cudaSuccess;
}

template <typename In, typename Out>
void launch(const void* cw, long long batch, long long ld, const Code& c,
            const void* expz, const void* logz, void* out, void* n_err,
            void* ok, unsigned grid, cudaStream_t stream)
{
    rs_decode_kernel<In, Out><<<grid, kThreads, 0, stream>>>(
        static_cast<const In*>(cw), batch, ld, c,
        static_cast<const int*>(expz), static_cast<const int*>(logz),
        static_cast<Out*>(out), static_cast<int*>(n_err),
        static_cast<uint8_t*>(ok));
}

template <typename In>
bool launch_in(int out_bytes, const void* cw, long long batch, long long ld,
               const Code& c, const void* expz, const void* logz, void* out,
               void* n_err, void* ok, unsigned grid, cudaStream_t stream)
{
    switch (out_bytes) {
    case 1:
        launch<In, uint8_t>(cw, batch, ld, c, expz, logz, out, n_err, ok,
                            grid, stream);
        return true;
    case 4:
        launch<In, int32_t>(cw, batch, ld, c, expz, logz, out, n_err, ok,
                            grid, stream);
        return true;
    default: return false;
    }
}

}  // namespace

// cw: codewords [batch, n] of unsigned 1-byte or signed 4- or 8-byte
// integers (in_bytes), symbols contiguous, rows ld elements apart; the
// code: GF(2^m), m in [2, 8], n in (nroots, 2^m - 1], nroots in [1, 16],
// roots alpha^(first_root + j); expz: int32 [4 (2^m - 1) + 1] and logz:
// int32 [2^m], the plain version's zero-sentinel tables; out: [batch, n]
// contiguous, uint8 or int32 (out_bytes 1 or 4), each symbol XOR its patch
// (cast as a C cast casts); n_err: int32 [batch]; ok: bool [batch]; stream:
// a cudaStream_t on the current device.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a code past the caps or a size past
// what the kernel indexes).
extern "C" int rs_decode_launch(const void* cw, int in_bytes, long long batch,
                                long long ld, int m, int n, int nroots,
                                int first_root, const void* expz,
                                const void* logz, void* out, int out_bytes,
                                void* n_err, void* ok, void* stream)
{
    const int q1 = (1 << m) - 1;
    if (m < 2 || m > kMaxM || nroots < 1 || nroots > kMaxRoots ||
        n <= nroots || n > q1 || batch < 0 || ld < 0 ||
        batch > LLONG_MAX / (ld > n ? ld : n))
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return static_cast<int>(cudaSuccess);
    int sms = 0;
    cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long ctas = (batch + kWarps - 1) / kWarps;
    const long long most = static_cast<long long>(sms) * kCtasPerSm;
    const unsigned grid = static_cast<unsigned>(ctas < most ? ctas : most);
    const Code c{n, nroots, nroots / 2, q1, (first_root % q1 + q1) % q1,
                 ((1 - first_root) % q1 + q1) % q1};
    const auto s = static_cast<cudaStream_t>(stream);
    bool known = false;
    switch (in_bytes) {
    case 1:
        known = launch_in<uint8_t>(out_bytes, cw, batch, ld, c, expz, logz,
                                   out, n_err, ok, grid, s);
        break;
    case 4:
        known = launch_in<int32_t>(out_bytes, cw, batch, ld, c, expz, logz,
                                   out, n_err, ok, grid, s);
        break;
    case 8:
        known = launch_in<int64_t>(out_bytes, cw, batch, ld, c, expz, logz,
                                   out, n_err, ok, grid, s);
        break;
    default: break;
    }
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
