// Curve kernels K2 (jacobian_add), K3 (jacobian_double), K6
// (ec_prefix_scan_parts), K7 (ec_prefix_scan_fused) and K8
// (combine_windows), over Vesta's base field Fq (any field: the parameters
// are a kernel argument).
//
// Replaces, in proof_systems_tpu/ops/pallas_field.py:
//   K2 jacobian_add (l.412, _kv_ec_add l.299): complete elementwise add.
//   K3 jacobian_double (l.439, _kv_ec_double l.229): elementwise doubling.
//   K6 ec_prefix_scan_parts (l.1333, _ec_parts_kernel l.1189, _hs_scan_ec
//      l.1261): phases 1-2 of the blocked Jacobian prefix scan. Returns the
//      chunk partials and the exclusive per-chunk offsets, so that the
//      inclusive prefix of position j is excl[j / cp] + partial[j]. With
//      mixed=1 the chunk scan uses madd on affine-encoded input (z in {0, R},
//      as msm.py:338-342 requires) and phase 2 stays general adds.
//   K7 ec_prefix_scan_fused (l.1410, _ec_scan_kernel l.834): the same
//      phases 1-2 plus the combine, giving the full inclusive prefix scan.
//   K8 combine_windows_fused (l.560): the Pippenger window recombination
//      sum_w 2^(cw) win_w as a Horner chain from the top window (c doublings
//      and one general add per window, the order of l.596-607). The TPU
//      kernel's cap of 128 columns was its tile width and is not ported.
//
// Bound on this card: integer multiplies. A general add is 16 Montgomery
// products (11 for madd), each 128 IMAD.WIDE and 8 IMUL, against 192 B of
// operands. The scans are also latency bound: each thread runs its chunk
// sequentially.
//
// Simple design, left for later: one thread per element for K2/K3, one block
// of PST_LANES threads per row for K6/K7 with a contiguous chunk of
// cp = ceil(n / PST_LANES) positions per thread (loads are strided by cp
// across a warp, not coalesced), and a Hillis-Steele scan over the chunk
// totals in 12 KB of shared memory. At the main path's shapes K6 runs
// 360 rows (24 windows x 15 columns): 360 blocks of 128 threads that need
// up to 254 registers each, so about two blocks an SM and under two waves,
// each thread a chain of ceil(65537 / 128) dependent adds. The curve
// formulas are __noinline__ functions to bound code size and build time;
// ptxas reports their registers and stack frames.
//
// K8 is one thread per MSM column: at the verifier's b = 1 a single thread
// runs W * (c + 1) dependent curve operations (288 at c = 11, W = 24), a
// latency chain that no other block overlaps. Its time is kept in PERF.md.

#include "field.cuh"

__global__ void __launch_bounds__(128)
    k_jacobian_add(FieldParams F, const uint32_t *px, const uint32_t *py, const uint32_t *pz,
                   const uint32_t *qx, const uint32_t *qy, const uint32_t *qz, uint32_t *ox,
                   uint32_t *oy, uint32_t *oz, int64_t n) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Jac r = ec_add(F, jac_load(px, py, pz, n, i), jac_load(qx, qy, qz, n, i));
    jac_store(ox, oy, oz, n, i, r);
}

__global__ void __launch_bounds__(128)
    k_jacobian_double(FieldParams F, const uint32_t *px, const uint32_t *py,
                      const uint32_t *pz, uint32_t *ox, uint32_t *oy, uint32_t *oz,
                      int64_t n) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    jac_store(ox, oy, oz, n, i, ec_double(F, jac_load(px, py, pz, n, i)));
}

// One block per row of the (rows, n) input; limb stride rows * n.
// Thread t owns positions [t * cp, t * cp + cp).
//   fused = 0 (K6): out is (rows, PST_LANES * cp), written at every
//           position (past n the input is the identity), and the exclusive
//           offsets go to (ex, ey, ez), (rows, PST_LANES).
//   fused = 1 (K7): out is (rows, n), the inclusive prefix.
template <bool MIXED, bool FUSED>
__global__ void __launch_bounds__(PST_LANES)
    k_ec_scan(FieldParams F, const uint32_t *x, const uint32_t *y, const uint32_t *z,
              uint32_t *ox, uint32_t *oy, uint32_t *oz, uint32_t *ex, uint32_t *ey,
              uint32_t *ez, int64_t rows, int64_t n, int64_t cp) {
    __shared__ Jac sh[PST_LANES];
    const int t = threadIdx.x;
    const int64_t row = blockIdx.x;
    const int64_t in_stride = rows * n;
    const int64_t in_base = row * n;
    const int64_t olen = FUSED ? n : PST_LANES * cp;
    const int64_t out_stride = rows * olen;
    const int64_t out_base = row * olen;
    const int64_t lo = (int64_t)t * cp;
    const int64_t hi = lo + cp < n ? lo + cp : n;

    // 1. sequential inclusive scan of this thread's chunk; the first
    //    element seeds the carry, as in _ec_parts_kernel
    Jac carry = lo < n ? jac_load(x, y, z, in_stride, in_base + lo) : jac_identity();
    if (lo < olen) jac_store(ox, oy, oz, out_stride, out_base + lo, carry);
    for (int64_t j = lo + 1; j < lo + cp; ++j) {
        if (j < hi) {
            Jac v = jac_load(x, y, z, in_stride, in_base + j);
            carry = MIXED ? ec_madd(F, carry, v) : ec_add(F, carry, v);
        }
        if (j < olen) jac_store(ox, oy, oz, out_stride, out_base + j, carry);
    }

    // 2. exclusive Hillis-Steele over the chunk totals, general adds, the
    //    identity shifted in (_hs_scan_ec)
    sh[t] = carry;
    __syncthreads();
    Jac excl = t > 0 ? sh[t - 1] : jac_identity();
    __syncthreads();
    sh[t] = excl;
    __syncthreads();
    for (int s = 1; s < PST_LANES; s <<= 1) {
        Jac other = t >= s ? sh[t - s] : jac_identity();
        __syncthreads();
        excl = ec_add(F, excl, other);
        sh[t] = excl;
        __syncthreads();
    }

    if (!FUSED) {
        jac_store(ex, ey, ez, rows * PST_LANES, row * PST_LANES + t, excl);
        return;
    }
    // 3. combine: prefix = excl + partial at every position of the chunk
    for (int64_t j = lo; j < hi; ++j) {
        Jac v = jac_load(ox, oy, oz, out_stride, out_base + j);
        jac_store(ox, oy, oz, out_stride, out_base + j, ec_add(F, excl, v));
    }
}

// wx, wy, wz: (8, W, b) window sums, limb stride W * b; out: (8, b).
__global__ void __launch_bounds__(128)
    k_combine_windows(FieldParams F, const uint32_t *wx, const uint32_t *wy,
                      const uint32_t *wz, uint32_t *ox, uint32_t *oy, uint32_t *oz,
                      int64_t W, int64_t b, int c) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    Jac acc = jac_identity();
    for (int64_t w = W - 1; w >= 0; --w) {
        for (int k = 0; k < c; ++k) acc = ec_double(F, acc);
        acc = ec_add(F, acc, jac_load(wx, wy, wz, W * b, w * b + i));
    }
    jac_store(ox, oy, oz, b, i, acc);
}

extern "C" {

int pst_jacobian_add(const uint32_t *fp, const uint32_t *px, const uint32_t *py,
                     const uint32_t *pz, const uint32_t *qx, const uint32_t *qy,
                     const uint32_t *qz, uint32_t *ox, uint32_t *oy, uint32_t *oz, int64_t n,
                     void *stream) {
    if (n > 0) {
        int64_t blocks = (n + 127) / 128;
        k_jacobian_add<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), px, py, pz, qx, qy, qz, ox, oy, oz, n);
    }
    return (int)cudaGetLastError();
}

int pst_jacobian_double(const uint32_t *fp, const uint32_t *px, const uint32_t *py,
                        const uint32_t *pz, uint32_t *ox, uint32_t *oy, uint32_t *oz,
                        int64_t n, void *stream) {
    if (n > 0) {
        int64_t blocks = (n + 127) / 128;
        k_jacobian_double<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), px, py, pz, ox, oy, oz, n);
    }
    return (int)cudaGetLastError();
}

int pst_ec_scan_parts(const uint32_t *fp, const uint32_t *x, const uint32_t *y,
                      const uint32_t *z, uint32_t *px, uint32_t *py, uint32_t *pz,
                      uint32_t *ex, uint32_t *ey, uint32_t *ez, int64_t rows, int64_t n,
                      int64_t cp, int mixed, void *stream) {
    if (rows > 0 && n > 0) {
        FieldParams F = pst_field_params(fp);
        cudaStream_t s = (cudaStream_t)stream;
        if (mixed)
            k_ec_scan<true, false><<<(unsigned)rows, PST_LANES, 0, s>>>(
                F, x, y, z, px, py, pz, ex, ey, ez, rows, n, cp);
        else
            k_ec_scan<false, false><<<(unsigned)rows, PST_LANES, 0, s>>>(
                F, x, y, z, px, py, pz, ex, ey, ez, rows, n, cp);
    }
    return (int)cudaGetLastError();
}

int pst_ec_scan_fused(const uint32_t *fp, const uint32_t *x, const uint32_t *y,
                      const uint32_t *z, uint32_t *ox, uint32_t *oy, uint32_t *oz,
                      int64_t rows, int64_t n, int64_t cp, void *stream) {
    if (rows > 0 && n > 0)
        k_ec_scan<false, true><<<(unsigned)rows, PST_LANES, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), x, y, z, ox, oy, oz, nullptr, nullptr, nullptr, rows, n,
            cp);
    return (int)cudaGetLastError();
}

int pst_combine_windows(const uint32_t *fp, const uint32_t *wx, const uint32_t *wy,
                        const uint32_t *wz, uint32_t *ox, uint32_t *oy, uint32_t *oz,
                        int64_t W, int64_t b, int c, void *stream) {
    if (W > 0 && b > 0) {
        int64_t blocks = (b + 127) / 128;
        k_combine_windows<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), wx, wy, wz, ox, oy, oz, W, b, c);
    }
    return (int)cudaGetLastError();
}

const char *pst_curve_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
