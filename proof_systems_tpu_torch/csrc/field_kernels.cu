// Field kernels K1 (mont_mul), K4 (mont_pow), K5 (mont_prefix_scan), K12
// (mont_prefix_scan_parts), K9 (linear_scan), and the IPA round's transcript
// kernels K10 (sponge_squeeze2) and K11 (endo_inv).
//
// Replaces, in proof_systems_tpu/ops/pallas_field.py:
//   K1 mont_mul (l.398, body _kv_mul_redc l.155): elementwise a*b*R^-1.
//   K4 mont_pow_fused (l.481): a^e with 4-bit windows MSB-first and a
//      15-entry table (l.497-520); the exponent's digits are a kernel
//      argument here, as they were scalar-prefetched on the TPU.
//   K5 mont_prefix_scan_fused (l.1019, _mont_scan_kernel l.873): inclusive
//      prefix product along the last axis, for rows of at most 64 chunks of
//      128 (limb.prefix_mul's dispatch, as pallas_field.py:1030-1034).
//   K12 mont_prefix_scan_parts (l.956, _mont_parts_kernel l.913): phases 1-2
//      of the product scan for longer rows: `partial` (rows, 128 * Cp), the
//      inclusive products inside each lane's Cp positions (padded with one
//      past n), and `excl` (rows, 128), the exclusive products of the lane
//      totals. The combine excl[j / Cp] * partial[j] is one K1 launch over
//      all positions, as on the TPU; that is what sets it apart from K5,
//      which combines inside its block.
//   K9 linear_scan_fused (l.1069): the first-order recurrence
//      s_j = x_j + c*s_(j-1) along the last axis for a static c (division by
//      X - c). Lane l owns a contiguous chunk of C = ceil(n / 128) positions;
//      the lane recurrence S_l = V_l + c^C S_(l-1) runs as a Hillis-Steele
//      pass whose multiplier at level k is the uniform constant c^(C 2^k),
//      and position i of a chunk gets s + c^(i+1) E_l. The constants arrive
//      as one device table [c^(i+1), i < C] ++ [c^(C 2^k), k < 7], built once
//      per (field, c, C).
//   K10 sponge_squeeze2_fused (l.646): absorb (x_L, y_L), permute, absorb
//      (x_R, y_R), permute, read REDC(state[0]); Poseidon over Fq with 55
//      full rounds of x^7 and the 3x3 MDS. The round constants and the MDS
//      arrive as one device tensor, built once per parameter set.
//   K11 endo_inv_fused (l.742): ScalarChallenge.to_field (the 64-step
//      a = b = 2 recurrence over bit pairs, sponge.rs:190-228), u = a*endo + b,
//      then u^(p-2) with K4's windowed exponentiation (fe_pow).
//
// Bound on this card: K1 is memory bound (3 x 32 B per product at
// 3.35 TB/s against 136 integer multiplies); K4 is integer-multiply bound (about
// 334 products per element); K5, K12 and K9 are latency bound at the main
// path's shapes (one to a handful of rows): a thread runs a chain of about
// C + 7 dependent products (C + 7 + C for K9), 519 and 1,031 at n = 2^16.
//
// Simple design, left for later: one thread per element (K1, K4) and one
// block of PST_LANES threads per row (K5, K12, K9), each thread scanning a
// contiguous chunk, so the scans' loads are not coalesced across a warp.
//
// K10 and K11 run once per IPA round on a handful of field elements: they
// are latency bound, a chain of dependent Montgomery products. K10 is one
// block of three threads, one per state element, sharing the sboxed state
// through shared memory for the MDS product: 2 x 55 rounds of 4 + 3
// dependent products each. K11 is one thread: 64 steps of adds and
// subtracts, one product, then 64 x 5 + 14 products of the inverse.

#include "field.cuh"

__global__ void __launch_bounds__(256)
    k_mont_mul(FieldParams F, const uint32_t *__restrict__ a, const uint32_t *__restrict__ b,
               uint32_t *__restrict__ o, int64_t n) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fe_store(o, n, i, fe_mul(F, fe_load(a, n, i), fe_load(b, n, i)));
}

// Exponent as 4-bit digits, most significant first (at most 256 bits).
struct PowDigits {
    uint8_t d[64];
    int32_t nd;
};

// a^e with 4-bit windows, most significant first, over a 15-entry table
// (pallas_field.py:497-520).
__device__ Fe fe_pow(const FieldParams &F, const Fe &a, const PowDigits &e) {
    Fe tab[16];
    tab[0] = fe_one(F);
    tab[1] = a;
    for (int k = 2; k < 16; ++k) tab[k] = fe_mul(F, tab[k - 1], tab[1]);
    Fe acc = tab[0];
    for (int k = 0; k < e.nd; ++k) {
        for (int s = 0; s < 4; ++s) acc = fe_mul(F, acc, acc);
        acc = fe_mul(F, acc, tab[e.d[k]]);
    }
    return acc;
}

__global__ void __launch_bounds__(128)
    k_mont_pow(FieldParams F, PowDigits e, const uint32_t *__restrict__ a,
               uint32_t *__restrict__ o, int64_t n) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fe_store(o, n, i, fe_pow(F, fe_load(a, n, i), e));
}

// Exclusive Hillis-Steele product over the block's lane values `v` (neutral:
// one); sh is the block's PST_LANES-entry scratch.
__device__ Fe block_excl_prod(const FieldParams &F, Fe *sh, const Fe &v) {
    const int t = threadIdx.x;
    sh[t] = v;
    __syncthreads();
    Fe excl = t > 0 ? sh[t - 1] : fe_one(F);
    __syncthreads();
    sh[t] = excl;
    __syncthreads();
    for (int s = 1; s < PST_LANES; s <<= 1) {
        Fe other = t >= s ? sh[t - s] : fe_one(F);
        __syncthreads();
        excl = fe_mul(F, excl, other);
        sh[t] = excl;
        __syncthreads();
    }
    return excl;
}

// One block per row of x (rows, n), limb stride rows * n. Thread t owns
// positions [t * cp, t * cp + cp) of its row.
__global__ void __launch_bounds__(PST_LANES)
    k_mont_prefix(FieldParams F, const uint32_t *__restrict__ x, uint32_t *__restrict__ o,
                  int64_t rows, int64_t n, int64_t cp) {
    __shared__ Fe sh[PST_LANES];
    const int t = threadIdx.x;
    const int64_t stride = rows * n;
    const int64_t base = (int64_t)blockIdx.x * n;
    const int64_t lo = (int64_t)t * cp;
    const int64_t hi = lo + cp < n ? lo + cp : n;

    // 1. sequential inclusive product over this thread's chunk
    Fe carry = fe_one(F);
    for (int64_t j = lo; j < hi; ++j) {
        carry = fe_mul(F, carry, fe_load(x, stride, base + j));
        fe_store(o, stride, base + j, carry);
    }

    // 2. exclusive Hillis-Steele over the chunk totals (neutral: one)
    const Fe excl = block_excl_prod(F, sh, carry);

    // 3. fold the offset into every position of the chunk
    for (int64_t j = lo; j < hi; ++j)
        fe_store(o, stride, base + j, fe_mul(F, excl, fe_load(o, stride, base + j)));
}

// One block per row of x (rows, n), limb stride rows * n; partial (rows,
// PST_LANES * cp) and excl (rows, PST_LANES) with their own limb strides.
// Thread t owns positions [t * cp, t * cp + cp), one past n.
__global__ void __launch_bounds__(PST_LANES)
    k_mont_prefix_parts(FieldParams F, const uint32_t *__restrict__ x,
                        uint32_t *__restrict__ part, uint32_t *__restrict__ excl,
                        int64_t rows, int64_t n, int64_t cp) {
    __shared__ Fe sh[PST_LANES];
    const int t = threadIdx.x;
    const int64_t npad = (int64_t)PST_LANES * cp;
    const int64_t row = blockIdx.x;
    const Fe one = fe_one(F);
    Fe carry = one;
    for (int64_t c = 0; c < cp; ++c) {
        const int64_t j = (int64_t)t * cp + c;
        carry = fe_mul(F, carry, j < n ? fe_load(x, rows * n, row * n + j) : one);
        fe_store(part, rows * npad, row * npad + j, carry);
    }
    fe_store(excl, rows * PST_LANES, row * PST_LANES + t, block_excl_prod(F, sh, carry));
}

// One block per row of x (rows, n), limb stride rows * n. tab (8, cp + 7):
// c^(i+1) for i < cp, then c^(cp * 2^k) for k < 7. Thread t owns positions
// [t * cp, t * cp + cp) of its row; the recurrence starts from s = 0.
__global__ void __launch_bounds__(PST_LANES)
    k_linear_scan(FieldParams F, const uint32_t *__restrict__ x,
                  const uint32_t *__restrict__ tab, uint32_t *__restrict__ o,
                  int64_t rows, int64_t n, int64_t cp) {
    __shared__ Fe sh[PST_LANES];
    const int t = threadIdx.x;
    const int64_t stride = rows * n;
    const int64_t tstride = cp + 7;
    const int64_t base = (int64_t)blockIdx.x * n;
    const int64_t lo = (int64_t)t * cp;
    const int64_t hi = lo + cp < n ? lo + cp : n;

    // 1. s = x + c*s over this thread's chunk
    const Fe c = fe_load(tab, tstride, 0);
    Fe s = fe_zero();
    for (int64_t j = lo; j < hi; ++j) {
        s = fe_add(F, fe_load(x, stride, base + j), fe_mul(F, c, s));
        fe_store(o, stride, base + j, s);
    }

    // 2. inclusive Hillis-Steele S_l = V_l + c^(cp 2^k) S_(l - 2^k), neutral
    //    zero, then E_l = S_(l-1)
    sh[t] = s;
    __syncthreads();
    for (int k = 0; k < 7; ++k) {
        const int d = 1 << k;
        Fe other = t >= d ? sh[t - d] : fe_zero();
        __syncthreads();
        s = fe_add(F, s, fe_mul(F, fe_load(tab, tstride, cp + k), other));
        sh[t] = s;
        __syncthreads();
    }
    const Fe e = t > 0 ? sh[t - 1] : fe_zero();

    // 3. position i of the chunk: s + c^(i+1) E_l
    for (int64_t j = lo; j < hi; ++j)
        fe_store(o, stride, base + j,
                 fe_add(F, fe_load(o, stride, base + j), fe_mul(F, fe_load(tab, tstride, j - lo), e)));
}

// One block of three threads; thread t owns state element t. state (8, 3),
// xs and ys (8, 2) Montgomery; consts (8, 3 * nrounds + 9): rc[r][j] in
// column 3r + j, then mds[i][j] in column 3 * nrounds + 3i + j.
__global__ void __launch_bounds__(32)
    k_sponge_squeeze2(FieldParams F, const uint32_t *__restrict__ state,
                      const uint32_t *__restrict__ xs, const uint32_t *__restrict__ ys,
                      const uint32_t *__restrict__ consts, int nrounds,
                      uint32_t *__restrict__ ost, uint32_t *__restrict__ ochal) {
    __shared__ Fe sboxed[3];
    const int t = threadIdx.x;
    const int64_t cstride = 3 * (int64_t)nrounds + 9;
    Fe mds[3];
    for (int j = 0; j < 3; ++j) mds[j] = fe_load(consts, cstride, 3 * nrounds + 3 * t + j);
    Fe s = fe_load(state, 3, t);
    for (int k = 0; k < 2; ++k) {
        // absorb: state[0] += x, state[1] += y (the rate-2 sponge)
        if (t == 0) s = fe_add(F, s, fe_load(xs, 2, k));
        if (t == 1) s = fe_add(F, s, fe_load(ys, 2, k));
        for (int r = 0; r < nrounds; ++r) {
            Fe x2 = fe_mul(F, s, s);
            Fe x3 = fe_mul(F, x2, s);
            sboxed[t] = fe_mul(F, fe_mul(F, x3, x3), s);  // x^7
            __syncthreads();
            Fe acc = fe_add(F, fe_mul(F, mds[0], sboxed[0]), fe_mul(F, mds[1], sboxed[1]));
            acc = fe_add(F, acc, fe_mul(F, mds[2], sboxed[2]));
            s = fe_add(F, acc, fe_load(consts, cstride, 3 * r + t));
            __syncthreads();
        }
    }
    fe_store(ost, 3, t, s);
    if (t == 0) {
        Fe one = fe_zero();
        one.v[0] = 1;  // the product with plain 1 is REDC
        fe_store(ochal, 1, 0, fe_mul(F, s, one));
    }
}

// One thread. bits: 128 int32 challenge bits, least significant first;
// endo: the endo coefficient in Montgomery form; e: the digits of p - 2.
__global__ void __launch_bounds__(32)
    k_endo_inv(FieldParams F, Fe endo, PowDigits e, const int32_t *__restrict__ bits,
               uint32_t *__restrict__ ou, uint32_t *__restrict__ oinv) {
    const Fe one = fe_one(F);
    Fe a = fe_add(F, one, one);
    Fe b = a;
    for (int i = 63; i >= 0; --i) {
        a = fe_add(F, a, a);
        b = fe_add(F, b, b);
        const bool r0 = bits[2 * i] == 1;
        const bool r1 = bits[2 * i + 1] == 1;
        if (r1)
            a = r0 ? fe_add(F, a, one) : fe_sub(F, a, one);
        else
            b = r0 ? fe_add(F, b, one) : fe_sub(F, b, one);
    }
    const Fe u = fe_add(F, fe_mul(F, a, endo), b);
    fe_store(ou, 1, 0, u);
    fe_store(oinv, 1, 0, fe_pow(F, u, e));
}

static int pow_digits(PowDigits &e, const uint8_t *digits, int nd) {
    if (nd < 0 || nd > 64) return (int)cudaErrorInvalidValue;
    std::memset(&e, 0, sizeof(e));
    std::memcpy(e.d, digits, nd);
    e.nd = nd;
    return 0;
}

extern "C" {

int pst_mont_mul(const uint32_t *fp, const uint32_t *a, const uint32_t *b, uint32_t *o,
                 int64_t n, void *stream) {
    if (n > 0) {
        int64_t blocks = (n + 255) / 256;
        k_mont_mul<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), a, b, o, n);
    }
    return (int)cudaGetLastError();
}

int pst_mont_pow(const uint32_t *fp, const uint8_t *digits, int nd, const uint32_t *a,
                 uint32_t *o, int64_t n, void *stream) {
    PowDigits e;
    if (int rc = pow_digits(e, digits, nd)) return rc;
    if (n > 0) {
        int64_t blocks = (n + 127) / 128;
        k_mont_pow<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), e, a, o, n);
    }
    return (int)cudaGetLastError();
}

int pst_mont_prefix(const uint32_t *fp, const uint32_t *x, uint32_t *o, int64_t rows,
                    int64_t n, int64_t cp, void *stream) {
    if (rows > 0 && n > 0)
        k_mont_prefix<<<(unsigned)rows, PST_LANES, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), x, o, rows, n, cp);
    return (int)cudaGetLastError();
}

int pst_mont_prefix_parts(const uint32_t *fp, const uint32_t *x, uint32_t *part,
                          uint32_t *excl, int64_t rows, int64_t n, int64_t cp, void *stream) {
    if (rows > 0 && n > 0)
        k_mont_prefix_parts<<<(unsigned)rows, PST_LANES, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), x, part, excl, rows, n, cp);
    return (int)cudaGetLastError();
}

int pst_linear_scan(const uint32_t *fp, const uint32_t *x, const uint32_t *tab, uint32_t *o,
                    int64_t rows, int64_t n, int64_t cp, void *stream) {
    if (rows > 0 && n > 0)
        k_linear_scan<<<(unsigned)rows, PST_LANES, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), x, tab, o, rows, n, cp);
    return (int)cudaGetLastError();
}

int pst_sponge_squeeze2(const uint32_t *fp, const uint32_t *state, const uint32_t *xs,
                        const uint32_t *ys, const uint32_t *consts, int nrounds,
                        uint32_t *ost, uint32_t *ochal, void *stream) {
    k_sponge_squeeze2<<<1, 3, 0, (cudaStream_t)stream>>>(pst_field_params(fp), state, xs, ys,
                                                           consts, nrounds, ost, ochal);
    return (int)cudaGetLastError();
}

int pst_endo_inv(const uint32_t *fp, const uint32_t *endo_words, const uint8_t *digits,
                 int nd, const int32_t *bits, uint32_t *ou, uint32_t *oinv, void *stream) {
    PowDigits e;
    if (int rc = pow_digits(e, digits, nd)) return rc;
    Fe endo;
    std::memcpy(endo.v, endo_words, sizeof(endo.v));
    k_endo_inv<<<1, 1, 0, (cudaStream_t)stream>>>(pst_field_params(fp), endo, e, bits, ou,
                                                    oinv);
    return (int)cudaGetLastError();
}

const char *pst_field_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
