// Field kernels K1 (mont_mul), K4 (mont_pow), K5 (mont_prefix_scan), K12
// (mont_prefix_scan_parts), K9 (linear_scan), and the IPA round's transcript
// kernels K10 (sponge_squeeze2) and K11 (endo_inv).
//
// Replaces, in proof_systems_tpu/ops/pallas_field.py:
//   K1 mont_mul (l.398, body _kv_mul_redc l.155): elementwise a*b*R^-1.
//   K4 mont_pow_fused (l.481): a^e with 4-bit windows MSB-first and a
//      15-entry table (l.497-520); the exponent's digits are a kernel
//      argument here, as they were scalar-prefetched on the TPU.
//      Redesigned on chain_field.cuh (fe_pow_lat).
//   K5 mont_prefix_scan_fused (l.1019, _mont_scan_kernel l.873): inclusive
//      prefix product along the last axis, for rows of at most 64 chunks of
//      128 (limb.prefix_mul's dispatch, as pallas_field.py:1030-1034).
//   K12 mont_prefix_scan_parts (l.956, _mont_parts_kernel l.913): phases 1-2
//      of the product scan for longer rows: `partial` (rows, 128 * Cp), the
//      inclusive products inside each lane's Cp positions (padded with one
//      past n), and `excl` (rows, 128), the exclusive products of the lane
//      totals. The combine excl[j / Cp] * partial[j] is one K1 launch over
//      all positions, as on the TPU; that is what sets it apart from K5,
//      which combines inside its block. Redesigned on scan_field.cuh
//      (k_prod_parts, then k_prod_lanes).
//   K9 linear_scan_fused (l.1069): the first-order recurrence
//      s_j = x_j + c*s_(j-1) along the last axis for a static c (division by
//      X - c). Lane l owns a contiguous chunk of C = ceil(n / 128)
//      positions; the lane recurrence S_l = V_l + c^C S_(l-1) is a scan
//      whose multiplier at level k is the uniform constant c^(C 2^k), and
//      position i of a chunk gets s + c^(i+1) E_l. The constants arrive as
//      one device table, built once per (field, c, C, team). Redesigned on
//      scan_field.cuh (k_lin_parts, k_lin_lanes, then k_lin_combine).
//   K10 sponge_squeeze2_fused (l.646): absorb (x_L, y_L), permute, absorb
//      (x_R, y_R), permute, read REDC(state[0]); Poseidon over Fq with 55
//      full rounds of x^7 and the 3x3 MDS. The round constants and the MDS
//      arrive as one device tensor, built once per parameter set.
//      Redesigned on chain_field.cuh (sponge_squeeze2_lanes).
//   K11 endo_inv_fused (l.742): ScalarChallenge.to_field (the 64-step
//      a = b = 2 recurrence over bit pairs, sponge.rs:190-228), u = a*endo + b,
//      then u^(p-2) with K4's exponentiation (fe_pow_lat).
//
// Bound on this card: K1 is memory bound (3 x 32 B per product at
// 3.35 TB/s against 136 integer multiplies); K4 at a large batch is
// integer-multiply bound (329 products an element); K5, K12 and K9 are
// latency bound at the main path's shapes (one row): a chain of dependent
// products. K5 (one block of PST_LANES threads a row, each thread scanning
// a contiguous chunk with loads that are not coalesced across a warp) runs
// C + 7 levels, at most 71. K12 and K9 spread a row's lanes over teams of
// threads (scan_field.cuh): sc + log2 S + sc + 7 levels for K12 (16 + 5 +
// 16 + 7 at n = 2^16 with S = 32, against 512 + 7 one thread a lane), sc +
// log2 S + 1 + 7 and then 2 products a position for K9 (512 + 7 + 1 + 512
// before).
//
// K10, K11 and K4 at the proof's shapes (one element, or a handful) are
// chains of dependent products on one warp, which issues one instruction
// at a time: they run on chain_field.cuh's product for the Pasta moduli,
// whose time is its instruction count (0.44 us a product, 0.32 a square,
// against fe_mul's 0.62-0.70 on an H100). K4 is one thread an element with
// its table in shared memory, and a chain of 4 squares and a product a
// digit after the first (317 levels for e = p - 2). K10 is one warp on
// nine lanes, 4 product levels a round (x^2; x^4 and x^3 on two lanes;
// x^7; the lane's MDS entry times x^7 as column sums, reduced once a row):
// 441 levels. K11 is one thread: 64 steps of adds and subtracts, one CIOS
// product, then K4's chain.

#include "chain_field.cuh"
#include "scan_field.cuh"

__global__ void __launch_bounds__(256)
    k_mont_mul(FieldParams F, const uint32_t *__restrict__ a, const uint32_t *__restrict__ b,
               uint32_t *__restrict__ o, int64_t n) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fe_store(o, n, i, fe_mul(F, fe_load(a, n, i), fe_load(b, n, i)));
}

// One thread an element, POW_BLOCK threads a block, each with its 16-entry
// table in the block's shared memory (32 KB).
#define POW_BLOCK 64
__global__ void __launch_bounds__(POW_BLOCK)
    k_mont_pow(FieldParams F, PowDigits e, const uint32_t *__restrict__ a,
               uint32_t *__restrict__ o, int64_t n) {
    __shared__ uint32_t tab[16 * PST_NL * POW_BLOCK];
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fe_store(o, n, i, fe_pow_lat(F, fe_load(a, n, i), e, tab + threadIdx.x, POW_BLOCK));
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

// K12 and K9 (scan_field.cuh). Phase 1: SCAN_WARPS warps a block, each 32 /
// S lanes of one row, S = 1 << team_log2 threads a lane; TEAM = false
// compiles S = 1 alone. Phase 2: one block of PST_LANES threads a row.
template <bool TEAM>
__global__ void __launch_bounds__(32 * SCAN_WARPS)
    k_prod_parts(FieldParams F, const uint32_t *__restrict__ x, uint32_t *__restrict__ part,
                 uint32_t *__restrict__ tot, int64_t rows, int64_t n, int64_t cp, int team_log2) {
    __shared__ uint32_t tiles[SCAN_WARPS * SCAN_TILE_WORDS];
    const int w = threadIdx.x / 32;
    ScanWarp g;
    if (!scan_warp(g, rows, n, cp, TEAM ? team_log2 : 0, (int64_t)blockIdx.x * SCAN_WARPS + w))
        return;  // whole warps
    prod_parts_thread<TEAM>(F, g, x, part, tot, tiles + w * SCAN_TILE_WORDS, threadIdx.x % 32);
}

// In place over the lane totals tot (rows, PST_LANES): their exclusive
// products.
__global__ void __launch_bounds__(PST_LANES)
    k_prod_lanes(FieldParams F, uint32_t *__restrict__ tot, int64_t rows) {
    __shared__ uint32_t sh[2 * PST_NL * PST_LANES];
    const int t = threadIdx.x;
    const int64_t i = (int64_t)blockIdx.x * PST_LANES + t;
    const Fe v = fe_load(tot, rows * PST_LANES, i);
    fe_store(tot, rows * PST_LANES, i, lane_excl(ProdOp{F}, t, v, sh));
}

template <bool TEAM>
__global__ void __launch_bounds__(32 * SCAN_WARPS)
    k_lin_parts(FieldParams F, const uint32_t *__restrict__ x, const uint32_t *__restrict__ tab,
                int64_t tlen, uint32_t *__restrict__ out, uint32_t *__restrict__ toff,
                uint32_t *__restrict__ tot, int64_t rows, int64_t n, int64_t cp, int team_log2) {
    __shared__ uint32_t tiles[SCAN_WARPS * SCAN_TILE_WORDS];
    const int w = threadIdx.x / 32;
    ScanWarp g;
    if (!scan_warp(g, rows, n, cp, TEAM ? team_log2 : 0, (int64_t)blockIdx.x * SCAN_WARPS + w))
        return;
    lin_parts_thread<TEAM>(lin_op(F, tab, tlen, cp), g, x, out, toff, tot,
                           tiles + w * SCAN_TILE_WORDS, threadIdx.x % 32);
}

// In place over the lane values tot (rows, PST_LANES): each lane's incoming
// value E_l = S_(l-1) of S_l = V_l + c^cp S_(l-1).
__global__ void __launch_bounds__(PST_LANES)
    k_lin_lanes(FieldParams F, const uint32_t *__restrict__ tab, int64_t tlen, int64_t cp,
                uint32_t *__restrict__ tot, int64_t rows) {
    __shared__ uint32_t sh[2 * PST_NL * PST_LANES];
    const int t = threadIdx.x;
    const int64_t i = (int64_t)blockIdx.x * PST_LANES + t;
    const Fe v = fe_load(tot, rows * PST_LANES, i);
    fe_store(tot, rows * PST_LANES, i, lane_excl(lin_op(F, tab, tlen, cp), t, v, sh));
}

// One thread a position of the (rows, n) output.
__global__ void __launch_bounds__(256)
    k_lin_combine(FieldParams F, const uint32_t *__restrict__ tab, int64_t tlen, int64_t cp,
                  int64_t sc, int team_log2, uint32_t *out, const uint32_t *__restrict__ toff,
                  const uint32_t *__restrict__ excl, int64_t rows, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rows * n) return;
    lin_combine_at(lin_op(F, tab, tlen, cp), rows, n, sc, team_log2, out, toff, excl, i);
}

// Blocks of phase 1: rows * PST_LANES lanes of S threads, SCAN_WARPS warps a
// block.
static unsigned scan_blocks(int64_t rows, int team_log2) {
    const int64_t warps = (rows * PST_LANES << team_log2) / 32;
    return (unsigned)((warps + SCAN_WARPS - 1) / SCAN_WARPS);
}

static bool scan_team_valid(int team_log2) { return team_log2 >= 0 && team_log2 <= 5; }

// One warp on nine lanes (sponge_squeeze2_lanes, chain_field.cuh).
// state (8, 3), xs and ys (8, 2) Montgomery; consts (8, 3 * nrounds + 9).
__global__ void __launch_bounds__(32)
    k_sponge_squeeze2(FieldParams F, const uint32_t *__restrict__ state,
                      const uint32_t *__restrict__ xs, const uint32_t *__restrict__ ys,
                      const uint32_t *__restrict__ consts, int nrounds,
                      uint32_t *__restrict__ ost, uint32_t *__restrict__ ochal) {
    sponge_squeeze2_lanes(F, threadIdx.x, state, xs, ys, consts, nrounds, ost, ochal);
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
    __shared__ uint32_t tab[16 * PST_NL];
    fe_store(oinv, 1, 0, fe_pow_lat(F, u, e, tab, 1));
}

// One thread's chain of `steps` dependent products of one kind, to time a
// product's latency (chip_smoke.py): kind 0 field.cuh's CIOS fe_mul, 1
// fe_mul_lat, 2 fe_sqr_lat, 3 fe_dot3_lat. x (8, 4): the start a and the
// operands x1-x3; a = a * x1, a^2 or dot3(a, x1, a, x2, a, x3). The
// operands are read at the thread's index (0), as the kernels read theirs,
// so that the compiler cannot treat them as the same for every thread.
__global__ void __launch_bounds__(32)
    k_product_chain(FieldParams F, int kind, const uint32_t *__restrict__ x, int steps,
                    uint32_t *__restrict__ o) {
    const int t = threadIdx.x;
    Fe a = fe_load(x, 4, t);
    const Fe x1 = fe_load(x, 4, t + 1), x2 = fe_load(x, 4, t + 2), x3 = fe_load(x, 4, t + 3);
    if (kind == 0) {
#pragma unroll 1
        for (int s = 0; s < steps; ++s) a = fe_mul(F, a, x1);
    } else if (kind == 1) {
#pragma unroll 1
        for (int s = 0; s < steps; ++s) a = fe_mul_lat(F, a, x1);
    } else if (kind == 2) {
#pragma unroll 1
        for (int s = 0; s < steps; ++s) a = fe_sqr_lat(F, a);
    } else {
#pragma unroll 1
        for (int s = 0; s < steps; ++s) a = fe_dot3_lat(F, a, x1, a, x2, a, x3);
    }
    fe_store(o, 1, t, a);
}

static int pow_digits(PowDigits &e, const uint8_t *digits, int nd) {
    return pst_pow_digits(e, digits, nd) ? 0 : (int)cudaErrorInvalidValue;
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
    const FieldParams F = pst_field_params(fp);
    if (!pst_pasta_shape(F)) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        int64_t blocks = (n + POW_BLOCK - 1) / POW_BLOCK;
        k_mont_pow<<<(unsigned)blocks, POW_BLOCK, 0, (cudaStream_t)stream>>>(F, e, a, o, n);
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

// K12: the partial products into part (rows, PST_LANES * cp), the
// exclusive products of the lane totals into excl (rows, PST_LANES); teams
// of 1 << team_log2 threads, team_log2 in [0, 5] (kernels.field_scan_team).
int pst_mont_prefix_parts(const uint32_t *fp, const uint32_t *x, uint32_t *part,
                          uint32_t *excl, int64_t rows, int64_t n, int64_t cp, int team_log2,
                          void *stream) {
    if (!scan_team_valid(team_log2)) return (int)cudaErrorInvalidValue;
    if (rows > 0 && n > 0) {
        const FieldParams F = pst_field_params(fp);
        const cudaStream_t s = (cudaStream_t)stream;
        const auto parts = team_log2 ? k_prod_parts<true> : k_prod_parts<false>;
        parts<<<scan_blocks(rows, team_log2), 32 * SCAN_WARPS, 0, s>>>(F, x, part, excl, rows, n,
                                                                       cp, team_log2);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        k_prod_lanes<<<(unsigned)rows, PST_LANES, 0, s>>>(F, excl, rows);
    }
    return (int)cudaGetLastError();
}

// K9: tab (8, tlen) of kernels.linear_kernel_table for (c, cp, sc); scratch
// PST_NL * rows * PST_LANES * (S + 1) words: the team offsets (rows,
// PST_LANES, S) limb-major, then the lane values (rows, PST_LANES).
int pst_linear_scan(const uint32_t *fp, const uint32_t *x, const uint32_t *tab, int64_t tlen,
                    uint32_t *scratch, uint32_t *o, int64_t rows, int64_t n, int64_t cp,
                    int team_log2, void *stream) {
    if (!scan_team_valid(team_log2)) return (int)cudaErrorInvalidValue;
    if (rows > 0 && n > 0) {
        const FieldParams F = pst_field_params(fp);
        const cudaStream_t s = (cudaStream_t)stream;
        const int64_t sc = (cp + (1 << team_log2) - 1) >> team_log2;
        uint32_t *toff = scratch, *tot = scratch + (PST_NL * rows * PST_LANES << team_log2);
        const auto parts = team_log2 ? k_lin_parts<true> : k_lin_parts<false>;
        parts<<<scan_blocks(rows, team_log2), 32 * SCAN_WARPS, 0, s>>>(F, x, tab, tlen, o, toff,
                                                                       tot, rows, n, cp, team_log2);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        k_lin_lanes<<<(unsigned)rows, PST_LANES, 0, s>>>(F, tab, tlen, cp, tot, rows);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        k_lin_combine<<<(unsigned)((rows * n + 255) / 256), 256, 0, s>>>(
            F, tab, tlen, cp, sc, team_log2, o, toff, tot, rows, n);
    }
    return (int)cudaGetLastError();
}

int pst_sponge_squeeze2(const uint32_t *fp, const uint32_t *state, const uint32_t *xs,
                        const uint32_t *ys, const uint32_t *consts, int nrounds,
                        uint32_t *ost, uint32_t *ochal, void *stream) {
    const FieldParams F = pst_field_params(fp);
    if (!pst_pasta_shape(F)) return (int)cudaErrorInvalidValue;
    k_sponge_squeeze2<<<1, 32, 0, (cudaStream_t)stream>>>(F, state, xs, ys, consts, nrounds,
                                                            ost, ochal);
    return (int)cudaGetLastError();
}

int pst_endo_inv(const uint32_t *fp, const uint32_t *endo_words, const uint8_t *digits,
                 int nd, const int32_t *bits, uint32_t *ou, uint32_t *oinv, void *stream) {
    PowDigits e;
    if (int rc = pow_digits(e, digits, nd)) return rc;
    const FieldParams F = pst_field_params(fp);
    if (!pst_pasta_shape(F)) return (int)cudaErrorInvalidValue;
    Fe endo;
    std::memcpy(endo.v, endo_words, sizeof(endo.v));
    k_endo_inv<<<1, 1, 0, (cudaStream_t)stream>>>(F, endo, e, bits, ou, oinv);
    return (int)cudaGetLastError();
}

int pst_product_chain(const uint32_t *fp, int kind, const uint32_t *x, int steps, uint32_t *o,
                      void *stream) {
    const FieldParams F = pst_field_params(fp);
    if (!pst_pasta_shape(F) || kind < 0 || kind > 3) return (int)cudaErrorInvalidValue;
    k_product_chain<<<1, 1, 0, (cudaStream_t)stream>>>(F, kind, x, steps, o);
    return (int)cudaGetLastError();
}

// Registers, local (stack) bytes, static and dynamic shared memory of
// k_sponge_squeeze2 (which 0), k_mont_pow (1), k_endo_inv (2) or
// k_product_chain (3).
int pst_chain_attrs(int which, int *out) {
    const void *fn = which == 0   ? (const void *)k_sponge_squeeze2
                     : which == 1 ? (const void *)k_mont_pow
                     : which == 2 ? (const void *)k_endo_inv
                     : which == 3 ? (const void *)k_product_chain
                                  : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fn);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = 0;
    return (int)e;
}

// Registers, local (stack) bytes, static and dynamic shared memory of K12's
// and K9's kernels: k_prod_parts<false> (which 0), k_prod_parts<true> (1),
// k_prod_lanes (2), k_lin_parts<false> (3), k_lin_parts<true> (4),
// k_lin_lanes (5), k_lin_combine (6).
int pst_scan_attrs(int which, int *out) {
    const void *fns[] = {(const void *)k_prod_parts<false>, (const void *)k_prod_parts<true>,
                         (const void *)k_prod_lanes,        (const void *)k_lin_parts<false>,
                         (const void *)k_lin_parts<true>,   (const void *)k_lin_lanes,
                         (const void *)k_lin_combine};
    if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0])))
        return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fns[which]);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = 0;
    return (int)e;
}

const char *pst_field_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
