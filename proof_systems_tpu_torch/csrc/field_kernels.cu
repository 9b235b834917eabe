// Field kernels K1 (mont_mul), K4 (mont_pow), K5 (mont_prefix_scan), K12
// (mont_prefix_scan_parts), K9 (linear_scan), and the IPA round's transcript
// kernels K10 (sponge_squeeze2) and K11 (endo_inv). This file holds K1, K4
// and the product-latency chain; scan_kernels.cu holds K5, K12 and K9, and
// transcript_kernels.cu K10 and K11. Each file is its own nvcc process, all
// started together, linked into one library (ops/kernels.py).
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
//      Redesigned on scan_field.cuh (prefix_block_thread): one block a row.
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
//      and u^-1 (u^(p-2) on the TPU). Redesigned on inv_field.cuh
//      (endo_inv_thread: the recurrence's closed form, a binary-GCD inverse).
//
// Bound on this card: K1 is memory bound (3 x 32 B per product at
// 3.35 TB/s against 136 integer multiplies); K4 at a large batch is
// integer-multiply bound (329 products an element); K5, K12 and K9 are
// latency bound at the main path's shapes (one row): a chain of dependent
// products. K5 runs a row (at most 8,192 positions) in one block of T
// threads, T the fewest from 32 to 512 that leave each at most 8 positions
// (kernels.prefix_geometry; 16 at 8,192), on chain_field.cuh's product:
// each thread reduces its sub-chunk of sc positions, loaded through its
// warp's tile (coalesced); the warp scans its 32 totals by shuffles (5
// levels, fewer where a lone warp holds the row in its first lanes); warp 0
// scans the block's warp totals (log2 of the warps); each thread rescans
// from its offset: sc + 5 + log2 W + 1 + sc products (16 + 5 + 4 + 1 + 16
// at 8,192, against 64 + 7 and a strided fold of the one-block-of-128
// design it replaces; 1 + 1 + 1 on a row of 2, in one warp without a
// barrier). A long row's 2n products then bind on the one SM's integer
// issue rate rather than on the chain (PERF.md section 6). K12
// and K9 spread a row's lanes over teams of threads (scan_field.cuh): sc +
// log2 S + sc + 7 levels for K12 (16 + 5 + 16 + 7 at n = 2^16 with S = 32,
// against 512 + 7 one thread a lane), sc + log2 S + 1 + 7 and then 2
// products a position for K9 (512 + 7 + 1 + 512 before).
//
// K10, K11 and K4 at the proof's shapes (one element, or a handful) are
// chains of dependent operations on one warp, which issues one instruction
// at a time: they run on chain_field.cuh's product for the Pasta moduli,
// whose time is its instruction count (0.44 us a product, 0.32 a square,
// against fe_mul's 0.62-0.70 on an H100). K4 is one thread an element with
// its table in shared memory, and a chain of 4 squares and a product a
// digit after the first (317 levels for e = p - 2). K10 is one warp on
// nine lanes, 4 product levels a round (x^2; x^4 and x^3 on two lanes;
// x^7; the lane's MDS entry times x^7 as column sums, reduced once a row):
// 441 levels. K11 is one thread: u by the closed form of the recurrence
// (one reduction of two products), then 17 batches of 30 binary-GCD steps
// on 64-bit words, each batch ending in a 2x2 update of a, b and of the
// Bezout coefficients (inv_field.cuh), then one product by R^3.

#include "inv_field.cuh"
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

// One thread's chain of `steps` dependent products of one kind, to time a
// product's latency (chip_smoke.py): kind 0 field.cuh's CIOS fe_mul, 1
// fe_mul_lat, 2 fe_sqr_lat, 3 fe_dot3_lat, 4 K11's inverse. x (8, 4): the
// start a and the operands x1-x3; a = a * x1, a^2, dot3(a, x1, a, x2, a,
// x3) or fe_inv_gcd(a) * x1 (the integer inverse, times x1 = R^3 mod p
// into Montgomery form). The
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
    } else if (kind == 3) {
#pragma unroll 1
        for (int s = 0; s < steps; ++s) a = fe_dot3_lat(F, a, x1, a, x2, a, x3);
    } else {
#pragma unroll 1
        for (int s = 0; s < steps; ++s) a = fe_mul_lat(F, fe_inv_gcd(F, a), x1);
    }
    fe_store(o, 1, t, a);
}

static int pow_digits(PowDigits &e, const uint8_t *digits, int nd) {
    return pst_pow_digits(e, digits, nd) ? 0 : (int)cudaErrorInvalidValue;
}

static int func_attrs(const void *fn, int *out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, fn);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = 0;
    return (int)e;
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

int pst_product_chain(const uint32_t *fp, int kind, const uint32_t *x, int steps, uint32_t *o,
                      void *stream) {
    const FieldParams F = pst_field_params(fp);
    if (!pst_pasta_shape(F) || kind < 0 || kind > 4) return (int)cudaErrorInvalidValue;
    k_product_chain<<<1, 1, 0, (cudaStream_t)stream>>>(F, kind, x, steps, o);
    return (int)cudaGetLastError();
}

// K10's and K11's attributes (transcript_kernels.cu).
int pst_transcript_attrs(int which, int *out);

// Registers, local (stack) bytes, static and dynamic shared memory of
// k_sponge_squeeze2 (which 0), k_mont_pow (1), k_endo_inv (2) or
// k_product_chain (3).
int pst_chain_attrs(int which, int *out) {
    if (which == 0 || which == 2) return pst_transcript_attrs(which, out);
    const void *fn = which == 1   ? (const void *)k_mont_pow
                     : which == 3 ? (const void *)k_product_chain
                                  : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return func_attrs(fn, out);
}

const char *pst_field_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
