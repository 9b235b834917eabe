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

// K5 (prefix_block_thread, scan_field.cuh, on chain_field.cuh's product):
// one block of 32 << warps_log2 threads a row of x (rows, n), thread t
// owning positions [t sc, t sc + sc); the warps' tiles in dynamic shared
// memory. At most PREFIX_THREADS threads: at 1,024 (64 registers a thread)
// the product spilled to the stack.
#define PREFIX_THREADS 512
__global__ void __launch_bounds__(PREFIX_THREADS)
    k_mont_prefix(FieldParams F, const uint32_t *__restrict__ x, uint32_t *__restrict__ o,
                  int64_t rows, int64_t n, int64_t sc, int warps_log2, int lanes_log2) {
    extern __shared__ uint32_t tiles[];
    __shared__ uint32_t sh[PST_NL * 32];
    const int t = threadIdx.x;
    prefix_block_thread(ProdLatOp{F}, x, o, rows, n, sc, warps_log2, lanes_log2, blockIdx.x,
                        tiles + (t / 32) * SCAN_TILE_WORDS, sh, t);
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

// One thread (endo_inv_thread, inv_field.cuh). bits: 128 int32 challenge
// bits, least significant first.
__global__ void __launch_bounds__(32)
    k_endo_inv(FieldParams F, EndoConsts k, const int32_t *__restrict__ bits,
               uint32_t *__restrict__ ou, uint32_t *__restrict__ oinv) {
    endo_inv_thread(F, k, bits, ou, oinv);
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

// Lets k_mont_prefix take the dynamic shared memory of PREFIX_THREADS
// threads' tiles, once a device.
static cudaError_t mont_prefix_ready() {
    static bool done[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || dev < 0 || dev >= 64 || done[dev]) return e;
    e = cudaFuncSetAttribute(k_mont_prefix, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SCAN_TILE_WORDS * 4 * (PREFIX_THREADS / 32));
    done[dev] = e == cudaSuccess;
    return e;
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

// K5 with 32 << warps_log2 threads a block (warps_log2 in [0, 4]), sc
// positions a thread, lanes_log2 levels of the warp scan (5 with more than
// one warp); the Pasta moduli only.
int pst_mont_prefix(const uint32_t *fp, const uint32_t *x, uint32_t *o, int64_t rows,
                    int64_t n, int64_t sc, int warps_log2, int lanes_log2, void *stream) {
    const FieldParams F = pst_field_params(fp);
    if (!pst_pasta_shape(F) || (32 << warps_log2) > PREFIX_THREADS || warps_log2 < 0 ||
        lanes_log2 < 0 || lanes_log2 > 5 || (warps_log2 > 0 && lanes_log2 != 5) || sc < 1 ||
        (sc << (5 + warps_log2)) < n)
        return (int)cudaErrorInvalidValue;
    if (rows <= 0 || n <= 0) return 0;
    const cudaError_t e = mont_prefix_ready();
    if (e != cudaSuccess) return (int)e;
    k_mont_prefix<<<(unsigned)rows, 32 << warps_log2, (SCAN_TILE_WORDS * 4) << warps_log2,
                    (cudaStream_t)stream>>>(F, x, o, rows, n, sc, warps_log2, lanes_log2);
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

// consts: 24 words, the integers endo R^2, R^2 and R^3 mod p (8 each).
int pst_endo_inv(const uint32_t *fp, const uint32_t *consts, const int32_t *bits, uint32_t *ou,
                 uint32_t *oinv, void *stream) {
    const FieldParams F = pst_field_params(fp);
    if (!pst_pasta_shape(F)) return (int)cudaErrorInvalidValue;
    EndoConsts k;
    std::memcpy(k.endo_r2.v, consts, sizeof(k.endo_r2.v));
    std::memcpy(k.r2.v, consts + PST_NL, sizeof(k.r2.v));
    std::memcpy(k.r3.v, consts + 2 * PST_NL, sizeof(k.r3.v));
    k_endo_inv<<<1, 1, 0, (cudaStream_t)stream>>>(F, k, bits, ou, oinv);
    return (int)cudaGetLastError();
}

int pst_product_chain(const uint32_t *fp, int kind, const uint32_t *x, int steps, uint32_t *o,
                      void *stream) {
    const FieldParams F = pst_field_params(fp);
    if (!pst_pasta_shape(F) || kind < 0 || kind > 4) return (int)cudaErrorInvalidValue;
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

// Registers, local (stack) bytes, static and dynamic shared memory of K12's,
// K9's and K5's kernels: k_prod_parts<false> (which 0), k_prod_parts<true>
// (1), k_prod_lanes (2), k_lin_parts<false> (3), k_lin_parts<true> (4),
// k_lin_lanes (5), k_lin_combine (6), k_mont_prefix (7).
int pst_scan_attrs(int which, int *out) {
    const void *fns[] = {(const void *)k_prod_parts<false>, (const void *)k_prod_parts<true>,
                         (const void *)k_prod_lanes,        (const void *)k_lin_parts<false>,
                         (const void *)k_lin_parts<true>,   (const void *)k_lin_lanes,
                         (const void *)k_lin_combine,       (const void *)k_mont_prefix};
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
