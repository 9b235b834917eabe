// A Montgomery product for the Pasta moduli with a short dependent chain,
// and the chains that run on it: K4's exponentiation (fe_pow_lat) and K10's
// two Poseidon permutations (sponge_squeeze2_lanes); K5's scan operator
// (ProdLatOp) and K11 (inv_field.cuh) run it too.
//
// Both Pasta primes have word 0 = 1, words 4-6 = 0 and word 7 = 0x40000000
// (32-bit words, little-endian), so -p^-1 mod 2^32 = 0xFFFFFFFF: a
// reduction step's factor is m = -t_i, and its product with p touches words
// 1-3 and 7 only (word 7's is a shift). Words 1-3 stay run-time FieldParams,
// so one build serves Fp and Fq; pst_pasta_shape checks the rest on the
// host, and the launchers refuse another field.
//
// What bounds a chain on this card, as measured: the instructions one warp
// issues, one at a time, more than the dependent carries. field.cuh's CIOS
// fe_mul (any field) takes 0.62-0.70 us a step of chip_smoke.py's
// one-thread chain on an H100 (700 W). The product here puts the 64
// partial products (36 for a square) into 64-bit column sums that do not
// wait for one another, then runs the 8 reduction steps on the columns (3
// multiplies a step), one carry pass and one conditional subtraction:
// 0.44-0.45 us a product, 0.31-0.33 a square. fe_dot3_lat is REDC(a0 b0 +
// a1 b1 + a2 b2) in one reduction (3p^2 < p 2^256, so one conditional
// subtraction gives the canonical result); K10 runs a row's three products
// on three lanes instead and reduces their summed columns once. Every
// result is canonical and equal to fe_mul's limb for limb. Specialised
// CIOS (rolled or not), CIOS in PTX carry chains, carry-save rows and
// 16-bit halves of b ran slower (PERF.md section 6).
//
// The code is C++ that g++ also compiles (tests/cuda_host/chain_host.cpp).

#pragma once

#include "field.cuh"

#define PST_P7 0x40000000u

// Whether F has the Pasta shape this header relies on.
static inline bool pst_pasta_shape(const FieldParams &F) {
    return F.p[0] == 1u && F.p[4] == 0u && F.p[5] == 0u && F.p[6] == 0u && F.p[7] == PST_P7 &&
           F.pinv == 0xFFFFFFFFu;
}

// r - p if r >= p, else r (r < 2p < 2^256).
__device__ __forceinline__ Fe fe_reduce_once(const FieldParams &F, const Fe &r) {
    Fe d;
    const uint32_t borrow = fe_sub_raw(d, r, F.p);
    return borrow ? r : d;
}

// ---------------------------------------------------------------------------
// The product: column sums, then the reduction
// ---------------------------------------------------------------------------

// c += a * b as 64-bit sums of 32-bit halves: the low half of a_i b_j in
// column i + j, the high half in i + j + 1.
__device__ __forceinline__ void cols_mac(uint64_t (&c)[16], const Fe &a, const Fe &b) {
#pragma unroll
    for (int i = 0; i < PST_NL; ++i)
#pragma unroll
        for (int j = 0; j < PST_NL; ++j) {
            const uint64_t pr = (uint64_t)a.v[i] * b.v[j];
            c[i + j] += (uint32_t)pr;
            c[i + j + 1] += pr >> 32;
        }
}

// Montgomery reduction of sum_k c[k] 2^(32k) < p 2^256 (each c[k] < 2^40):
// the canonical value * 2^-256 mod p. Step i adds m p 2^(32i) with m = -w,
// w the low word of column i: w + m is 0 or 2^32, so the step carries
// (w != 0) and the high part of the column up, and adds m p_1, m p_2, m p_3
// and m 2^30 (word 7) in halves.
__device__ __forceinline__ Fe redc_cols(const FieldParams &F, uint64_t (&c)[16]) {
    const uint32_t p1 = F.p[1], p2 = F.p[2], p3 = F.p[3];
#pragma unroll
    for (int i = 0; i < PST_NL; ++i) {
        const uint32_t w = (uint32_t)c[i];
        const uint32_t m = 0u - w;
        const uint64_t q1 = (uint64_t)m * p1;
        const uint64_t q2 = (uint64_t)m * p2;
        const uint64_t q3 = (uint64_t)m * p3;
        c[i + 1] += (c[i] >> 32) + (uint64_t)(w != 0u) + (uint32_t)q1;
        c[i + 2] += (q1 >> 32) + (uint32_t)q2;
        c[i + 3] += (q2 >> 32) + (uint32_t)q3;
        c[i + 4] += q3 >> 32;
        c[i + 7] += (uint32_t)(m << 30);
        c[i + 8] += m >> 2;
    }
    Fe r;
    uint64_t carry = 0;
#pragma unroll
    for (int k = 0; k < PST_NL; ++k) {
        const uint64_t s = c[PST_NL + k] + carry;
        r.v[k] = (uint32_t)s;
        carry = s >> 32;
    }
    return fe_reduce_once(F, r);
}

__device__ __forceinline__ Fe fe_mul_lat(const FieldParams &F, const Fe &a, const Fe &b) {
    uint64_t c[16] = {};
    cols_mac(c, a, b);
    return redc_cols(F, c);
}

// The square shares its cross products: 28 of them doubled, then the 8
// diagonal ones.
__device__ __forceinline__ Fe fe_sqr_lat(const FieldParams &F, const Fe &a) {
    uint64_t c[16] = {};
#pragma unroll
    for (int i = 0; i < PST_NL; ++i)
#pragma unroll
        for (int j = i + 1; j < PST_NL; ++j) {
            const uint64_t pr = (uint64_t)a.v[i] * a.v[j];
            c[i + j] += (uint32_t)pr;
            c[i + j + 1] += pr >> 32;
        }
#pragma unroll
    for (int k = 0; k < 16; ++k) c[k] += c[k];
#pragma unroll
    for (int i = 0; i < PST_NL; ++i) {
        const uint64_t pr = (uint64_t)a.v[i] * a.v[i];
        c[2 * i] += (uint32_t)pr;
        c[2 * i + 1] += pr >> 32;
    }
    return redc_cols(F, c);
}

__device__ __forceinline__ Fe fe_dot3_lat(const FieldParams &F, const Fe &a0, const Fe &b0,
                                          const Fe &a1, const Fe &b1, const Fe &a2,
                                          const Fe &b2) {
    uint64_t c[16] = {};
    cols_mac(c, a0, b0);
    cols_mac(c, a1, b1);
    cols_mac(c, a2, b2);
    return redc_cols(F, c);
}

// K5's operator on this product (scan_field.cuh's ops): positions past n
// hold one.
struct ProdLatOp {
    FieldParams F;
    __device__ Fe identity() const { return fe_one(F); }
    __device__ Fe pad() const { return fe_one(F); }
    __device__ Fe step(const Fe &carry, const Fe &x) const { return fe_mul_lat(F, carry, x); }
    __device__ Fe team(int, const Fe &lo, const Fe &hi) const { return fe_mul_lat(F, lo, hi); }
};

// ---------------------------------------------------------------------------
// K4: a^e
// ---------------------------------------------------------------------------

// Exponent as nd 4-bit digits, most significant first (at most 256 bits),
// left-aligned in w: digit k at bits 255 - 4k .. 252 - 4k. The chain reads
// the top nibble and shifts w, so no digit is read at a run-time index.
struct PowDigits {
    uint32_t w[PST_NL];
    int32_t nd;
};

// Packs the digits; false if there are more than 64 or one is not a nibble.
static inline bool pst_pow_digits(PowDigits &e, const uint8_t *digits, int nd) {
    if (nd < 0 || nd > 64) return false;
    std::memset(&e, 0, sizeof(e));
    for (int k = 0; k < nd; ++k) {
        if (digits[k] > 15) return false;
        const int bit = 252 - 4 * k;
        e.w[bit / 32] |= (uint32_t)digits[k] << (bit % 32);
    }
    e.nd = nd;
    return true;
}

// The top digit of w, then w <<= 4.
__device__ __forceinline__ uint32_t pow_next_digit(PowDigits &e) {
    const uint32_t d = e.w[PST_NL - 1] >> 28;
#pragma unroll
    for (int l = PST_NL - 1; l > 0; --l) e.w[l] = (e.w[l] << 4) | (e.w[l - 1] >> 28);
    e.w[0] <<= 4;
    return d;
}

// a^e with 4-bit windows, most significant first (pallas_field.py:497-520).
// The 16-entry table (tab[0] = one) is a tree, tab[2k] = tab[k]^2 and
// tab[2k+1] = tab[2k] a (depth 6, its products independent), kept in shared
// memory: word l of entry k at tab[(8k + l) * stride], so that the threads
// of a warp, given consecutive tab and stride = blockDim, read consecutive
// words. The chain starts from tab[d_0], then runs 4 squarings and one
// product a digit.
__device__ __forceinline__ Fe fe_pow_lat(const FieldParams &F, const Fe &a, PowDigits e,
                                         uint32_t *tab, int stride) {
    auto put = [&](int k, const Fe &v) {
#pragma unroll
        for (int l = 0; l < PST_NL; ++l) tab[(PST_NL * k + l) * stride] = v.v[l];
    };
    auto get = [&](uint32_t k) {
        Fe v;
#pragma unroll
        for (int l = 0; l < PST_NL; ++l) v.v[l] = tab[(PST_NL * k + l) * stride];
        return v;
    };
    const Fe one = fe_one(F);
    Fe low[8];  // entries 0-7 stay in registers for the tree
    low[0] = one;
    low[1] = a;
    put(0, one);
    put(1, a);
#pragma unroll
    for (int k = 1; k < 8; ++k) {
        const Fe ev = fe_sqr_lat(F, low[k]);
        const Fe od = fe_mul_lat(F, ev, a);
        put(2 * k, ev);
        put(2 * k + 1, od);
        if (2 * k < 8) low[2 * k] = ev;
        if (2 * k + 1 < 8) low[2 * k + 1] = od;
    }
    if (e.nd == 0) return one;
    Fe acc = get(pow_next_digit(e));
#pragma unroll 1
    for (int k = 1; k < e.nd; ++k) {
        const Fe m = get(pow_next_digit(e));
#pragma unroll
        for (int s = 0; s < 4; ++s) acc = fe_sqr_lat(F, acc);
        acc = fe_mul_lat(F, acc, m);
    }
    return acc;
}

// ---------------------------------------------------------------------------
// K10: absorb (x_L, y_L), permute, absorb (x_R, y_R), permute, REDC(state[0])
// ---------------------------------------------------------------------------

// consts (8, 3 * nrounds + 9): rc[r][j] in column 3r + j, then mds[i][j] in
// column 3 * nrounds + 3i + j.

__device__ __forceinline__ Fe shfl_fe(const Fe &a, int src) {
    Fe r;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) r.v[l] = __shfl_sync(0xffffffffu, a.v[l], src);
    return r;
}

__device__ __forceinline__ uint64_t shfl_u64(uint64_t v, int src) {
    const uint32_t lo = __shfl_sync(0xffffffffu, (uint32_t)v, src);
    const uint32_t hi = __shfl_sync(0xffffffffu, (uint32_t)(v >> 32), src);
    return ((uint64_t)hi << 32) | lo;
}

// One warp. Lane 3i + j takes row i and column j of the MDS (lanes 9-31
// mirror lane 8 and store nothing), and every lane holds s_j. A round runs
// x^7 in three product levels, with x^4 and x^3 on different lanes: x^2;
// one product, x^2 * x^2 = x^4 on row 0's lanes and x^2 * s = x^3 on row
// 1's; both gathered by shuffles into x^7 = x^4 * x^3 on every lane. Then
// the lane's MDS entry times x^7_j as column sums, summed over the row's
// three lanes by shuffles and reduced once on lane 3i (a dot3 whose three
// products run on three lanes), plus the round constant, loaded a round
// ahead; s_j comes back from lane 3j. No shared memory, no barrier.
__device__ __forceinline__ void sponge_squeeze2_lanes(const FieldParams &F, int lane,
                                            const uint32_t *__restrict__ state,
                                            const uint32_t *__restrict__ xs,
                                            const uint32_t *__restrict__ ys,
                                            const uint32_t *__restrict__ consts, int nrounds,
                                            uint32_t *__restrict__ ost,
                                            uint32_t *__restrict__ ochal) {
    const int L = lane < 9 ? lane : 8;
    const int i = L / 3, j = L % 3;
    const int64_t cstride = 3 * (int64_t)nrounds + 9;
    const Fe mds = fe_load(consts, cstride, 3 * nrounds + 3 * i + j);
    Fe s = fe_load(state, 3, j);
    for (int k = 0; k < 2; ++k) {
        if (j == 0) s = fe_add(F, s, fe_load(xs, 2, k));
        if (j == 1) s = fe_add(F, s, fe_load(ys, 2, k));
        Fe rc = fe_load(consts, cstride, i);
#pragma unroll 1
        for (int r = 0; r < nrounds; ++r) {
            const Fe rc_next = fe_load(consts, cstride, 3 * (r + 1 < nrounds ? r + 1 : r) + i);
            const Fe x2 = fe_sqr_lat(F, s);
            Fe v;  // x^2 on row 0, s on the others: x^4 and x^3
#pragma unroll
            for (int l = 0; l < PST_NL; ++l) v.v[l] = i == 0 ? x2.v[l] : s.v[l];
            const Fe u = fe_mul_lat(F, x2, v);
            const Fe x7 = fe_mul_lat(F, shfl_fe(u, j), shfl_fe(u, 3 + j));
            uint64_t c[16] = {};
            cols_mac(c, mds, x7);
#pragma unroll
            for (int q = 0; q < 16; ++q)
                c[q] += shfl_u64(c[q], (L + 1) % 32) + shfl_u64(c[q], (L + 2) % 32);
            const Fe row = fe_add(F, redc_cols(F, c), rc);  // s'_i on lane 3i
            s = shfl_fe(row, 3 * j);
            rc = rc_next;
        }
    }
    if (lane < 3) fe_store(ost, 3, j, s);
    if (lane == 0) {
        Fe one = fe_zero();
        one.v[0] = 1;  // the product with plain 1 is REDC
        fe_store(ochal, 1, 0, fe_mul_lat(F, s, one));
    }
}
