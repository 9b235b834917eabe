// K11 (endo_inv) on this card: ScalarChallenge.to_field in closed form, then
// an inverse by Pornin's optimized binary GCD (IACR ePrint 2020/972,
// algorithm 2) in place of the Fermat chain u^(p-2).
//
// What bounded the kernel this replaces: one thread ran 64 dependent field
// adds and subtracts, a product, then K4's chain u^(p-2), 317 dependent
// levels of chain_field.cuh's product (0.15-0.16 ms of its 0.19-0.20 on an
// H100). The TPU needed Fermat (its vector unit has no data-dependent
// control flow); one CUDA thread does not. What the design does about it:
//   - the 64 steps have a closed form. Over the bit pairs (r0, r1) =
//     (bits[2i], bits[2i+1]), i < 64, a = 2^65 + A+ - A- and b = 2^65 + B+ -
//     B-, A+ the sum of 2^i over the pairs with r1 = r0 = 1, A- over r1 = 1,
//     r0 = 0, B+ and B- the same for r1 = 0. Both lie in (2^64, 2^66), below
//     p, so the recurrence never wraps mod p, and u = a endo + b in
//     Montgomery form is REDC(a (endo R^2) + b R^2): two products summed in
//     one reduction, on host constants;
//   - the inverse of the integer x = u R runs binary GCD steps on 62-bit
//     approximations of a and b (their low 30 bits and the top 32 bits of
//     the longer one), 30 steps a batch on registers; each batch then
//     applies its 2x2 matrix of small integers (|f| + |g| <= 2^30) to the
//     8 x 32-bit a and b (exact, the sign kept apart and folded back into
//     the matrix) and to the Bezout coefficients u and v mod p, dividing by
//     2^30 through an added multiple of p (p = 1 mod 2^32). ceil((2 * 255 -
//     1) / 30) = 17 batches reach a = 0, b = 1 for every x < p < 2^255; v
//     is then x^-1 mod p, and one product by R^3 mod p gives u^-1 R, the
//     Montgomery form. 0 maps to 0 (v stays 0), as 0^(p-2) does.
// The steps and the matrices depend on the value: the inverse runs in
// variable time. That is acceptable here because u is a public
// Fiat-Shamir challenge of the IPA transcript, not a secret.
//
// No run-time index into an array and no select of a whole struct: every
// value stays in registers (0 B of local memory on sm_90a).
//
// The code is C++ that g++ also compiles (tests/cuda_host/inv_host.cpp).

#pragma once

#include "chain_field.cuh"

// Steps of a batch, and batches: 17 * 30 = 510 >= 2 * len(p) - 1 = 509.
#define INV_STEPS 30
#define INV_BATCHES 17
#define INV_LOW ((1u << INV_STEPS) - 1)

// The approximations of a and b: with n = max(len a, len b, 62), the low 30
// bits and bits [n - 32, n) above them (a and b themselves when n = 62).
__device__ __forceinline__ void gcd_approx(const Fe &a, const Fe &b, uint64_t &xa,
                                           uint64_t &xb) {
    int n = 0;  // the length of the top nonzero word's bits, from word 1 up
#pragma unroll
    for (int l = 1; l < PST_NL; ++l) {
        const uint32_t o = a.v[l] | b.v[l];
        if (o != 0u) n = 32 * l + 32 - __clz((int)o);
    }
    const int s = (n > 62 ? n : 62) - 32, q = s / 32, r = s % 32;
    uint64_t wa = 0, wb = 0;
#pragma unroll
    for (int l = 0; l < PST_NL - 1; ++l)
        if (l == q) {
            wa = ((uint64_t)a.v[l + 1] << 32) | a.v[l];
            wb = ((uint64_t)b.v[l + 1] << 32) | b.v[l];
        }
    xa = (a.v[0] & INV_LOW) | ((uint64_t)(uint32_t)(wa >> r) << INV_STEPS);
    xb = (b.v[0] & INV_LOW) | ((uint64_t)(uint32_t)(wb >> r) << INV_STEPS);
}

// r = |a f + b g| / 2^30 (exact: the batch cleared the low 30 bits), a and b
// below 2^255; returns true where a f + b g < 0.
__device__ __forceinline__ bool gcd_lin(Fe &r, const Fe &a, const Fe &b, int32_t f, int32_t g) {
    uint32_t t[PST_NL];
    int64_t acc = 0;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) {
        acc += (int64_t)a.v[l] * f + (int64_t)b.v[l] * g;
        t[l] = (uint32_t)acc;
        acc >>= 32;
    }
#pragma unroll
    for (int l = 0; l < PST_NL - 1; ++l) r.v[l] = (t[l] >> INV_STEPS) | (t[l + 1] << (32 - INV_STEPS));
    r.v[PST_NL - 1] = (t[PST_NL - 1] >> INV_STEPS) | ((uint32_t)acc << (32 - INV_STEPS));
    const bool neg = acc < 0;
    const uint32_t mask = 0u - (uint32_t)neg;
    uint32_t carry = neg;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) {
        const uint64_t s = (uint64_t)(r.v[l] ^ mask) + carry;
        r.v[l] = (uint32_t)s;
        carry = (uint32_t)(s >> 32);
    }
    return neg;
}

// (u f + v g) / 2^30 mod p, canonical, for canonical u and v: adds k p with
// k = -(u f + v g) mod 2^30 (p = 1 mod 2^32), which clears the low 30 bits;
// the quotient lies in (-p, 2p), and one add or subtraction of p ends it.
__device__ __forceinline__ Fe gcd_mod_lin(const FieldParams &F, const Fe &u, const Fe &v,
                                          int32_t f, int32_t g) {
    uint32_t t[PST_NL];
    int64_t acc = (int64_t)u.v[0] * f + (int64_t)v.v[0] * g;
    const uint32_t k = (0u - (uint32_t)acc) & INV_LOW;
    acc += (int64_t)((uint64_t)k * F.p[0]);
    t[0] = (uint32_t)acc;
    acc >>= 32;
#pragma unroll
    for (int l = 1; l < PST_NL; ++l) {
        acc += (int64_t)u.v[l] * f + (int64_t)v.v[l] * g + (int64_t)((uint64_t)k * F.p[l]);
        t[l] = (uint32_t)acc;
        acc >>= 32;
    }
    Fe r;
#pragma unroll
    for (int l = 0; l < PST_NL - 1; ++l) r.v[l] = (t[l] >> INV_STEPS) | (t[l + 1] << (32 - INV_STEPS));
    r.v[PST_NL - 1] = (t[PST_NL - 1] >> INV_STEPS) | ((uint32_t)acc << (32 - INV_STEPS));
    if (acc < 0) {  // r - 2^256 in (-p, 0): add p, dropping the carry
        uint32_t carry = 0;
#pragma unroll
        for (int l = 0; l < PST_NL; ++l) {
            const uint64_t s = (uint64_t)r.v[l] + F.p[l] + carry;
            r.v[l] = (uint32_t)s;
            carry = (uint32_t)(s >> 32);
        }
        return r;
    }
    return fe_reduce_once(F, r);
}

// x^-1 mod p for a canonical integer x (not Montgomery), 0 for x = 0; p
// odd, p = 1 mod 2^32, p < 2^255.
__device__ __forceinline__ Fe fe_inv_gcd(const FieldParams &F, const Fe &x) {
    Fe a = x, b, u = fe_zero(), v = fe_zero();
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) b.v[l] = F.p[l];
    u.v[0] = 1;
#pragma unroll 1
    for (int i = 0; i < INV_BATCHES; ++i) {
        uint64_t xa, xb;
        gcd_approx(a, b, xa, xb);
        // a = (xa f0 + xb g0) / 2^j and b = (xa f1 + xb g1) / 2^j after j
        // steps; b stays odd
        int32_t f0 = 1, g0 = 0, f1 = 0, g1 = 1;
#pragma unroll
        for (int j = 0; j < INV_STEPS; ++j) {
            if (xa & 1) {
                if (xa < xb) {  // swap, then subtract
                    const uint64_t d = xb - xa;
                    const int32_t df = f1 - f0, dg = g1 - g0;
                    xb = xa;
                    f1 = f0;
                    g1 = g0;
                    xa = d;
                    f0 = df;
                    g0 = dg;
                } else {
                    xa -= xb;
                    f0 -= f1;
                    g0 -= g1;
                }
            }
            xa >>= 1;
            f1 *= 2;
            g1 *= 2;
        }
        Fe na, nb;
        if (gcd_lin(na, a, b, f0, g0)) {
            f0 = -f0;
            g0 = -g0;
        }
        if (gcd_lin(nb, a, b, f1, g1)) {
            f1 = -f1;
            g1 = -g1;
        }
        a = na;
        b = nb;
        const Fe nu = gcd_mod_lin(F, u, v, f0, g0);
        v = gcd_mod_lin(F, u, v, f1, g1);
        u = nu;
    }
    return v;
}

// ---------------------------------------------------------------------------
// K11: one thread
// ---------------------------------------------------------------------------

// Host constants of K11, integers mod p: endo R^2, R^2 and R^3.
struct EndoConsts {
    Fe endo_r2, r2, r3;
};

// 2^65 + plus - minus (plus, minus < 2^64) as a field integer.
__device__ __forceinline__ Fe endo_term(uint64_t plus, uint64_t minus) {
    Fe r = fe_zero();
    const uint64_t d = plus - minus;
    r.v[0] = (uint32_t)d;
    r.v[1] = (uint32_t)(d >> 32);
    r.v[2] = 2u - (uint32_t)(plus < minus);
    return r;
}

// ScalarChallenge.to_field (sponge.rs:190-228) of the 128 challenge bits,
// least significant first: u = a endo + b in Montgomery form.
__device__ __forceinline__ Fe endo_u(const FieldParams &F, const EndoConsts &k,
                                     const int32_t *__restrict__ bits) {
    uint64_t ap = 0, am = 0, bp = 0, bm = 0;
#pragma unroll 8
    for (int i = 0; i < 64; ++i) {
        const bool r0 = bits[2 * i] == 1, r1 = bits[2 * i + 1] == 1;
        const uint64_t m = (uint64_t)1 << i;
        ap |= r1 && r0 ? m : 0;
        am |= r1 && !r0 ? m : 0;
        bp |= !r1 && r0 ? m : 0;
        bm |= !r1 && !r0 ? m : 0;
    }
    uint64_t c[16] = {};
    cols_mac(c, endo_term(ap, am), k.endo_r2);
    cols_mac(c, endo_term(bp, bm), k.r2);
    return redc_cols(F, c);
}

// u and u^-1, Montgomery, to ou and oinv (one element each).
__device__ __forceinline__ void endo_inv_thread(const FieldParams &F, const EndoConsts &k,
                                                const int32_t *__restrict__ bits,
                                                uint32_t *__restrict__ ou,
                                                uint32_t *__restrict__ oinv) {
    const Fe u = endo_u(F, k, bits);
    fe_store(ou, 1, 0, u);
    fe_store(oinv, 1, 0, fe_mul_lat(F, fe_inv_gcd(F, u), k.r3));
}
