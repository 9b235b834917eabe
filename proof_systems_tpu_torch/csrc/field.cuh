// Shared 256-bit Montgomery and Jacobian core for the port's CUDA kernels.
//
// Replaces the in-kernel limb arithmetic of the TPU kernels
// (proof_systems_tpu/ops/pallas_field.py: _kv_mul_redc, _kv_add, _kv_sub,
// _kv_ec_double, _kv_ec_madd, _kv_ec_add). The TPU held 16 limbs of 16 bits
// in uint32 lanes because its vector unit has no 32x32->64 multiply; here a
// field element is 8 limbs of 32 bits and the product uses 64-bit integer
// multiplies (IMAD.WIDE), CIOS Montgomery with R = 2^256. The integers are
// the same, so results agree limb for limb with the JAX package after the
// 16-bit/32-bit regrouping.
//
// Tensor layout seen by every kernel: limb-major (8, ...) uint32, so limb l
// of element i lives at base[l * stride + i] and neighbouring threads read
// neighbouring words.
//
// The field (p, -p^-1 mod 2^32, R mod p) is a kernel argument, so one build
// serves Fp (the NTT) and Fq (Vesta's base field, all curve kernels).
//
// Bound: the curve kernels are integer-multiply bound (an 8x8-limb CIOS
// product is 128 IMAD.WIDE and 8 IMUL); the elementwise field kernels are near the
// memory bound at large N. An EC add with 8-limb coordinates needs well over
// 100 live registers per thread. The doubling and the complete add come
// inlined (ec_double_inl, ec_add_inl) and as __noinline__ wrappers (ec_double,
// ec_add); the results are the same limbs either way. The wrappers are static:
// each translation unit that includes this header keeps its own copy, and
// the units link into one library (ops/kernels.py).

#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#define PST_NL 8

struct FieldParams {
    uint32_t p[PST_NL];
    uint32_t pinv;            // -p^{-1} mod 2^32
    uint32_t one[PST_NL];     // R mod p: one in Montgomery form
};

// The wrapper passes p, pinv and R mod p as 17 host words (ops/kernels.py).
static inline FieldParams pst_field_params(const uint32_t *words) {
    FieldParams f;
    std::memcpy(f.p, words, sizeof(f.p));
    f.pinv = words[PST_NL];
    std::memcpy(f.one, words + PST_NL + 1, sizeof(f.one));
    return f;
}

struct Fe {
    uint32_t v[PST_NL];
};

struct Jac {
    Fe x, y, z;  // Montgomery coordinates; z == 0 marks infinity
};

__device__ __forceinline__ Fe fe_load(const uint32_t *__restrict__ base, int64_t stride,
                                      int64_t i) {
    Fe r;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) r.v[l] = base[l * stride + i];
    return r;
}

__device__ __forceinline__ void fe_store(uint32_t *__restrict__ base, int64_t stride,
                                         int64_t i, const Fe &a) {
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) base[l * stride + i] = a.v[l];
}

__device__ __forceinline__ Fe fe_zero() {
    Fe r;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) r.v[l] = 0;
    return r;
}

__device__ __forceinline__ Fe fe_one(const FieldParams &F) {
    Fe r;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) r.v[l] = F.one[l];
    return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe &a) {
    uint32_t acc = 0;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) acc |= a.v[l];
    return acc == 0;
}

// r = a - b over 256 bits; returns the borrow out (0 or 1).
__device__ __forceinline__ uint32_t fe_sub_raw(Fe &r, const Fe &a, const uint32_t *b) {
    uint32_t borrow = 0;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) {
        uint64_t d = (uint64_t)a.v[l] - b[l] - borrow;
        r.v[l] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
    }
    return borrow;
}

// (a + b) mod p, canonical in and out.
__device__ __forceinline__ Fe fe_add(const FieldParams &F, const Fe &a, const Fe &b) {
    Fe s;
    uint32_t carry = 0;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) {
        uint64_t t = (uint64_t)a.v[l] + b.v[l] + carry;
        s.v[l] = (uint32_t)t;
        carry = (uint32_t)(t >> 32);
    }
    Fe d;
    uint32_t borrow = fe_sub_raw(d, s, F.p);
    return (carry || !borrow) ? d : s;
}

// (a - b) mod p, canonical in and out.
__device__ __forceinline__ Fe fe_sub(const FieldParams &F, const Fe &a, const Fe &b) {
    Fe d;
    uint32_t borrow = fe_sub_raw(d, a, b.v);
    if (!borrow) return d;
    Fe s;
    uint32_t carry = 0;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) {
        uint64_t t = (uint64_t)d.v[l] + F.p[l] + carry;
        s.v[l] = (uint32_t)t;
        carry = (uint32_t)(t >> 32);
    }
    return s;
}

// CIOS Montgomery product a*b*R^-1 mod p, canonical in and out. Each
// a_j*b_i + t_j + carry fits 64 bits; t needs NL + 2 words.
__device__ __forceinline__ Fe fe_mul(const FieldParams &F, const Fe &a, const Fe &b) {
    uint32_t t[PST_NL + 2];
#pragma unroll
    for (int k = 0; k < PST_NL + 2; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < PST_NL; ++i) {
        uint64_t carry = 0;
#pragma unroll
        for (int j = 0; j < PST_NL; ++j) {
            uint64_t cur = (uint64_t)a.v[j] * b.v[i] + t[j] + carry;
            t[j] = (uint32_t)cur;
            carry = cur >> 32;
        }
        uint64_t s = (uint64_t)t[PST_NL] + carry;
        t[PST_NL] = (uint32_t)s;
        t[PST_NL + 1] = (uint32_t)(s >> 32);
        uint32_t m = t[0] * F.pinv;
        uint64_t cur = (uint64_t)m * F.p[0] + t[0];
        carry = cur >> 32;
#pragma unroll
        for (int j = 1; j < PST_NL; ++j) {
            cur = (uint64_t)m * F.p[j] + t[j] + carry;
            t[j - 1] = (uint32_t)cur;
            carry = cur >> 32;
        }
        s = (uint64_t)t[PST_NL] + carry;
        t[PST_NL - 1] = (uint32_t)s;
        t[PST_NL] = t[PST_NL + 1] + (uint32_t)(s >> 32);
    }
    Fe r, d;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) r.v[l] = t[l];
    uint32_t borrow = fe_sub_raw(d, r, F.p);
    return (t[PST_NL] != 0 || !borrow) ? d : r;
}

// dbl-2009-l for a = 0, the formula of _kv_ec_double (no infinity case
// needed: z = 0 gives z3 = 2*y*z = 0). Inlined where a kernel calls it
// directly (K2, K3, the endo ladder, K7's combine): no call and no stack
// frame; ec_double is its out-of-line wrapper (K6 and ec_madd's fallback).
__device__ __forceinline__ Jac ec_double_inl(const FieldParams &F, const Jac &p) {
    Fe a = fe_mul(F, p.x, p.x);
    Fe b = fe_mul(F, p.y, p.y);
    Fe c = fe_mul(F, b, b);
    Fe xb = fe_add(F, p.x, b);
    Fe d = fe_sub(F, fe_sub(F, fe_mul(F, xb, xb), a), c);
    d = fe_add(F, d, d);
    Fe e = fe_add(F, fe_add(F, a, a), a);
    Fe f = fe_mul(F, e, e);
    Jac r;
    r.x = fe_sub(F, f, fe_add(F, d, d));
    Fe c8 = fe_add(F, c, c);
    c8 = fe_add(F, c8, c8);
    c8 = fe_add(F, c8, c8);
    r.y = fe_sub(F, fe_mul(F, e, fe_sub(F, d, r.x)), c8);
    Fe yz = fe_mul(F, p.y, p.z);
    r.z = fe_add(F, yz, yz);
    return r;
}

static __device__ __noinline__ Jac ec_double(const FieldParams &F, const Jac &p) {
    return ec_double_inl(F, p);
}

// Complete Jacobian addition: add-2007-bl with the doubling, negation and
// infinity fallbacks of _kv_ec_add, applied in the same order, so the
// result matches the JAX package limb for limb. The doubling fallback runs
// inlined (ec_add_inl, for K2, the endo ladder and K7's combine) or through
// the out-of-line ec_double (ec_add, the out-of-line wrapper that K6 calls,
// one copy of each formula a kernel at the cost of a call and its stack
// frame).
template <bool INLINE>
__device__ __forceinline__ Jac ec_add_body(const FieldParams &F, const Jac &p, const Jac &q) {
    bool p_inf = fe_is_zero(p.z);
    bool q_inf = fe_is_zero(q.z);
    Fe z1z1 = fe_mul(F, p.z, p.z);
    Fe z2z2 = fe_mul(F, q.z, q.z);
    Fe u1 = fe_mul(F, p.x, z2z2);
    Fe u2 = fe_mul(F, q.x, z1z1);
    Fe s1 = fe_mul(F, p.y, fe_mul(F, q.z, z2z2));
    Fe s2 = fe_mul(F, q.y, fe_mul(F, p.z, z1z1));
    Fe h = fe_sub(F, u2, u1);
    Fe rr = fe_sub(F, s2, s1);
    Fe r2 = fe_add(F, rr, rr);
    bool h_zero = fe_is_zero(h);
    bool r_zero = fe_is_zero(r2);
    Fe h2 = fe_add(F, h, h);
    Fe i = fe_mul(F, h2, h2);
    Fe j = fe_mul(F, h, i);
    Fe v = fe_mul(F, u1, i);
    Jac out;
    out.x = fe_sub(F, fe_sub(F, fe_mul(F, r2, r2), j), fe_add(F, v, v));
    Fe s1j = fe_mul(F, s1, j);
    out.y = fe_sub(F, fe_mul(F, r2, fe_sub(F, v, out.x)), fe_add(F, s1j, s1j));
    Fe zs = fe_add(F, p.z, q.z);
    out.z = fe_mul(F, fe_sub(F, fe_sub(F, fe_mul(F, zs, zs), z1z1), z2z2), h);
    if (h_zero && r_zero) {
        if constexpr (INLINE) out = ec_double_inl(F, p);
        else out = ec_double(F, p);
    }
    if (h_zero && !r_zero && !p_inf) out.z = fe_zero();
    if (p_inf) out = q;
    if (q_inf) out = p;
    return out;
}

__device__ __forceinline__ Jac ec_add_inl(const FieldParams &F, const Jac &p, const Jac &q) {
    return ec_add_body<true>(F, p, q);
}

static __device__ __noinline__ Jac ec_add(const FieldParams &F, const Jac &p, const Jac &q) {
    return ec_add_body<false>(F, p, q);
}

// Mixed addition, q affine-encoded (z in {0, R}): madd-2007-bl with the
// fallbacks of _kv_ec_madd (the doubling fallback doubles q).
static __device__ __noinline__ Jac ec_madd(const FieldParams &F, const Jac &p, const Jac &q) {
    bool p_inf = fe_is_zero(p.z);
    bool q_inf = fe_is_zero(q.z);
    Fe z1z1 = fe_mul(F, p.z, p.z);
    Fe u2 = fe_mul(F, q.x, z1z1);
    Fe s2 = fe_mul(F, q.y, fe_mul(F, p.z, z1z1));
    Fe h = fe_sub(F, u2, p.x);
    Fe rr = fe_sub(F, s2, p.y);
    Fe r2 = fe_add(F, rr, rr);
    bool h_zero = fe_is_zero(h);
    bool r_zero = fe_is_zero(r2);
    Fe h2 = fe_add(F, h, h);
    Fe i = fe_mul(F, h2, h2);
    Fe j = fe_mul(F, h, i);
    Fe v = fe_mul(F, p.x, i);
    Jac out;
    out.x = fe_sub(F, fe_sub(F, fe_mul(F, r2, r2), j), fe_add(F, v, v));
    Fe s1j = fe_mul(F, p.y, j);
    out.y = fe_sub(F, fe_mul(F, r2, fe_sub(F, v, out.x)), fe_add(F, s1j, s1j));
    out.z = fe_mul(F, fe_add(F, p.z, p.z), h);
    if (h_zero && r_zero) out = ec_double(F, q);
    if (h_zero && !r_zero && !p_inf) out.z = fe_zero();
    if (p_inf) out = q;
    if (q_inf) out = p;
    return out;
}

__device__ __forceinline__ Jac jac_load(const uint32_t *x, const uint32_t *y,
                                        const uint32_t *z, int64_t stride, int64_t i) {
    Jac r;
    r.x = fe_load(x, stride, i);
    r.y = fe_load(y, stride, i);
    r.z = fe_load(z, stride, i);
    return r;
}

__device__ __forceinline__ void jac_store(uint32_t *x, uint32_t *y, uint32_t *z,
                                          int64_t stride, int64_t i, const Jac &a) {
    fe_store(x, stride, i, a.x);
    fe_store(y, stride, i, a.y);
    fe_store(z, stride, i, a.z);
}

__device__ __forceinline__ Jac jac_identity() {
    Jac r;
    r.x = fe_zero();
    r.y = fe_zero();
    r.z = fe_zero();
    return r;
}

// Lanes of a row scan: a row of n positions is cut into PST_LANES lane
// chunks of cp = ceil(n / PST_LANES) contiguous positions; the exclusive
// scan of the PST_LANES lane totals runs in one block of PST_LANES threads
// (the field scans' kernels, and K6's k_ec_lane_offsets, which K7 also
// runs).
#define PST_LANES 128
