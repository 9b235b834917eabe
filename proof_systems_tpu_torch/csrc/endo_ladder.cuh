// The IPA fold step's endo ladder for one point: [u] P for the 128-bit
// scalar challenge u, as ScalarChallenge.to_field's (a, b) recurrence lifted
// to points (proof_systems_tpu/poly_commitment/ipa.py:554-574, the
// fori_loop of K2 jacobian_add and K3 jacobian_double):
//
//     acc = dbl(P + phi(P))
//     for j = 63 .. 0:  acc = dbl(acc) + (bit[2j+1] ? phi(x) : x, bit[2j] ? y : -y, z)
//
// with phi(x, y, z) = (endo_q * x, y, z). The formulas are field.cuh's
// inlined ec_double_inl and ec_add_inl, in the loop's order, so the result
// is the loop's Jacobian point limb for limb.
//
// Kept apart from the kernel so that the host harness
// (tests/cuda_host/ladder_host.cpp) compiles it with g++.

#pragma once

#include "field.cuh"

// p: (x, y, z) with z in {0, R}; endo_q in Montgomery form; bits: the 128
// challenge bits, least significant first, one a word (0 or 1), the same
// for every thread.
__device__ __forceinline__ Jac endo_ladder_point(const FieldParams &F, const Jac &p,
                                                 const Fe &endo_q, const uint32_t *bits) {
    const Fe phix = fe_mul(F, p.x, endo_q);
    const Fe negy = fe_sub(F, fe_zero(), p.y);
    Jac acc = ec_double_inl(F, ec_add_inl(F, p, Jac{phix, p.y, p.z}));
#pragma unroll 1
    for (int j = 63; j >= 0; --j) {
        Jac q;
        q.x = bits[2 * j + 1] ? phix : p.x;
        q.y = bits[2 * j] ? p.y : negy;
        q.z = p.z;
        acc = ec_add_inl(F, ec_double_inl(F, acc), q);
    }
    return acc;
}
