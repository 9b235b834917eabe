// K8 combine_windows for Hopper: the Pippenger window recombination
// sum_w 2^(cw) win_w of each MSM column, a Horner chain from the top window
// (c doublings, then one complete add, per window: the order of
// proof_systems_tpu/ops/pallas_field.py:596-607, combine_windows_fused l.560).
//
// This header is K8's own curve formulas, all of them inlined and split into
// levels. It calls none of field.cuh's curve formulas (ec_double_inl and
// ec_add_inl, which K2, K3 and the endo ladder run, or their __noinline__
// wrappers, which K6 and K7 call); it uses field.cuh's forceinline fe_mul,
// fe_add and fe_sub.
//
// What bounds K8 on this card: not the integer rate (a call is W * (7c + 16)
// products a column, microseconds of the card's multiply-add rate) but the
// latency of one dependent chain. On the main path b = 1 or 2 columns, so a
// call is one or two chains of 2,100-2,400 Montgomery products, each waiting
// for the one before it. The old kernel ran a chain in one thread through
// the __noinline__ formulas (a 264-byte stack frame) at about 1.1 us a
// product. What this design does about it:
//   - one warp a column, so a chain has 32 lanes; columns go over blocks of
//     K8_WARPS warps;
//   - the independent products of a formula run side by side on
//     K8_GROUPS = 4 lanes, a level at a time: dbl-2009-l's 7 products in 3
//     levels, add-2007-bl's 16 in 5, so a Horner step at c = 7 is 26 levels
//     deep instead of 65 products. Every lane keeps the whole state, so
//     adds, subtractions and the fallbacks' branches run the same in every
//     lane and nothing diverges; each level's products come back to every
//     lane through warp shuffles (the other lanes of the warp repeat the
//     first four);
//   - each product is one lane's CIOS fe_mul;
//   - everything is inlined, with one doubling site and one add site in the
//     loop (the add's doubling fallback loops back to the doubling site);
//     registers are capped at 255 (a block of 4 warps), and no stack is used;
//   - the chain starts from the top window: doubling the identity (0, 0, 0)
//     gives it again, and identity + q is q (or the identity if q is
//     infinite), so the first c doublings are skipped.
// Every product, add and subtraction returns the canonical value, and the
// formulas are field.cuh's in their order with the complete add's fallbacks
// in the same order, so K8 gives the limbs of the plain version
// (ops/kernels.py combine_windows_plain). On the H100 this is about a
// microsecond a level (PERF.md). Splitting an element's limbs over 4 or 8
// lanes (column-parallel products, carries resolved by a __ballot_sync
// lookahead) or running a level on fewer lanes was slower at every
// main-path shape (PERF.md).

#pragma once

#include "field.cuh"

#define K8_WARPS 4   // columns (one a warp) of a block
#define K8_GROUPS 4  // lanes that share the products of a level
#define K8_FULL 0xffffffffu

// Lane j's copy of v (j in [0, K8_GROUPS)), in every lane.
__device__ __forceinline__ Fe k8_from_lane(const Fe &v, int j) {
    Fe r;
#pragma unroll
    for (int t = 0; t < PST_NL; ++t) r.v[t] = __shfl_sync(K8_FULL, v.v[t], j, K8_GROUPS);
    return r;
}

// out[j] = x[j] * y[j] for j < N: lane g computes products g, g + 4, ...
// and every lane receives all N. The operands are picked with bit masks:
// a chain of selects on a runtime index may be compiled as an indexed local
// array.
template <int N>
__device__ __forceinline__ void k8_level(const FieldParams &F, int g, Fe (&out)[N],
                                         const Fe (&x)[N], const Fe (&y)[N]) {
#pragma unroll
    for (int r0 = 0; r0 < N; r0 += K8_GROUPS) {
        Fe a = x[r0], b = y[r0];
#pragma unroll
        for (int j = 1; j < K8_GROUPS && r0 + j < N; ++j) {
            const uint32_t take = 0u - (uint32_t)(g == j);
#pragma unroll
            for (int t = 0; t < PST_NL; ++t) {
                a.v[t] = (a.v[t] & ~take) | (x[r0 + j].v[t] & take);
                b.v[t] = (b.v[t] & ~take) | (y[r0 + j].v[t] & take);
            }
        }
        const Fe p = fe_mul(F, a, b);
#pragma unroll
        for (int j = 0; j < K8_GROUPS && r0 + j < N; ++j) out[r0 + j] = k8_from_lane(p, j);
    }
}

// dbl-2009-l (a = 0), ec_double of field.cuh by levels:
// {X^2, Y^2, YZ} -> {B^2, (X + B)^2, E^2} -> E (D - X3).
__device__ __forceinline__ Jac k8_double(const FieldParams &F, int g, const Jac &p) {
    Fe l1[3];
    {
        const Fe x[3] = {p.x, p.y, p.y}, y[3] = {p.x, p.y, p.z};
        k8_level<3>(F, g, l1, x, y);
    }
    const Fe &a = l1[0], &b = l1[1], &yz = l1[2];
    const Fe xb = fe_add(F, p.x, b);
    const Fe e = fe_add(F, fe_add(F, a, a), a);
    Fe l2[3];
    {
        const Fe x[3] = {b, xb, e};
        k8_level<3>(F, g, l2, x, x);
    }
    const Fe &cc = l2[0], &xb2 = l2[1], &f = l2[2];
    Fe d = fe_sub(F, fe_sub(F, xb2, a), cc);
    d = fe_add(F, d, d);
    Jac r;
    r.x = fe_sub(F, f, fe_add(F, d, d));
    Fe c8 = fe_add(F, cc, cc);
    c8 = fe_add(F, c8, c8);
    c8 = fe_add(F, c8, c8);
    r.y = fe_sub(F, fe_mul(F, e, fe_sub(F, d, r.x)), c8);
    r.z = fe_add(F, yz, yz);
    return r;
}

// Complete add-2007-bl, ec_add of field.cuh by levels:
// {Z1^2, Z2^2, (Z1 + Z2)^2} -> {U1, U2, Z2^3, Z1^3} -> {S1, S2, I, Z3}
// -> {J, V, r^2} -> {S1 J, r (V - X3)}. Its fallbacks in field.cuh's order;
// returns true, leaving out unset, where the doubling fallback applies (the
// caller then doubles p).
__device__ __forceinline__ bool k8_add_pts(const FieldParams &F, int g, const Jac &p,
                                           const Jac &q, Jac &out) {
    const bool p_inf = fe_is_zero(p.z), q_inf = fe_is_zero(q.z);
    if (q_inf) {  // applied last in field.cuh, so it wins
        out = p;
        return false;
    }
    if (p_inf) {
        out = q;
        return false;
    }
    const Fe zs = fe_add(F, p.z, q.z);
    Fe l1[3];
    {
        const Fe x[3] = {p.z, q.z, zs};
        k8_level<3>(F, g, l1, x, x);
    }
    const Fe &z1z1 = l1[0], &z2z2 = l1[1], &zs2 = l1[2];
    Fe l2[4];
    {
        const Fe x[4] = {p.x, q.x, q.z, p.z}, y[4] = {z2z2, z1z1, z2z2, z1z1};
        k8_level<4>(F, g, l2, x, y);
    }
    const Fe &u1 = l2[0], &u2 = l2[1], &t2 = l2[2], &t1 = l2[3];
    const Fe h = fe_sub(F, u2, u1);
    const Fe h2 = fe_add(F, h, h);
    const Fe zz = fe_sub(F, fe_sub(F, zs2, z1z1), z2z2);
    Fe l3[4];
    {
        const Fe x[4] = {p.y, q.y, h2, zz}, y[4] = {t2, t1, h2, h};
        k8_level<4>(F, g, l3, x, y);
    }
    const Fe &s1 = l3[0], &s2 = l3[1], &i = l3[2], &z3 = l3[3];
    const Fe rr = fe_sub(F, s2, s1);
    const Fe r2 = fe_add(F, rr, rr);
    const bool h_zero = fe_is_zero(h), r_zero = fe_is_zero(r2);
    if (h_zero && r_zero) return true;
    Fe l4[3];
    {
        const Fe x[3] = {h, u1, r2}, y[3] = {i, i, r2};
        k8_level<3>(F, g, l4, x, y);
    }
    const Fe &j = l4[0], &v = l4[1], &r2sq = l4[2];
    out.x = fe_sub(F, fe_sub(F, r2sq, j), fe_add(F, v, v));
    Fe l5[2];
    {
        const Fe x[2] = {s1, r2}, y[2] = {j, fe_sub(F, v, out.x)};
        k8_level<2>(F, g, l5, x, y);
    }
    out.y = fe_sub(F, l5[1], fe_add(F, l5[0], l5[0]));
    out.z = h_zero ? fe_zero() : z3;  // h = 0, r != 0: P + (-P), infinity
    return false;
}

// One column's Horner chain. wx, wy, wz: (8, W, b) window sums, limb stride
// W * b; out: (8, b). Every lane of the warp calls it for column col; lane
// 0 stores.
__device__ __forceinline__ void k8_combine_column(const FieldParams &F, const uint32_t *wx,
                                                  const uint32_t *wy, const uint32_t *wz,
                                                  uint32_t *ox, uint32_t *oy, uint32_t *oz,
                                                  int64_t W, int64_t b, int c, int64_t col,
                                                  int lane) {
    const int g = lane % K8_GROUPS;
    const int64_t stride = W * b;
    // identity + win_(W-1), then the top window's c doublings of it skipped
    Jac acc = jac_load(wx, wy, wz, stride, (W - 1) * b + col);
    if (fe_is_zero(acc.z)) acc = jac_identity();
    int k = 0;
    bool redo = false;  // the add of window w took the doubling fallback
#pragma unroll 1
    for (int64_t w = W - 2; w >= 0;) {
        if (k < c || redo) {
            acc = k8_double(F, g, acc);
            if (redo) {
                redo = false;
                k = 0;
                --w;
            } else {
                ++k;
            }
        } else {
            Jac sum;
            redo = k8_add_pts(F, g, acc, jac_load(wx, wy, wz, stride, w * b + col), sum);
            if (!redo) {
                acc = sum;
                k = 0;
                --w;
            }
        }
    }
    if (lane == 0) jac_store(ox, oy, oz, b, col, acc);
}
