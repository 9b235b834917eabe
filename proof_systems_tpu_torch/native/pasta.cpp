// Native host runtime: 256-bit Montgomery field arithmetic, the Poseidon
// permutation of the transcript sponges and a Pippenger MSM over the Pasta
// curves, loaded through ctypes (proof_systems_tpu_torch/native/__init__.py).
//
// Role: the host's sequential transcript (dozens of permutations a proof,
// and the replay of the card's IPA rounds), and the exact host reference
// that the device commitments are checked against at full width (a
// pure-Python MSM over 2^16 points takes minutes). The MSM is the same
// algorithm as arkworks' VariableBaseMSM (`msm_bigint`). The modulus, R^2
// and the sponge tables are injected at runtime, so one binary serves Fp
// and Fq of the Pasta cycle.
//
// Arithmetic: 4x64-bit limbs, CIOS Montgomery multiplication using
// __uint128_t (one pass, no final subtraction loop beyond the standard
// conditional).

#include <cstdint>
#include <cstring>
#include <cstdlib>

typedef unsigned __int128 u128;

struct Fe {
    uint64_t v[4];
};

struct FieldCtx {
    Fe p;
    Fe r2;
    uint64_t pinv;  // -p^{-1} mod 2^64
};

static inline bool geq(const Fe &a, const Fe &b) {
    for (int i = 3; i >= 0; --i) {
        if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
    }
    return true;
}

static inline void sub_nored(Fe &r, const Fe &a, const Fe &b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        r.v[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline void add_mod(const FieldCtx &f, Fe &r, const Fe &a, const Fe &b) {
    u128 carry = 0;
    Fe t;
    for (int i = 0; i < 4; ++i) {
        u128 s = (u128)a.v[i] + b.v[i] + carry;
        t.v[i] = (uint64_t)s;
        carry = s >> 64;
    }
    if (carry || geq(t, f.p)) {
        Fe u;
        sub_nored(u, t, f.p);
        r = u;
    } else {
        r = t;
    }
}

// CIOS Montgomery multiplication (Pasta moduli have top bit clear, so
// the 5-limb accumulator never overflows).
static inline void mont_mul(const FieldCtx &f, Fe &r, const Fe &a, const Fe &b) {
    uint64_t t[5] = {0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 cur = (u128)a.v[j] * b.v[i] + t[j] + carry;
            t[j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        u128 t4 = (u128)t[4] + carry;
        uint64_t m = t[0] * f.pinv;
        carry = ((u128)m * f.p.v[0] + t[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            u128 cur = (u128)m * f.p.v[j] + t[j] + carry;
            t[j - 1] = (uint64_t)cur;
            carry = cur >> 64;
        }
        t4 += carry;
        t[3] = (uint64_t)t4;
        t[4] = (uint64_t)(t4 >> 64);
    }
    Fe out{{t[0], t[1], t[2], t[3]}};
    if (t[4] || geq(out, f.p)) {
        Fe u;
        sub_nored(u, out, f.p);
        r = u;
    } else {
        r = out;
    }
}

static inline void mont_sqr(const FieldCtx &f, Fe &r, const Fe &a) {
    mont_mul(f, r, a, a);
}

static void to_mont(const FieldCtx &f, Fe &r, const Fe &a) { mont_mul(f, r, a, f.r2); }

static void from_mont(const FieldCtx &f, Fe &r, const Fe &a) {
    Fe one{{1, 0, 0, 0}};
    mont_mul(f, r, a, one);
}

// ---------------------------------------------------------------------------
// Poseidon permutation for the Fiat-Shamir transcript sponges
// (poseidon/src/permutation.rs): full rounds of sbox x^e, the 3x3 MDS
// product and the round constants, with an optional initial ark.
// ---------------------------------------------------------------------------

struct SpongeCtx {
    FieldCtx f;
    int rounds;
    int sbox_e;
    int initial_ark;
    Fe mds[3][3];
    Fe *rc;  // (rounds + initial_ark) * 3, Montgomery form
};

static inline void sbox_apply(const SpongeCtx &s, Fe &x) {
    Fe x2, x3, r;
    mont_sqr(s.f, x2, x);
    mont_mul(s.f, x3, x2, x);
    if (s.sbox_e == 7) {
        Fe x6;
        mont_sqr(s.f, x6, x3);
        mont_mul(s.f, r, x6, x);
    } else {  // 5
        Fe x4;
        mont_sqr(s.f, x4, x2);
        mont_mul(s.f, r, x4, x);
    }
    x = r;
}

extern "C" {

void *ps_new(const uint8_t *p_le, const uint8_t *r2_le, uint64_t pinv,
             int rounds, int sbox_e, int initial_ark,
             const uint8_t *mds_le, const uint8_t *rc_le) {
    SpongeCtx *s = new SpongeCtx();
    std::memcpy(s->f.p.v, p_le, 32);
    std::memcpy(s->f.r2.v, r2_le, 32);
    s->f.pinv = pinv;
    s->rounds = rounds;
    s->sbox_e = sbox_e;
    s->initial_ark = initial_ark;
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            Fe raw;
            std::memcpy(raw.v, mds_le + 32 * (3 * i + j), 32);
            to_mont(s->f, s->mds[i][j], raw);
        }
    int nrc = (rounds + initial_ark) * 3;
    s->rc = (Fe *)std::malloc(sizeof(Fe) * nrc);
    for (int i = 0; i < nrc; ++i) {
        Fe raw;
        std::memcpy(raw.v, rc_le + 32 * i, 32);
        to_mont(s->f, s->rc[i], raw);
    }
    return s;
}

void ps_free(void *ctx) {
    SpongeCtx *s = (SpongeCtx *)ctx;
    std::free(s->rc);
    delete s;
}

// state: 3 x 32 LE bytes, standard form; permuted in place.
void ps_permute(void *ctx, uint8_t *state_bytes) {
    SpongeCtx *s = (SpongeCtx *)ctx;
    Fe st[3];
    for (int i = 0; i < 3; ++i) {
        Fe raw;
        std::memcpy(raw.v, state_bytes + 32 * i, 32);
        to_mont(s->f, st[i], raw);
    }
    const Fe *rc = s->rc;
    if (s->initial_ark) {
        for (int i = 0; i < 3; ++i) add_mod(s->f, st[i], st[i], rc[i]);
        rc += 3;
    }
    for (int r = 0; r < s->rounds; ++r) {
        for (int i = 0; i < 3; ++i) sbox_apply(*s, st[i]);
        Fe nw[3];
        for (int i = 0; i < 3; ++i) {
            Fe acc, t;
            mont_mul(s->f, acc, s->mds[i][0], st[0]);
            mont_mul(s->f, t, s->mds[i][1], st[1]);
            add_mod(s->f, acc, acc, t);
            mont_mul(s->f, t, s->mds[i][2], st[2]);
            add_mod(s->f, acc, acc, t);
            add_mod(s->f, nw[i], acc, rc[3 * r + i]);
        }
        st[0] = nw[0];
        st[1] = nw[1];
        st[2] = nw[2];
    }
    for (int i = 0; i < 3; ++i) {
        Fe out;
        from_mont(s->f, out, st[i]);
        std::memcpy(state_bytes + 32 * i, out.v, 32);
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Pasta curve arithmetic + Pippenger MSM.
//
// Host-side equivalent of arkworks' VariableBaseMSM (`msm_bigint`), which
// the reference uses for every commitment (poly-commitment/src/ipa.rs).
// The device path is ops/msm.py; this one is its exact golden model.
//
// Jacobian coordinates over the Montgomery-form base field; Z == 0 marks
// the point at infinity. Both Pasta curves are y^2 = x^3 + 5 (a = 0).
// ---------------------------------------------------------------------------

static inline void sub_mod(const FieldCtx &f, Fe &r, const Fe &a, const Fe &b) {
    if (geq(a, b)) {
        sub_nored(r, a, b);
    } else {
        Fe t;
        u128 carry = 0;
        for (int i = 0; i < 4; ++i) {
            u128 s = (u128)a.v[i] + f.p.v[i] + carry;
            t.v[i] = (uint64_t)s;
            carry = s >> 64;
        }
        sub_nored(r, t, b);
    }
}

static inline bool fe_is_zero(const Fe &a) {
    return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline bool fe_eq(const Fe &a, const Fe &b) {
    return a.v[0] == b.v[0] && a.v[1] == b.v[1] && a.v[2] == b.v[2] &&
           a.v[3] == b.v[3];
}

struct Jac {
    Fe x, y, z;  // Montgomery form; z == 0 -> infinity
};

struct CurveCtx {
    FieldCtx f;
    Fe one_m;  // 1 in Montgomery form
};

static inline void dbl_fe(const FieldCtx &f, Fe &r, const Fe &a) { add_mod(f, r, a, a); }

// dbl-2009-l (a = 0): A=X^2 B=Y^2 C=B^2 D=2((X+B)^2-A-C) E=3A F=E^2
static void jac_double(const CurveCtx &c, Jac &r, const Jac &p) {
    if (fe_is_zero(p.z)) { r = p; return; }
    const FieldCtx &f = c.f;
    Fe A, B, C, D, E, F, t, t2;
    mont_sqr(f, A, p.x);
    mont_sqr(f, B, p.y);
    mont_sqr(f, C, B);
    add_mod(f, t, p.x, B);
    mont_sqr(f, t, t);
    sub_mod(f, t, t, A);
    sub_mod(f, t, t, C);
    dbl_fe(f, D, t);
    add_mod(f, E, A, A);
    add_mod(f, E, E, A);
    mont_sqr(f, F, E);
    // X3 = F - 2D
    sub_mod(f, r.x, F, D);
    sub_mod(f, r.x, r.x, D);
    // Z3 = 2*Y1*Z1 (before Y is overwritten)
    mont_mul(f, t2, p.y, p.z);
    // Y3 = E*(D - X3) - 8C
    sub_mod(f, t, D, r.x);
    mont_mul(f, t, E, t);
    Fe c8;
    dbl_fe(f, c8, C);
    dbl_fe(f, c8, c8);
    dbl_fe(f, c8, c8);
    sub_mod(f, r.y, t, c8);
    dbl_fe(f, r.z, t2);
}

// add-2007-bl general Jacobian add with inf/equal handling
static void jac_add(const CurveCtx &c, Jac &r, const Jac &p, const Jac &q) {
    if (fe_is_zero(p.z)) { r = q; return; }
    if (fe_is_zero(q.z)) { r = p; return; }
    const FieldCtx &f = c.f;
    Fe z1z1, z2z2, u1, u2, s1, s2, t;
    mont_sqr(f, z1z1, p.z);
    mont_sqr(f, z2z2, q.z);
    mont_mul(f, u1, p.x, z2z2);
    mont_mul(f, u2, q.x, z1z1);
    mont_mul(f, t, q.z, z2z2);
    mont_mul(f, s1, p.y, t);
    mont_mul(f, t, p.z, z1z1);
    mont_mul(f, s2, q.y, t);
    if (fe_eq(u1, u2)) {
        if (fe_eq(s1, s2)) { jac_double(c, r, p); return; }
        r.x = c.one_m; r.y = c.one_m;
        std::memset(r.z.v, 0, 32);
        return;
    }
    Fe h, i, j, rr, v;
    sub_mod(f, h, u2, u1);
    dbl_fe(f, i, h);
    mont_sqr(f, i, i);
    mont_mul(f, j, h, i);
    sub_mod(f, rr, s2, s1);
    dbl_fe(f, rr, rr);
    mont_mul(f, v, u1, i);
    // X3 = r^2 - J - 2V
    mont_sqr(f, t, rr);
    sub_mod(f, t, t, j);
    sub_mod(f, t, t, v);
    sub_mod(f, r.x, t, v);
    // Y3 = r*(V - X3) - 2*S1*J
    sub_mod(f, t, v, r.x);
    mont_mul(f, t, rr, t);
    Fe s1j;
    mont_mul(f, s1j, s1, j);
    dbl_fe(f, s1j, s1j);
    sub_mod(f, r.y, t, s1j);
    // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) * H
    add_mod(f, t, p.z, q.z);
    mont_sqr(f, t, t);
    sub_mod(f, t, t, z1z1);
    sub_mod(f, t, t, z2z2);
    mont_mul(f, r.z, t, h);
}

// Fermat inversion a^(p-2) mod p (Montgomery in/out)
static void mont_inv(const FieldCtx &f, Fe &r, const Fe &a) {
    Fe e;  // p - 2
    Fe two{{2, 0, 0, 0}};
    sub_nored(e, f.p, two);
    Fe base = a;
    Fe acc;  // 1 in Montgomery form = R mod p: compute via r2 * 1
    Fe one{{1, 0, 0, 0}};
    mont_mul(f, acc, one, f.r2);
    for (int i = 0; i < 4; ++i) {
        uint64_t w = e.v[i];
        for (int b = 0; b < 64; ++b) {
            if ((w >> b) & 1) mont_mul(f, acc, acc, base);
            mont_sqr(f, base, base);
        }
    }
    r = acc;
}

extern "C" {

void *pc_new(const uint8_t *p_le, const uint8_t *r2_le, uint64_t pinv) {
    CurveCtx *c = new CurveCtx();
    std::memcpy(c->f.p.v, p_le, 32);
    std::memcpy(c->f.r2.v, r2_le, 32);
    c->f.pinv = pinv;
    Fe one{{1, 0, 0, 0}};
    mont_mul(c->f, c->one_m, one, c->f.r2);
    return c;
}

void pc_free(void *ctx) { delete (CurveCtx *)ctx; }

// Pippenger MSM.
//   scalars: n x 32 LE bytes (standard form, canonical)
//   points:  n x 64 LE bytes affine (x, y) standard form; inf: n flag bytes
//   out:     65 bytes: x (32) || y (32) || inf flag
void pc_msm(void *ctx, uint64_t n, const uint8_t *scalars, const uint8_t *points,
            const uint8_t *inf, uint8_t *out) {
    CurveCtx *c = (CurveCtx *)ctx;
    const FieldCtx &f = c->f;
    // affine points to Montgomery once
    Fe *px = (Fe *)std::malloc(sizeof(Fe) * n);
    Fe *py = (Fe *)std::malloc(sizeof(Fe) * n);
    for (uint64_t i = 0; i < n; ++i) {
        Fe raw;
        std::memcpy(raw.v, points + 64 * i, 32);
        to_mont(f, px[i], raw);
        std::memcpy(raw.v, points + 64 * i + 32, 32);
        to_mont(f, py[i], raw);
    }
    int cbits = n < 16 ? 3 : n < 64 ? 5 : n < 1024 ? 8 : n < 16384 ? 11 : 13;
    int nwin = (255 + cbits - 1) / cbits;
    uint64_t nbuckets = ((uint64_t)1 << cbits) - 1;
    Jac *buckets = (Jac *)std::malloc(sizeof(Jac) * nbuckets);
    Jac acc;
    std::memset(acc.z.v, 0, 32);
    acc.x = c->one_m; acc.y = c->one_m;
    for (int w = nwin - 1; w >= 0; --w) {
        for (int d = 0; d < cbits && !fe_is_zero(acc.z); ++d) jac_double(*c, acc, acc);
        for (uint64_t k = 0; k < nbuckets; ++k) {
            std::memset(buckets[k].z.v, 0, 32);
            buckets[k].x = c->one_m; buckets[k].y = c->one_m;
        }
        int bit0 = w * cbits;
        for (uint64_t i = 0; i < n; ++i) {
            if (inf[i]) continue;
            // extract cbits bits starting at bit0 from the LE scalar
            uint64_t digit = 0;
            for (int b = 0; b < cbits; ++b) {
                int bit = bit0 + b;
                if (bit >= 256) break;
                uint64_t byte = scalars[32 * i + bit / 8];
                digit |= ((byte >> (bit % 8)) & 1ull) << b;
            }
            if (!digit) continue;
            Jac pt;
            pt.x = px[i]; pt.y = py[i]; pt.z = c->one_m;
            jac_add(*c, buckets[digit - 1], buckets[digit - 1], pt);
        }
        // suffix-sum bucket combine
        Jac running, sum;
        std::memset(running.z.v, 0, 32);
        running.x = c->one_m; running.y = c->one_m;
        sum = running;
        for (int64_t k = nbuckets - 1; k >= 0; --k) {
            jac_add(*c, running, running, buckets[k]);
            jac_add(*c, sum, sum, running);
        }
        jac_add(*c, acc, acc, sum);
    }
    std::free(buckets);
    std::free(px);
    std::free(py);
    // to affine standard form
    if (fe_is_zero(acc.z)) {
        std::memset(out, 0, 64);
        out[64] = 1;
        return;
    }
    Fe zinv, zinv2, zinv3, ax, ay, o;
    mont_inv(f, zinv, acc.z);
    mont_sqr(f, zinv2, zinv);
    mont_mul(f, zinv3, zinv2, zinv);
    mont_mul(f, ax, acc.x, zinv2);
    mont_mul(f, ay, acc.y, zinv3);
    from_mont(f, o, ax);
    std::memcpy(out, o.v, 32);
    from_mont(f, o, ay);
    std::memcpy(out + 32, o.v, 32);
    out[64] = 0;
}

}  // extern "C"
