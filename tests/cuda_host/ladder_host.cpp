// The endo ladder's and K2's device code (csrc/endo_ladder.cuh and
// field.cuh's inlined ec_add_inl / ec_double_inl) run on the host, against
// the loop the fold step ran before the ladder kernel: one ec_double (K3)
// and one ec_add (K2) a step, through field.cuh's out-of-line formulas,
// limb for limb.
//
//     ladder_host INPUT OUTPUT
//
// INPUT, little-endian uint32 words: the 17 field words (p, -p^-1 mod 2^32,
// R mod p); endo_q in Montgomery form (8); B, then B sets of 128 challenge
// bits; n, then the ladder's points x, y, z as (8, n) limb-major arrays; m,
// then K2's operands px, py, pz, qx, qy, qz as (8, m) arrays. OUTPUT gets the
// ladder's results, B times x, y, z as (8, n) arrays, for the caller to hold
// against the plain PyTorch version. Prints one line a check; exits 1 on a
// mismatch.

#include <cstdio>
#include <cstring>
#include <vector>

#include "endo_ladder.cuh"

static FieldParams F;

struct Reader {
    FILE *f;
    uint32_t word() {
        uint32_t w = 0;
        if (std::fread(&w, 4, 1, f) != 1) std::exit(2);
        return w;
    }
    std::vector<uint32_t> words(size_t n) {
        std::vector<uint32_t> v(n);
        if (n && std::fread(v.data(), 4, n, f) != n) std::exit(2);
        return v;
    }
};

// The old fold step: phi(x) by a product (K1), -y by a subtraction, then
// dbl(P + phi(P)) and 64 steps of dbl then add through the out-of-line
// formulas.
static Jac old_loop(const Jac &p, const Fe &endo_q, const uint32_t *bits) {
    const Fe phix = fe_mul(F, p.x, endo_q);
    const Fe negy = fe_sub(F, fe_zero(), p.y);
    Jac acc = ec_double(F, ec_add(F, p, Jac{phix, p.y, p.z}));
    for (int j = 63; j >= 0; --j) {
        const Jac q{bits[2 * j + 1] == 1 ? phix : p.x, bits[2 * j] == 1 ? p.y : negy, p.z};
        acc = ec_add(F, ec_double(F, acc), q);
    }
    return acc;
}

static bool same(const Jac &a, const Jac &b) { return std::memcmp(&a, &b, sizeof(Jac)) == 0; }

int main(int argc, char **argv) {
    if (argc != 3) return 2;
    Reader in{std::fopen(argv[1], "rb")};
    if (in.f == nullptr) return 2;
    const std::vector<uint32_t> fw = in.words(17);
    F = pst_field_params(fw.data());
    Fe endo_q;
    const std::vector<uint32_t> ew = in.words(PST_NL);
    std::memcpy(endo_q.v, ew.data(), sizeof(endo_q.v));
    const uint32_t B = in.word();
    const std::vector<uint32_t> bits = in.words(128 * (size_t)B);
    const int64_t n = in.word();
    const std::vector<uint32_t> pts = in.words(3 * PST_NL * (size_t)n);
    const int64_t m = in.word();
    const std::vector<uint32_t> ops = in.words(6 * PST_NL * (size_t)m);
    std::fclose(in.f);

    FILE *out = std::fopen(argv[2], "wb");
    if (out == nullptr) return 2;
    int bad_all = 0;
    const uint32_t *x = pts.data(), *y = x + PST_NL * n, *z = y + PST_NL * n;
    for (uint32_t k = 0; k < B; ++k) {
        std::vector<uint32_t> ox(PST_NL * n), oy(PST_NL * n), oz(PST_NL * n);
        int bad = 0;
        for (int64_t i = 0; i < n; ++i) {
            const Jac p = jac_load(x, y, z, n, i);
            // the kernel's bits come from shared memory, one word a bit
            const Jac got = endo_ladder_point(F, p, endo_q, bits.data() + 128 * k);
            bad += !same(got, old_loop(p, endo_q, bits.data() + 128 * k));
            jac_store(ox.data(), oy.data(), oz.data(), n, i, got);
        }
        for (const auto *v : {&ox, &oy, &oz}) std::fwrite(v->data(), 4, v->size(), out);
        std::printf("ladder bits %u over %lld points: %s\n", k, (long long)n,
                    bad ? "MISMATCH" : "equal");
        bad_all += bad;
    }
    std::fclose(out);

    const uint32_t *px = ops.data(), *py = px + PST_NL * m, *pz = py + PST_NL * m;
    const uint32_t *qx = pz + PST_NL * m, *qy = qx + PST_NL * m, *qz = qy + PST_NL * m;
    int bad_add = 0, bad_dbl = 0;
    for (int64_t i = 0; i < m; ++i) {
        const Jac p = jac_load(px, py, pz, m, i), q = jac_load(qx, qy, qz, m, i);
        bad_add += !same(ec_add_inl(F, p, q), ec_add(F, p, q));
        bad_dbl += !same(ec_double_inl(F, p), ec_double(F, p));
    }
    std::printf("K2 add over %lld pairs: %s\n", (long long)m, bad_add ? "MISMATCH" : "equal");
    std::printf("K3 double over %lld points: %s\n", (long long)m, bad_dbl ? "MISMATCH" : "equal");
    return bad_all + bad_add + bad_dbl != 0;
}
