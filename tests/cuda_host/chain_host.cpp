// chain_field.cuh's product, square and dot3, K4's exponentiation and K10's
// sponge run on the host (cuda_runtime.h here: the sponge's warp is 32
// threads at a barrier), for the caller to hold against Python integers and
// the JAX package's host sponge; the products also against field.cuh's CIOS
// fe_mul here, limb for limb.
//
//     chain_host INPUT OUTPUT
//
// INPUT, little-endian uint32 words: the 17 field words (p, -p^-1 mod 2^32,
// R mod p); n, then six arrays of n elements a, b, c, d, e, f (8 words an
// element, least significant first); nrounds, the sponge's constants as an
// (8, 3 * nrounds + 9) limb-major array, its state (8, 3), xs and ys (8, 2)
// (nrounds 0: no sponge); m, then m elements x; k, then k exponents, each
// as its digit count and that many digit words (most significant first).
// OUTPUT gets a*b, a^2, dot3(a, b, c, d, e, f) (n elements each), the
// sponge's state (8, 3) and challenge (8, 1) when nrounds > 0, then x^e for
// each exponent (m elements each). Prints one line a check against fe_mul;
// exits 1 on a mismatch, 2 on a malformed input, 3 for a field without the
// Pasta shape.

#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include "chain_field.cuh"

HostWarp *host_warp;
thread_local int host_lane;

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
    std::vector<Fe> elems(size_t n) {
        std::vector<Fe> v(n);
        for (auto &e : v)
            for (int l = 0; l < PST_NL; ++l) e.v[l] = word();
        return v;
    }
};

static void put(FILE *f, const Fe &a) { std::fwrite(a.v, 4, PST_NL, f); }

static bool same(const Fe &a, const Fe &b) { return std::memcmp(a.v, b.v, sizeof(a.v)) == 0; }

int main(int argc, char **argv) {
    if (argc != 3) return 2;
    Reader in{std::fopen(argv[1], "rb")};
    FILE *out = std::fopen(argv[2], "wb");
    if (!in.f || !out) return 2;
    const std::vector<uint32_t> fw = in.words(2 * PST_NL + 1);
    F = pst_field_params(fw.data());
    if (!pst_pasta_shape(F)) return 3;
    int bad = 0;

    const uint32_t n = in.word();
    std::vector<Fe> ops[6];
    for (auto &v : ops) v = in.elems(n);
    int mul_bad = 0, sqr_bad = 0, dot_bad = 0;
    for (uint32_t i = 0; i < n; ++i) {
        const Fe &a = ops[0][i], &b = ops[1][i];
        const Fe m = fe_mul_lat(F, a, b), s = fe_sqr_lat(F, a);
        const Fe d = fe_dot3_lat(F, a, b, ops[2][i], ops[3][i], ops[4][i], ops[5][i]);
        const Fe dref = fe_add(F, fe_add(F, fe_mul(F, a, b), fe_mul(F, ops[2][i], ops[3][i])),
                               fe_mul(F, ops[4][i], ops[5][i]));
        mul_bad += !same(m, fe_mul(F, a, b));
        sqr_bad += !same(s, fe_mul(F, a, a));
        dot_bad += !same(d, dref);
        put(out, m);
        put(out, s);
        put(out, d);
    }
    std::printf("fe_mul_lat: %u products %s fe_mul\n", n, mul_bad ? "DIFFER from" : "equal");
    std::printf("fe_sqr_lat: %u squares %s fe_mul\n", n, sqr_bad ? "DIFFER from" : "equal");
    std::printf("fe_dot3_lat: %u dot3s %s three fe_mul and two fe_add\n", n,
                dot_bad ? "DIFFER from" : "equal");
    bad += mul_bad + sqr_bad + dot_bad;

    const int nrounds = (int)in.word();
    if (nrounds > 0) {
        const std::vector<uint32_t> consts = in.words(PST_NL * (3 * (size_t)nrounds + 9));
        const std::vector<uint32_t> state = in.words(PST_NL * 3), xs = in.words(PST_NL * 2),
                                    ys = in.words(PST_NL * 2);
        std::vector<uint32_t> ost(PST_NL * 3), ochal(PST_NL);
        HostWarp warp;
        host_warp = &warp;
        std::vector<std::thread> lanes;
        for (int lane = 0; lane < 32; ++lane)
            lanes.emplace_back([&, lane] {
                host_lane = lane;
                sponge_squeeze2_lanes(F, lane, state.data(), xs.data(), ys.data(), consts.data(), nrounds,
                            ost.data(), ochal.data());
            });
        for (auto &t : lanes) t.join();
        std::fwrite(ost.data(), 4, ost.size(), out);
        std::fwrite(ochal.data(), 4, ochal.size(), out);
        std::printf("sponge: %d rounds a permutation, state and challenge written\n", nrounds);
    }

    const uint32_t m = in.word();
    const std::vector<Fe> xs = in.elems(m);
    const uint32_t k = in.word();
    std::vector<uint32_t> tab(16 * PST_NL);  // the table, stride 1: one thread
    for (uint32_t j = 0; j < k; ++j) {
        const int nd = (int)in.word();
        if (nd < 0 || nd > 64) return 2;
        std::vector<uint8_t> digits(nd);
        for (auto &d : digits) d = (uint8_t)in.word();
        PowDigits e;
        if (!pst_pow_digits(e, digits.data(), nd)) return 2;
        for (uint32_t i = 0; i < m; ++i) put(out, fe_pow_lat(F, xs[i], e, tab.data(), 1));
    }
    std::printf("fe_pow_lat: %u exponents of %u elements written\n", k, m);
    std::fclose(out);
    return bad ? 1 : 0;
}
