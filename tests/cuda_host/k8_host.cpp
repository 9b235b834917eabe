// K8's device code (csrc/k8_combine.cuh) run on the host, one emulated warp
// a column (cuda_runtime.h here), against the old one-thread Horner chain
// through field.cuh's ec_double and ec_add, limb for limb.
//
//     k8_host PARAMS_FILE     (17 words: p, -p^-1 mod 2^32, R mod p)
//
// Columns of every case: 0 all identities (x, y random, z = 0); 1 window
// W - 2 equal to 2^c times window W - 1 (the doubling fallback at the first
// add); 2 its negation (the infinity fallback); 3 window W - 3 equal to 2^c
// times the accumulator after window W - 2 (the doubling fallback
// mid-chain); the others random, with identities scattered. Prints one
// line a case; exits 1 on a mismatch.

#include <cstdio>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

#include "k8_combine.cuh"

HostWarp *host_warp;
thread_local int host_lane;

static FieldParams F;
static std::mt19937_64 rng(20261017);

struct Windows {
    int64_t W, b;
    int c;
    std::vector<uint32_t> x, y, z;
    Jac at(int64_t w, int64_t i) const {
        return jac_load(x.data(), y.data(), z.data(), W * b, w * b + i);
    }
    void put(int64_t w, int64_t i, const Jac &q) {
        jac_store(x.data(), y.data(), z.data(), W * b, w * b + i, q);
    }
};

static Fe random_fe() {
    Fe r;
    for (int l = 0; l < PST_NL; ++l) r.v[l] = (uint32_t)rng();
    r.v[PST_NL - 1] %= F.p[PST_NL - 1];  // below p
    return r;
}

static Jac times2c(Jac a, int c) {
    for (int k = 0; k < c; ++k) a = ec_double(F, a);
    return a;
}

static Windows make(int64_t W, int64_t b, int c) {
    Windows s{W, b, c, std::vector<uint32_t>(8 * W * b), std::vector<uint32_t>(8 * W * b),
              std::vector<uint32_t>(8 * W * b)};
    for (int64_t w = 0; w < W; ++w)
        for (int64_t i = 0; i < b; ++i) {
            Jac q{random_fe(), random_fe(), random_fe()};
            if (i == 0 || (i >= 4 && (w + i) % 5 == 3)) q.z = fe_zero();
            s.put(w, i, q);
        }
    if (W >= 2 && b >= 3) {
        s.put(W - 2, 1, times2c(s.at(W - 1, 1), c));
        Jac n = times2c(s.at(W - 1, 2), c);
        n.y = fe_sub(F, fe_zero(), n.y);
        s.put(W - 2, 2, n);
    }
    if (W >= 3 && b >= 4)
        s.put(W - 3, 3, times2c(ec_add(F, times2c(s.at(W - 1, 3), c), s.at(W - 2, 3)), c));
    return s;
}

static Jac reference(const Windows &s, int64_t i) {
    Jac acc = jac_identity();
    for (int64_t w = s.W - 1; w >= 0; --w) acc = ec_add(F, times2c(acc, s.c), s.at(w, i));
    return acc;
}

static int check(const Windows &s) {
    std::vector<uint32_t> ox(8 * s.b), oy(8 * s.b), oz(8 * s.b);
    int bad = 0;
    for (int64_t i = 0; i < s.b; ++i) {
        HostWarp warp;
        host_warp = &warp;
        std::vector<std::thread> lanes;
        for (int lane = 0; lane < 32; ++lane)
            lanes.emplace_back([&, lane] {
                host_lane = lane;
                k8_combine_column(F, s.x.data(), s.y.data(), s.z.data(), ox.data(), oy.data(),
                                  oz.data(), s.W, s.b, s.c, i, lane);
            });
        for (auto &t : lanes) t.join();
        const Jac want = reference(s, i);
        const Jac got = jac_load(ox.data(), oy.data(), oz.data(), s.b, i);
        bad += std::memcmp(&want, &got, sizeof(Jac)) != 0;
    }
    std::printf("W %lld b %lld c %d: %s\n", (long long)s.W, (long long)s.b, s.c,
                bad ? "MISMATCH" : "equal");
    return bad;
}

int main(int argc, char **argv) {
    uint32_t words[17];
    FILE *f = argc > 1 ? std::fopen(argv[1], "rb") : nullptr;
    if (f == nullptr || std::fread(words, 4, 17, f) != 17) return 2;
    std::fclose(f);
    F = pst_field_params(words);
    int bad = 0;
    for (const Windows &s : {make(3, 4, 2), make(1, 2, 3), make(2, 3, 1)}) bad += check(s);
    return bad != 0;
}
