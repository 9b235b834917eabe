// K11's device code (csrc/inv_field.cuh) run on the host: the binary-GCD
// inverse and the closed form of ScalarChallenge.to_field, for the caller
// to hold against Python integers, the plain version and the JAX package.
//
//     inv_host INPUT OUTPUT
//
// INPUT, little-endian uint32 words: the 17 field words (p, -p^-1 mod 2^32,
// R mod p); m, then m integers x (8 words each, least significant first);
// K11's 24 constant words (endo R^2, R^2, R^3 mod p); j, then j challenges
// of 128 bit words each (least significant first).
// OUTPUT gets fe_inv_gcd(x) and fe_inv_gcd(x) * R^3 (Montgomery product)
// for each x, then u and u^-1 (Montgomery, endo_inv_thread) for each
// challenge. Exits 2 on a malformed input, 3 for a field without the Pasta
// shape.

#include <cstdio>
#include <vector>

#include "inv_field.cuh"

struct Reader {
    FILE *f;
    uint32_t word() {
        uint32_t w = 0;
        if (std::fread(&w, 4, 1, f) != 1) std::exit(2);
        return w;
    }
    Fe elem() {
        Fe e;
        for (int l = 0; l < PST_NL; ++l) e.v[l] = word();
        return e;
    }
};

int main(int argc, char **argv) {
    if (argc != 3) return 2;
    Reader in{std::fopen(argv[1], "rb")};
    FILE *out = std::fopen(argv[2], "wb");
    if (!in.f || !out) return 2;
    uint32_t fw[2 * PST_NL + 1];
    for (auto &w : fw) w = in.word();
    const FieldParams F = pst_field_params(fw);
    if (!pst_pasta_shape(F)) return 3;
    const uint32_t m = in.word();
    std::vector<Fe> xs(m);
    for (auto &x : xs) x = in.elem();
    EndoConsts k;
    k.endo_r2 = in.elem();
    k.r2 = in.elem();
    k.r3 = in.elem();
    for (const Fe &x : xs) {
        const Fe inv = fe_inv_gcd(F, x);
        const Fe mont = fe_mul_lat(F, inv, k.r3);
        std::fwrite(inv.v, 4, PST_NL, out);
        std::fwrite(mont.v, 4, PST_NL, out);
    }
    const uint32_t j = in.word();
    for (uint32_t c = 0; c < j; ++c) {
        std::vector<int32_t> bits(128);
        for (auto &b : bits) b = (int32_t)in.word();
        uint32_t u[PST_NL], uinv[PST_NL];
        endo_inv_thread(F, k, bits.data(), u, uinv);
        std::fwrite(u, 4, PST_NL, out);
        std::fwrite(uinv, 4, PST_NL, out);
    }
    std::fclose(out);
    return 0;
}
