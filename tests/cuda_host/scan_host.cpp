// K12's, K9's and K5's device code (csrc/scan_field.cuh) run on the host,
// phase by phase over every warp, lane and team member, as the card runs
// it: cuda_runtime.h here emulates a warp as 32 threads (phase 1) and a
// block as PST_LANES threads (phase 2); phase 3 runs one position at a
// time; K5 runs a block of T threads a row. The caller holds the results
// against Python integers.
//
//     scan_host INPUT OUTPUT
//
// INPUT, little-endian uint32 words: the 17 field words (p, -p^-1 mod 2^32,
// R mod p), then a job:
//   1 (K12): rows, n, cp, team_log2, x (8, rows, n) limb-major;
//     OUTPUT: partial (8, rows, 128 cp), excl (8, rows, 128);
//   2 (K9): rows, n, cp, team_log2, tlen, the table (8, tlen), x;
//     OUTPUT: the scan (8, rows, n);
//   3 (the team scan alone): op (0 product, 1 K9's map), team_log2, cp,
//     tlen, the table (8, tlen) (op 1), 32 totals (8, 32);
//     OUTPUT: each thread's exclusive value (8, 32);
//   4 (the lane scan alone): op, cp, tlen, the table (op 1), rows, the lane
//     values (8, rows, 128); OUTPUT: the exclusive values (8, rows, 128);
//   5 (K5, on chain_field.cuh's product): rows, n, sc, warps_log2,
//     lanes_log2, x (8, rows, n); OUTPUT: the inclusive scan (8, rows, n).
// Positions the kernels leave unwritten keep 0xFFFFFFFF, which no canonical
// limb of the Pasta moduli equals. Exits 2 on a malformed input.

#include <cstdio>
#include <thread>
#include <vector>

#include "chain_field.cuh"
#include "scan_field.cuh"

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
};

// fn(t) on `count` host threads that share one HostWarp.
template <class Fn>
static void run_threads(int count, Fn fn) {
    HostWarp warp(count);
    host_warp = &warp;
    std::vector<std::thread> threads;
    for (int t = 0; t < count; ++t)
        threads.emplace_back([&, t] {
            host_lane = t;
            fn(t);
        });
    for (auto &th : threads) th.join();
}

// Phase 1 over every warp of the call: body(g, tile, t) on 32 threads.
template <class Body>
static void each_warp(int64_t rows, int64_t n, int64_t cp, int team_log2, Body body) {
    std::vector<uint32_t> tile(SCAN_TILE_WORDS);
    run_threads(32, [&](int t) {
        ScanWarp g;
        for (int64_t w = 0; scan_warp(g, rows, n, cp, team_log2, w); ++w) {
            body(g, tile.data(), t);
            __syncwarp();  // the tile passes to the next warp
        }
    });
}

template <class Op>
static void lane_scan(const Op &op, std::vector<uint32_t> &v, int64_t rows) {
    std::vector<uint32_t> sh(2 * PST_NL * PST_LANES);
    run_threads(PST_LANES, [&](int t) {
        for (int64_t row = 0; row < rows; ++row) {
            const int64_t i = row * PST_LANES + t;
            const Fe e = lane_excl(op, t, fe_load(v.data(), rows * PST_LANES, i), sh.data());
            fe_store(v.data(), rows * PST_LANES, i, e);
        }
    });
}

struct Table {
    int64_t cp, tlen;
    std::vector<uint32_t> words;
    LinOp op() const { return lin_op(F, words.data(), tlen, cp); }
};

static Table read_table(Reader &in) {
    Table tb;
    tb.cp = in.word();
    tb.tlen = in.word();
    tb.words = in.words(PST_NL * tb.tlen);
    return tb;
}

static bool valid(int team_log2) { return team_log2 >= 0 && team_log2 <= 5; }

static void k12(Reader &in, FILE *out) {
    const int64_t rows = in.word(), n = in.word(), cp = in.word();
    const int tl = (int)in.word();
    if (!valid(tl)) std::exit(2);
    const std::vector<uint32_t> x = in.words(PST_NL * rows * n);
    std::vector<uint32_t> part(PST_NL * rows * PST_LANES * cp, 0xFFFFFFFFu);
    std::vector<uint32_t> tot(PST_NL * rows * PST_LANES, 0xFFFFFFFFu);
    each_warp(rows, n, cp, tl, [&](const ScanWarp &g, uint32_t *tile, int t) {
        uint32_t *p = part.data(), *o = tot.data();
        tl ? prod_parts_thread<true>(F, g, x.data(), p, o, tile, t)
           : prod_parts_thread<false>(F, g, x.data(), p, o, tile, t);
    });
    lane_scan(ProdOp{F}, tot, rows);
    std::fwrite(part.data(), 4, part.size(), out);
    std::fwrite(tot.data(), 4, tot.size(), out);
}

static void k9(Reader &in, FILE *out) {
    const int64_t rows = in.word(), n = in.word(), cp = in.word();
    const int tl = (int)in.word();
    if (!valid(tl)) std::exit(2);
    Table tb{cp, in.word(), {}};
    tb.words = in.words(PST_NL * tb.tlen);
    const LinOp op = tb.op();
    const std::vector<uint32_t> x = in.words(PST_NL * rows * n);
    std::vector<uint32_t> o(PST_NL * rows * n, 0xFFFFFFFFu);
    std::vector<uint32_t> toff(PST_NL * rows * PST_LANES << tl, 0xFFFFFFFFu);
    std::vector<uint32_t> tot(PST_NL * rows * PST_LANES, 0xFFFFFFFFu);
    each_warp(rows, n, cp, tl, [&](const ScanWarp &g, uint32_t *tile, int t) {
        uint32_t *a = o.data(), *b = toff.data(), *c = tot.data();
        tl ? lin_parts_thread<true>(op, g, x.data(), a, b, c, tile, t)
           : lin_parts_thread<false>(op, g, x.data(), a, b, c, tile, t);
    });
    lane_scan(op, tot, rows);
    const int64_t sc = (cp + (1 << tl) - 1) >> tl;
    for (int64_t i = 0; i < rows * n; ++i)
        lin_combine_at(op, rows, n, sc, tl, o.data(), toff.data(), tot.data(), i);
    std::fwrite(o.data(), 4, o.size(), out);
}

template <class Op>
static void team_alone(const Op &op, int tl, Reader &in, FILE *out) {
    const std::vector<uint32_t> tots = in.words(PST_NL * 32);
    std::vector<uint32_t> res(PST_NL * 32, 0xFFFFFFFFu);
    run_threads(32, [&](int t) {
        fe_store(res.data(), 32, t, team_excl(op, tl, t, fe_load(tots.data(), 32, t)));
    });
    std::fwrite(res.data(), 4, res.size(), out);
}

static void k5(Reader &in, FILE *out) {
    const int64_t rows = in.word(), n = in.word(), sc = in.word();
    const int wl = (int)in.word(), ll = (int)in.word();
    if (wl < 0 || wl > 4 || ll < 0 || ll > 5 || sc < 1 || (sc << (5 + wl)) < n) std::exit(2);
    const std::vector<uint32_t> x = in.words(PST_NL * rows * n);
    std::vector<uint32_t> o(PST_NL * rows * n, 0xFFFFFFFFu);
    std::vector<uint32_t> tiles(SCAN_TILE_WORDS << wl), sh(PST_NL * 32);
    for (int64_t row = 0; row < rows; ++row)
        run_threads(32 << wl, [&](int t) {
            prefix_block_thread(ProdLatOp{F}, x.data(), o.data(), rows, n, sc, wl, ll, row,
                                tiles.data() + (t / 32) * SCAN_TILE_WORDS, sh.data(), t);
        });
    std::fwrite(o.data(), 4, o.size(), out);
}

int main(int argc, char **argv) {
    if (argc != 3) return 2;
    Reader in{std::fopen(argv[1], "rb")};
    FILE *out = std::fopen(argv[2], "wb");
    if (!in.f || !out) return 2;
    const std::vector<uint32_t> fw = in.words(2 * PST_NL + 1);
    F = pst_field_params(fw.data());
    const uint32_t kind = in.word();
    if (kind == 1) {
        k12(in, out);
    } else if (kind == 2) {
        k9(in, out);
    } else if (kind == 3 || kind == 4) {
        const uint32_t op = in.word();
        const int tl = kind == 3 ? (int)in.word() : 0;
        if (!valid(tl) || op > 1) return 2;
        const Table tb = read_table(in);
        if (kind == 3) {
            op ? team_alone(tb.op(), tl, in, out) : team_alone(ProdOp{F}, tl, in, out);
        } else {
            const int64_t rows = in.word();
            std::vector<uint32_t> v = in.words(PST_NL * rows * PST_LANES);
            op ? lane_scan(tb.op(), v, rows) : lane_scan(ProdOp{F}, v, rows);
            std::fwrite(v.data(), 4, v.size(), out);
        }
    } else if (kind == 5) {
        if (!pst_pasta_shape(F)) return 2;
        k5(in, out);
    } else {
        return 2;
    }
    std::fclose(out);
    return 0;
}
