// K12 (mont_prefix_scan_parts) and K9 (linear_scan) on this card: a row's
// lane chunks spread over teams of threads, the loads and stores staged
// through shared memory, the lane scan in a kernel of its own. K5
// (mont_prefix_scan) reuses the tiles and the team scan for a row in one
// block (prefix_block_thread, at the end).
//
// A row of n positions is cut into PST_LANES lanes of cp positions (K12: cp
// = Cp of kernels.scan_geometry, one past n; K9: cp = ceil(n / 128), zero
// past n). A team of S = 1 << team_log2 threads of one warp shares each
// lane: member s owns the sub-chunk [s sc, s sc + sc) of its lane, sc =
// ceil(cp / S), cut at cp. A warp holds 32 / S lanes of one row.
//
// What bounded the one-block-a-row kernels this replaces: a call on the
// main path is one row of 65,536, so one block of 128 threads ran on one of
// 132 SMs, each thread a chain of 512 dependent products (K12 519 levels, K9
// 1,031) whose every step loaded its operand with a stride of 2 KB across
// the warp: about 1.9 us a level, three times the product's latency. What
// the design does about it:
//   - a team of S threads a lane: each member reduces its sub-chunk
//     (sub_pass without stores), the team takes an exclusive scan of its
//     totals through warp shuffles (team_excl), and each member rescans its
//     sub-chunk from its offset, storing (K12); a chain of sc + log2 S + sc
//     products a thread instead of cp. K9 stores its members' local values
//     in its one pass and leaves the team's and the lane's terms to a third
//     kernel, one thread a position (lin_combine_at): sc + log2 S + 1 steps,
//     then 2 independent products a position;
//   - the warp copies SCAN_KT = 4 columns of its 32 sub-chunks at a time
//     between device and shared memory (16-byte runs), and each thread
//     reads and writes its own positions there. A tile of 8 columns
//     (32-byte runs) ran no faster with the teams the rule picks, and
//     spilled in K12's team kernel (PERF.md section 6);
//   - the exclusive scan of each row's 128 lane totals runs in a second
//     kernel, one block a row (lane_excl: Hillis-Steele over shared memory,
//     double-buffered, 8 barriers); K9's combine is the third. The wrappers
//     count one launch a call.
// The rows of the main path leave the card nearly idle, so the wrapper
// picks the largest team, up to one warp, whose threads fit the card twice
// over at 1,024 an SM (kernels.field_scan_team): S = 32 on every row of the
// main path and at 24 rows of 2^16, S = 1 where the rows fill the card.
//
// Field values are canonical and the operators exact, so every association
// order gives the plain version's limbs.
//
// The code is C++ that g++ also compiles (tests/cuda_host/scan_host.cpp):
// every step takes its thread's place (warp, thread of the warp, member,
// lane) as arguments.

#pragma once

#include "field.cuh"

// Warps a block of the team kernels.
#define SCAN_WARPS 4

// Columns of a warp's tile, and its words: PST_NL limbs of 32 sub-chunks,
// SCAN_KT + 1 columns (the odd row length keeps a thread's own reads free
// of bank conflicts).
#define SCAN_KT 4
#define SCAN_KP (SCAN_KT + 1)
#define SCAN_TILE_WORDS (PST_NL * 32 * SCAN_KP)

// One warp's share of a row scan: lanes [lane0, lane0 + 32 / S) of row
// `row`.
struct ScanWarp {
    int64_t rows, n, cp, sc, row, lane0;
    int team_log2;
};

// The share of warp `warp` (over the call's rows * PST_LANES * S threads);
// false past the last lane.
__device__ __forceinline__ bool scan_warp(ScanWarp &g, int64_t rows, int64_t n, int64_t cp,
                                          int team_log2, int64_t warp) {
    const int64_t lane = warp * (32 >> team_log2);
    if (lane >= rows * PST_LANES) return false;
    g.rows = rows;
    g.n = n;
    g.cp = cp;
    g.sc = (cp + (1 << team_log2) - 1) >> team_log2;
    g.row = lane / PST_LANES;
    g.lane0 = lane % PST_LANES;
    g.team_log2 = team_log2;
    return true;
}

__device__ __forceinline__ int team_member(const ScanWarp &g, int t) {
    return t & ((1 << g.team_log2) - 1);
}

// First position (in the row) of thread m's sub-chunk, and its length.
__device__ __forceinline__ int64_t sub_start(const ScanWarp &g, int m) {
    return (g.lane0 + (m >> g.team_log2)) * g.cp + (int64_t)team_member(g, m) * g.sc;
}

__device__ __forceinline__ int64_t sub_len(const ScanWarp &g, int m) {
    const int64_t a = (int64_t)team_member(g, m) * g.sc, b = a + g.sc < g.cp ? a + g.sc : g.cp;
    return b > a ? b - a : 0;
}

// The member whose sub-chunk holds its lane's last position.
__device__ __forceinline__ bool lane_last(const ScanWarp &g, int t) {
    return team_member(g, t) == (g.cp - 1) / g.sc;
}

// Copies columns [k0, k0 + SCAN_KT) of the warp's 32 sub-chunks from x
// (rows of n, limb stride rows * n) into the tile, positions below n.
__device__ __forceinline__ void tile_load(const ScanWarp &g, const uint32_t *__restrict__ x,
                                          uint32_t *tile, int t, int64_t k0) {
    int64_t pos[SCAN_KT];
    bool ok[SCAN_KT];
#pragma unroll
    for (int i = 0; i < SCAN_KT; ++i) {
        const int idx = t + 32 * i, m = idx / SCAN_KT, col = idx % SCAN_KT;
        pos[i] = sub_start(g, m) + k0 + col;
        ok[i] = k0 + col < sub_len(g, m) && pos[i] < g.n;
    }
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) {
        const uint32_t *src = x + l * g.rows * g.n + g.row * g.n;
#pragma unroll
        for (int i = 0; i < SCAN_KT; ++i) {
            const int idx = t + 32 * i;
            if (ok[i]) tile[(l * 32 + idx / SCAN_KT) * SCAN_KP + idx % SCAN_KT] = src[pos[i]];
        }
    }
}

// Copies the tile's columns [k0, k0 + SCAN_KT) to o (rows of olen, limb
// stride rows * olen), positions below olen.
__device__ __forceinline__ void tile_store(const ScanWarp &g, uint32_t *__restrict__ o,
                                           int64_t olen, const uint32_t *tile, int t,
                                           int64_t k0) {
    int64_t pos[SCAN_KT];
    bool ok[SCAN_KT];
#pragma unroll
    for (int i = 0; i < SCAN_KT; ++i) {
        const int idx = t + 32 * i, m = idx / SCAN_KT, col = idx % SCAN_KT;
        pos[i] = sub_start(g, m) + k0 + col;
        ok[i] = k0 + col < sub_len(g, m) && pos[i] < olen;
    }
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) {
        uint32_t *dst = o + l * g.rows * olen + g.row * olen;
#pragma unroll
        for (int i = 0; i < SCAN_KT; ++i) {
            const int idx = t + 32 * i;
            if (ok[i]) dst[pos[i]] = tile[(l * 32 + idx / SCAN_KT) * SCAN_KP + idx % SCAN_KT];
        }
    }
}

__device__ __forceinline__ Fe tile_get(const uint32_t *tile, int t, int col) {
    Fe v;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) v.v[l] = tile[(l * 32 + t) * SCAN_KP + col];
    return v;
}

__device__ __forceinline__ void tile_put(uint32_t *tile, int t, int col, const Fe &v) {
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) tile[(l * 32 + t) * SCAN_KP + col] = v.v[l];
}

__device__ __forceinline__ Fe fe_shfl_up(const Fe &a, int d, int width) {
    Fe r;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) r.v[l] = __shfl_up_sync(0xffffffffu, a.v[l], d, width);
    return r;
}

// ---------------------------------------------------------------------------
// The operators
// ---------------------------------------------------------------------------

// K12: the Montgomery product; positions past n hold one.
struct ProdOp {
    FieldParams F;
    __device__ Fe identity() const { return fe_one(F); }
    __device__ Fe pad() const { return fe_one(F); }
    __device__ Fe step(const Fe &carry, const Fe &x) const { return fe_mul(F, carry, x); }
    // lo: the combination of earlier positions (a team level or a lane level)
    __device__ Fe team(int, const Fe &lo, const Fe &hi) const { return fe_mul(F, lo, hi); }
    __device__ Fe lane(int, const Fe &lo, const Fe &hi) const { return fe_mul(F, lo, hi); }
};

// K9: s = x + c s from s = 0; positions past n hold zero. A run of L
// positions maps s to V + c^L s, V its value from 0, so runs of equal
// length combine with one constant a level: c^(sc 2^k) for the team's
// level k, c^(cp 2^k) for the lane scan's. tab (8, tlen), Montgomery:
// c^(i+1) for i < cp, then c^(cp 2^k) for k < 7, then c^(sc 2^k) for k < 5
// (kernels.linear_kernel_table).
struct LinOp {
    FieldParams F;
    Fe c;
    const uint32_t *tab;
    int64_t tlen, cp;
    __device__ Fe identity() const { return fe_zero(); }
    __device__ Fe pad() const { return fe_zero(); }
    __device__ Fe step(const Fe &s, const Fe &x) const { return fe_add(F, x, fe_mul(F, c, s)); }
    __device__ Fe team(int k, const Fe &lo, const Fe &hi) const {
        return fe_add(F, hi, fe_mul(F, fe_load(tab, tlen, cp + 7 + k), lo));
    }
    __device__ Fe lane(int k, const Fe &lo, const Fe &hi) const {
        return fe_add(F, hi, fe_mul(F, fe_load(tab, tlen, cp + k), lo));
    }
    // c^i for 1 <= i <= cp
    __device__ Fe power(int64_t i) const { return fe_load(tab, tlen, i - 1); }
};

__device__ __forceinline__ LinOp lin_op(const FieldParams &F, const uint32_t *tab, int64_t tlen,
                                        int64_t cp) {
    return LinOp{F, fe_load(tab, tlen, 0), tab, tlen, cp};
}

// ---------------------------------------------------------------------------
// The steps of a thread
// ---------------------------------------------------------------------------

// One pass of thread t of the warp over its sub-chunk from `carry`: carry =
// op.step(carry, x_j) at each position (op.pad() past n), through the warp's
// tile SCAN_KT columns at a time. With STORE, each carry goes to o (rows of
// olen, limb stride rows * olen), positions below olen. Returns the carry after
// the sub-chunk (the sub-chunk's total, or a reduce from the identity).
// Every thread of the warp runs the same number of tiles.
template <bool STORE, class Op>
__device__ Fe sub_pass(const Op &op, const ScanWarp &g, const uint32_t *__restrict__ x,
                       uint32_t *__restrict__ o, int64_t olen, uint32_t *tile, int t,
                       Fe carry) {
    const int64_t lo = sub_start(g, t), cnt = sub_len(g, t);
#pragma unroll 1
    for (int64_t k0 = 0; k0 < g.sc; k0 += SCAN_KT) {
        tile_load(g, x, tile, t, k0);
        __syncwarp();
#pragma unroll 1
        for (int col = 0; col < SCAN_KT; ++col) {
            const int64_t k = k0 + col;
            if (k < cnt) {
                carry = op.step(carry, lo + k < g.n ? tile_get(tile, t, col) : op.pad());
                if (STORE) tile_put(tile, t, col, carry);
            }
        }
        __syncwarp();
        if (STORE) {
            tile_store(g, o, olen, tile, t, k0);
            __syncwarp();
        }
    }
    return carry;
}

// Inclusive scan of the team's totals: member s of thread t gets the
// combination of members 0 .. s, by warp shuffles of width S, log2 S
// levels. Every thread of the warp calls it.
template <class Op>
__device__ Fe team_incl(const Op &op, int team_log2, int t, const Fe &tot) {
    const int S = 1 << team_log2, s = t & (S - 1);
    Fe incl = tot;
#pragma unroll 1
    for (int k = 0; k < team_log2; ++k) {
        const int d = 1 << k;
        const Fe o = fe_shfl_up(incl, d, S);
        if (s >= d) incl = op.team(k, o, incl);
    }
    return incl;
}

// The exclusive value from the inclusive one: member s - 1's (op.identity()
// for s = 0). Every thread of the warp calls it.
template <class Op>
__device__ Fe team_shift(const Op &op, int team_log2, int t, const Fe &incl) {
    const int S = 1 << team_log2;
    const Fe e = fe_shfl_up(incl, 1, S);
    return (t & (S - 1)) == 0 ? op.identity() : e;
}

// Exclusive scan of the team's totals: member s of thread t gets the
// combination of members 0 .. s - 1 (op.identity() for s = 0).
template <class Op>
__device__ Fe team_excl(const Op &op, int team_log2, int t, const Fe &tot) {
    return team_shift(op, team_log2, t, team_incl(op, team_log2, t, tot));
}

// K12 phase 1 for thread t of a warp: with a team (TEAM: S > 1), reduce the
// sub-chunk and scan the team's totals; then rescan the sub-chunk from the
// offset, writing partial (rows, PST_LANES * cp) at every position of the
// lane; the last member writes the lane's total to tot (rows, PST_LANES).
// TEAM = false compiles S = 1 apart (one kernel that chose at run time
// kept an 8-byte stack frame).
template <bool TEAM>
__device__ void prod_parts_thread(const FieldParams &F, const ScanWarp &g,
                                  const uint32_t *__restrict__ x, uint32_t *__restrict__ part,
                                  uint32_t *__restrict__ tot, uint32_t *tile, int t) {
    const ProdOp op{F};
    const int64_t plen = PST_LANES * g.cp;
    Fe carry = op.identity();
    if (TEAM) {
        const Fe sub = sub_pass<false>(op, g, x, nullptr, 0, tile, t, carry);
        carry = team_excl(op, g.team_log2, t, sub);
    }
    carry = sub_pass<true>(op, g, x, part, plen, tile, t, carry);
    if (lane_last(g, t))
        fe_store(tot, g.rows * PST_LANES, g.row * PST_LANES + g.lane0 + (t >> g.team_log2), carry);
}

// K9 phase 1 for thread t of a warp: the recurrence over the sub-chunk from
// 0, each local value written to out (rows, n); with a team (TEAM), the
// exclusive scan of the members' values, member s's (its offset T) to
// toff (rows, PST_LANES, S) (the combine's team term); the last member
// writes the lane's value V + c^len T to tot (rows, PST_LANES).
template <bool TEAM>
__device__ void lin_parts_thread(const LinOp &op, const ScanWarp &g,
                                 const uint32_t *__restrict__ x, uint32_t *__restrict__ out,
                                 uint32_t *__restrict__ toff, uint32_t *__restrict__ tot,
                                 uint32_t *tile, int t) {
    const Fe v = sub_pass<true>(op, g, x, out, g.n, tile, t, op.identity());
    const int64_t lane = g.row * PST_LANES + g.lane0 + (t >> g.team_log2);
    Fe e = op.identity();
    if (TEAM) {
        e = team_excl(op, g.team_log2, t, v);
        const int64_t S = (int64_t)1 << g.team_log2;
        fe_store(toff, g.rows * PST_LANES * S, lane * S + team_member(g, t), e);
    }
    if (lane_last(g, t))
        fe_store(tot, g.rows * PST_LANES, lane,
                 fe_add(op.F, v, fe_mul(op.F, op.power(sub_len(g, t)), e)));
}

// Phase 2 of both scans, thread t of the row's PST_LANES: Hillis-Steele
// over the lane values, op.lane(k, v[t - 2^k], v[t]) at level k, through
// sh (2 * PST_NL * PST_LANES words, limb-major, two buffers: one barrier a
// level); returns the exclusive value (op.identity() at t = 0). Every
// thread of the block calls it.
template <class Op>
__device__ Fe lane_excl(const Op &op, int t, Fe v, uint32_t *sh) {
#pragma unroll 1
    for (int k = 0; k < 7; ++k) {
        uint32_t *buf = sh + (k & 1) * PST_NL * PST_LANES;
        fe_store(buf, PST_LANES, t, v);
        __syncthreads();
        const int d = 1 << k;
        if (t >= d) v = op.lane(k, fe_load(buf, PST_LANES, t - d), v);
    }
    uint32_t *buf = sh + PST_NL * PST_LANES;  // level 5's, read before level 6's barrier
    fe_store(buf, PST_LANES, t, v);
    __syncthreads();
    return t > 0 ? fe_load(buf, PST_LANES, t - 1) : op.identity();
}

// ---------------------------------------------------------------------------
// K5: one row in one block
// ---------------------------------------------------------------------------

// K5 for thread t of the block of row `row` of x (rows, n, limb stride rows
// * n): 32 << warps_log2 threads, thread t owning positions [t sc, t sc +
// sc) (op.pad() past n), warp w a ScanWarp of one 32 * sc lane with a team
// of 32. Each thread reduces its sub-chunk; the warp scans its totals by
// shuffles (lanes_log2 levels: 5, fewer where a lone warp's first lanes
// hold the row); with more than one warp, warp 0 scans the warp totals
// through sh (PST_NL * 32 words, limb-major), and each thread combines its
// warp's offset with its own; then each thread rescans its sub-chunk from
// that offset, writing the inclusive scan to o (rows, n). tile: the warp's
// SCAN_TILE_WORDS. Every thread of the block calls it.
template <class Op>
__device__ void prefix_block_thread(const Op &op, const uint32_t *__restrict__ x,
                                    uint32_t *__restrict__ o, int64_t rows, int64_t n,
                                    int64_t sc, int warps_log2, int lanes_log2, int64_t row,
                                    uint32_t *tile, uint32_t *sh, int t) {
    const int w = t / 32, lane = t % 32;
    const ScanWarp g{rows, n, 32 * sc, sc, row, w, 5};
    const Fe tot = sub_pass<false>(op, g, x, nullptr, 0, tile, lane, op.identity());
    const Fe incl = team_incl(op, lanes_log2, lane, tot);
    Fe e = team_shift(op, lanes_log2, lane, incl);
    if (warps_log2 > 0) {  // the same in every thread of the block
        const int W = 1 << warps_log2;
        if (lane == 31) fe_store(sh, 32, w, incl);
        __syncthreads();
        if (w == 0) {
            Fe v = op.identity();
            if (lane < W) v = fe_load(sh, 32, lane);
            v = team_excl(op, warps_log2, lane, v);
            if (lane < W) fe_store(sh, 32, lane, v);
        }
        __syncthreads();
        if (w > 0) e = op.team(0, fe_load(sh, 32, w), e);
    }
    sub_pass<true>(op, g, x, o, n, tile, lane, e);
}

// K9 phase 3 at position i of the (rows, n) output: out = local + c^(j+1)
// E + c^(k+1) T, j the position in the lane, k in the member's sub-chunk, E
// the lane's incoming value (excl, (rows, PST_LANES)), T the member's team
// offset (toff, with a team only).
__device__ __forceinline__ void lin_combine_at(const LinOp &op, int64_t rows, int64_t n,
                                               int64_t sc, int team_log2, uint32_t *out,
                                               const uint32_t *__restrict__ toff,
                                               const uint32_t *__restrict__ excl, int64_t i) {
    const int64_t row = i / n, j = i - row * n, lane = j / op.cp, jl = j - lane * op.cp;
    const int64_t L = row * PST_LANES + lane;
    const Fe e = fe_load(excl, rows * PST_LANES, L);
    Fe r = fe_add(op.F, fe_load(out, rows * n, i), fe_mul(op.F, op.power(jl + 1), e));
    if (team_log2 > 0) {
        const int64_t S = (int64_t)1 << team_log2, m = jl / sc;
        const Fe tm = fe_load(toff, rows * PST_LANES * S, L * S + m);
        r = fe_add(op.F, r, fe_mul(op.F, op.power(jl - m * sc + 1), tm));
    }
    fe_store(out, rows * n, i, r);
}
