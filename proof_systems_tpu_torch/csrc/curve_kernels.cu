// Curve kernels K2 (jacobian_add), K3 (jacobian_double), K6
// (ec_prefix_scan_parts), K7 (ec_prefix_scan_fused), K8 (combine_windows)
// and the IPA fold step's endo ladder, over Vesta's base field Fq (any
// field: the parameters are a kernel argument).
//
// Replaces, in proof_systems_tpu/ops/pallas_field.py:
//   K2 jacobian_add (l.412, _kv_ec_add l.299): complete elementwise add.
//   K3 jacobian_double (l.439, _kv_ec_double l.229): elementwise doubling.
//   K6 ec_prefix_scan_parts (l.1333, _ec_parts_kernel l.1189, _hs_scan_ec
//      l.1261): phases 1-2 of the blocked Jacobian prefix scan. Returns the
//      chunk partials and the exclusive per-chunk offsets, so that the
//      inclusive prefix of position j is excl[j / cp] + partial[j]. With
//      mixed=1 the chunk scan uses madd on affine-encoded input (z in {0, R},
//      as msm.py:338-342 requires) and phase 2 stays general adds.
//   K7 ec_prefix_scan_fused (l.1410, _ec_scan_kernel l.834): phases 1-2
//      plus the combine, giving the full inclusive prefix scan.
//   The endo ladder (proof_systems_tpu/poly_commitment/ipa.py:566, a
//      fori_loop of K2 and K3): [u] P for the IPA's 128-bit challenges.
//   K8 combine_windows_fused (l.560): the Pippenger window recombination
//      sum_w 2^(cw) win_w as a Horner chain from the top window (c doublings
//      and one general add per window, the order of l.596-607), in
//      k8_combine.cuh with its own inlined curve formulas. The TPU kernel's
//      cap of 128 columns was its tile width and is not ported.
//
// Bound on this card: integer multiplies. A general add is 16 Montgomery
// products (11 for madd), each 128 IMAD.WIDE and 8 IMUL, against 192 B of
// operands. The scans are also latency bound: each thread runs its chunk
// sequentially.
//
// K6's kernels call the __noinline__ curve formulas, to bound code size and
// build time; ptxas reports their registers and stack frames. The other
// kernels inline theirs.
//
// K7, redesigned for this card: K6's kernels, then k_ec_combine below. It
// replaces pallas_field.py:1410 (ec_prefix_scan_fused, _ec_scan_kernel
// l.834), which ran the whole scan in one kernel. What bounds K7: the
// integer multiplies of two general adds a position (the chunk scan's and
// the combine's) and the lane scan's 7 adds a lane; at the opening's short
// rows (127-255 positions, cp = 1 or 2) the latency of one thread's chain
// of cp + 7 + 1 dependent adds. The old kernel, one block a row, ran the
// combine as a second sequential chain of cp adds a thread, loaded with a
// stride of cp across a warp, synchronised the block 7 times a row, passed
// every add through the __noinline__ formulas' 264-byte stack frame, and
// with 24 rows used 24 of 132 SMs. The design:
//   - phases 1-2 are K6's kernels, unchanged (general adds: staged
//     coalesced tiles, a team of threads a chunk where the rows fill less
//     than a quarter of the card, the lane scan as its own kernel), which
//     write the partial sums and lane offsets to scratch that the wrapper
//     allocates;
//   - k_ec_combine adds each position's lane offset to its partial sum, one
//     thread a position over rows * n threads, with the inlined complete
//     add (no stack, K2's launch bounds): neighbouring threads read and
//     write neighbouring positions and share their offset.
// Where S = 1 the association order is the plain version's (chunk scan,
// lane scan, then offset + partial), so the limbs agree; with a team (S >
// 1) the group elements do.
//
// K2 and K3, redesigned for this card: one thread an element, running
// field.cuh's inlined formulas (ec_add_inl, ec_double_inl). The old kernels
// called the __noinline__ ec_add and ec_double, which pass their operands
// through a 264-byte stack frame; inlined, nothing goes to local memory.
// What bounds K2: the integer multiplies of its 16 products an element, at
// the large MSM shapes. __launch_bounds__(128, 2) leaves ptxas the
// registers it wants (160); a cap of 128 (four blocks an SM) spills
// (PERF.md).
//
// The endo ladder (k_endo_ladder, endo_ladder.cuh), new on this card: the
// IPA fold step's [u] g_hi, which the port ran as 64 host iterations of two
// selects, one K3 and one K2, and the reference as one fori_loop of them
// (proof_systems_tpu/poly_commitment/ipa.py:566). What bounds it: the
// products, a dependent chain of 1,496 a point (phi(x), then 23 a step),
// run by one thread; at the fold steps' sizes (2,048-32,768 points, 2-8
// warps an SM at 32 threads a block) the chain's latency, not the card's
// multiply rate: the time is the same at every fold size, about 1.7 us a
// product. The kernel's code (36,000 instructions) is part of that: with
// the product's row loop rolled (13,600) it ran 1.5 times faster, and K2
// 10 % slower (PERF.md). A point at infinity runs the add's doubling
// fallback at every step and holds its warp back by 7 products a step.
// What the design does about the host round trips: one launch a fold step
// instead of 130, the 128 challenge bits read from device memory once a
// block into shared memory (the same for every thread, so the selects do
// not diverge), the general add kept (madd would give other Jacobian
// limbs), and 32 threads a block, so that 2,048 points still spread over
// 64 SMs.
//
// K6, redesigned for this card (k_ec_parts + k_ec_lane_offsets below). The
// old K6 ran one block of 128 threads a row, each thread scanning one
// contiguous chunk, and a block-wide scan of the chunk totals. What bounds
// K6 here: the madds themselves, a chain of dependent 8x8-limb products a
// thread, which need about 160 registers (the __noinline__ formulas pass
// their operands through a 264-byte stack frame), so an SM holds 12 warps
// at most; and the memory pattern: with one position a thread a step, each
// warp load and store touched 32 sectors for 4 bytes each, and the stores
// to the card-wide set of open output lines did not merge in L2. What the
// design does about it:
//   - loads and stores go through shared memory: a warp copies KT columns
//     of its 32 sub-chunks at a time, so each store instruction writes
//     KT-word runs (KT = 16: 64-byte runs), and each thread reads and
//     writes its own positions there;
//   - one thread still scans one contiguous chunk when the rows alone fill
//     the card (S = 1: no extra work, the plain version's limbs); with few
//     rows (the z commit and the verifier, 24 rows) a team of S threads
//     shares each chunk: each reduces its sub-chunk, the team takes an
//     exclusive scan of the S totals through warp shuffles (general adds),
//     and each rescans its sub-chunk from its offset (about twice the
//     madds, on S times the threads). Splitting where the rows already fill
//     the card only doubles the work. The wrapper derives S and KT from the
//     shape (kernels.parts_geometry; scripts/torch_k6_bench.py times every
//     choice);
//   - __launch_bounds__ caps the registers at 168, three blocks an SM; KT =
//     16 fills the shared memory with one block of 128 threads, whose
//     64-byte runs more than pay for the fewer resident warps;
//   - S = 1 is compiled apart from the team code (TEAM = false), which
//     keeps its stack frame at 264 bytes instead of about 700;
//   - the exclusive scan of each row's 128 lane totals is a second, small
//     kernel (one block a row, 7 levels of general adds); the wrapper's
//     launch count still counts calls, one a call.
// The result is the same group elements as the plain version's; the
// Jacobian limbs differ when S > 1 (another association order).
//
// K8, redesigned for this card (k_combine_windows below, k8_combine.cuh).
// What bounds it: the latency of one dependent chain, not the integer rate.
// On the main path a call has one or two columns, each a Horner chain of
// 2,100-2,400 Montgomery products, each waiting for the one before it; the
// old kernel ran a chain in one thread through the __noinline__ formulas at
// about 1.1 us a product. The design: one warp a column; the independent
// products of each formula side by side on 4 lanes (3 levels a doubling, 5
// an add: 26 levels a Horner step at c = 7 instead of 65 products); all
// inlined, no stack; the chain starts from the top window.

#include <atomic>

#include "endo_ladder.cuh"
#include "k8_combine.cuh"

__global__ void __launch_bounds__(128, 2)
    k_jacobian_add(FieldParams F, const uint32_t *px, const uint32_t *py, const uint32_t *pz,
                   const uint32_t *qx, const uint32_t *qy, const uint32_t *qz, uint32_t *ox,
                   uint32_t *oy, uint32_t *oz, int64_t n) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Jac r = ec_add_inl(F, jac_load(px, py, pz, n, i), jac_load(qx, qy, qz, n, i));
    jac_store(ox, oy, oz, n, i, r);
}

__global__ void __launch_bounds__(128)
    k_jacobian_double(FieldParams F, const uint32_t *px, const uint32_t *py,
                      const uint32_t *pz, uint32_t *ox, uint32_t *oy, uint32_t *oz,
                      int64_t n) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    jac_store(ox, oy, oz, n, i, ec_double_inl(F, jac_load(px, py, pz, n, i)));
}

// The endo ladder (endo_ladder.cuh): one thread a point of g_hi, the 128
// challenge bits staged once a block in shared memory (every thread reads
// the same word, so the selects do not diverge).
#define LADDER_THREADS 32

__global__ void __launch_bounds__(LADDER_THREADS)
    k_endo_ladder(FieldParams F, Fe endo_q, const uint32_t *x, const uint32_t *y,
                  const uint32_t *z, const int32_t *bits, uint32_t *ox, uint32_t *oy,
                  uint32_t *oz, int64_t n) {
    __shared__ uint32_t sbits[128];
    for (int k = threadIdx.x; k < 128; k += LADDER_THREADS) sbits[k] = (uint32_t)bits[k];
    __syncthreads();
    int64_t i = (int64_t)blockIdx.x * LADDER_THREADS + threadIdx.x;
    if (i >= n) return;
    jac_store(ox, oy, oz, n, i, endo_ladder_point(F, jac_load(x, y, z, n, i), endo_q, sbits));
}

// K6 phase 1. Rows of length n (limb stride rows * n); lane L of a row owns
// positions [L * cp, L * cp + cp), and a team of S = 1 << team_log2 threads
// shares it: member s owns the sub-chunk [s * sc, s * sc + sc) of the lane,
// sc = ceil(cp / S). A block is PARTS_WARPS warps, a warp 32 / S lanes of
// one row. partial (rows, PST_LANES * cp) is written at every position (the
// input past n is the identity); the lane totals go to (tx, ty, tz), (rows,
// PST_LANES), for k_ec_lane_offsets.
#define PARTS_WARPS 4

__device__ __forceinline__ Jac jac_shfl_up(const Jac &a, int d, int width) {
    Jac r;
#pragma unroll
    for (int l = 0; l < PST_NL; ++l) {
        r.x.v[l] = __shfl_up_sync(0xffffffffu, a.x.v[l], d, width);
        r.y.v[l] = __shfl_up_sync(0xffffffffu, a.y.v[l], d, width);
        r.z.v[l] = __shfl_up_sync(0xffffffffu, a.z.v[l], d, width);
    }
    return r;
}

// TEAM = false compiles S = 1 alone: no team code, fewer live registers.
template <bool MIXED, int KT, bool TEAM>
__global__ void __launch_bounds__(32 * PARTS_WARPS, 3)
    k_ec_parts(FieldParams F, const uint32_t *x, const uint32_t *y, const uint32_t *z,
               uint32_t *ox, uint32_t *oy, uint32_t *oz, uint32_t *tx, uint32_t *ty,
               uint32_t *tz, int64_t rows, int64_t n, int64_t cp, int team_log2_arg) {
    // a warp's tile: word a (coordinate a / 8, limb a % 8) of column col of
    // thread m's sub-chunk at (a * 32 + m) * (KT + 1) + col; the odd row
    // length keeps a thread's own reads free of bank conflicts
    constexpr int KP = KT + 1;
    extern __shared__ uint32_t smem[];
    const int team_log2 = TEAM ? team_log2_arg : 0;
    const int S = 1 << team_log2;
    const int w = threadIdx.x / 32, t = threadIdx.x % 32, s = t & (S - 1);
    uint32_t *tile = smem + w * (24 * 32 * KP);
    const int64_t lane0 = ((int64_t)blockIdx.x * PARTS_WARPS + w) * (32 >> team_log2);
    if (lane0 >= rows * PST_LANES) return;
    const int64_t row = lane0 / PST_LANES, lane_r = lane0 % PST_LANES;
    const int64_t in_stride = rows * n, in_base = row * n;
    const int64_t olen = PST_LANES * cp, out_stride = rows * olen, out_base = row * olen;
    const int64_t sc = (cp + S - 1) >> team_log2;
    // first position (in the row) and length of thread m's sub-chunk
    auto start = [&](int m) {
        return (lane_r + (m >> team_log2)) * cp + (int64_t)(m & (S - 1)) * sc;
    };
    auto len = [&](int m) {
        int64_t a = (int64_t)(m & (S - 1)) * sc, b = a + sc < cp ? a + sc : cp;
        return b > a ? b - a : (int64_t)0;
    };
    const int64_t lo = start(t), cnt = len(t);

    // coalesced copies of columns [k0, k0 + KT) of the warp's 32 sub-chunks
    auto load_tile = [&](int64_t k0) {
        int64_t pos[KT];
        bool ok[KT];
#pragma unroll
        for (int i = 0; i < KT; ++i) {
            int idx = t + 32 * i, m = idx / KT, col = idx % KT;
            pos[i] = start(m) + k0 + col;
            ok[i] = k0 + col < len(m) && pos[i] < n;
        }
#pragma unroll 1
        for (int a = 0; a < 24; ++a) {
            const uint32_t *src = (a < 8 ? x : a < 16 ? y : z) + (a & 7) * in_stride + in_base;
#pragma unroll
            for (int i = 0; i < KT; ++i) {
                int idx = t + 32 * i;
                if (ok[i]) tile[(a * 32 + idx / KT) * KP + idx % KT] = src[pos[i]];
            }
        }
    };
    auto store_tile = [&](int64_t k0) {
        int64_t pos[KT];
        bool ok[KT];
#pragma unroll
        for (int i = 0; i < KT; ++i) {
            int idx = t + 32 * i, m = idx / KT, col = idx % KT;
            pos[i] = start(m) + k0 + col;
            ok[i] = k0 + col < len(m);
        }
#pragma unroll 1
        for (int a = 0; a < 24; ++a) {
            uint32_t *dst = (a < 8 ? ox : a < 16 ? oy : oz) + (a & 7) * out_stride + out_base;
#pragma unroll
            for (int i = 0; i < KT; ++i) {
                int idx = t + 32 * i;
                if (ok[i]) dst[pos[i]] = tile[(a * 32 + idx / KT) * KP + idx % KT];
            }
        }
    };
    auto read = [&](int col) {
        Jac v;
#pragma unroll
        for (int l = 0; l < PST_NL; ++l) {
            v.x.v[l] = tile[(l * 32 + t) * KP + col];
            v.y.v[l] = tile[((8 + l) * 32 + t) * KP + col];
            v.z.v[l] = tile[((16 + l) * 32 + t) * KP + col];
        }
        return v;
    };
    auto write = [&](int col, const Jac &v) {
#pragma unroll
        for (int l = 0; l < PST_NL; ++l) {
            tile[(l * 32 + t) * KP + col] = v.x.v[l];
            tile[((8 + l) * 32 + t) * KP + col] = v.y.v[l];
            tile[((16 + l) * 32 + t) * KP + col] = v.z.v[l];
        }
    };

    Jac carry = jac_identity();
    if constexpr (TEAM) {
        // (a) reduce the sub-chunk, storing nothing
        Jac tot = jac_identity();
        bool started = false;
        for (int64_t k0 = 0; k0 < sc; k0 += KT) {
            load_tile(k0);
            __syncwarp();
            for (int col = 0; col < KT; ++col) {
                int64_t k = k0 + col;
                if (k < cnt && lo + k < n) {
                    Jac v = read(col);
                    tot = !started ? v : MIXED ? ec_madd(F, tot, v) : ec_add(F, tot, v);
                    started = true;
                }
            }
            __syncwarp();
        }
        // (b) exclusive scan of the team's totals, general adds
        Jac incl = tot;
        for (int d = 1; d < S; d <<= 1) {
            Jac o = jac_shfl_up(incl, d, S);
            if (s >= d) incl = ec_add(F, o, incl);
        }
        carry = jac_shfl_up(incl, 1, S);
        if (s == 0) carry = jac_identity();
    }
    // (c) scan the sub-chunk from its offset, storing every position; member
    //     0 starts from the identity, and identity + v is v exactly
    for (int64_t k0 = 0; k0 < sc; k0 += KT) {
        load_tile(k0);
        __syncwarp();
        for (int col = 0; col < KT; ++col) {
            int64_t k = k0 + col;
            if (k < cnt) {
                if (lo + k < n) {
                    Jac v = read(col);
                    carry = MIXED ? ec_madd(F, carry, v) : ec_add(F, carry, v);
                }
                write(col, carry);
            }
        }
        __syncwarp();
        store_tile(k0);
        __syncwarp();
    }
    // the last member's carry is the lane total
    if (s == S - 1)
        jac_store(tx, ty, tz, rows * PST_LANES, lane0 + (t >> team_log2), carry);
}

// K6 phase 2: exclusive Hillis-Steele over each row's PST_LANES lane totals,
// general adds, the identity shifted in (_hs_scan_ec), in place in
// (ex, ey, ez), (rows, PST_LANES). One block a row.
__global__ void __launch_bounds__(PST_LANES)
    k_ec_lane_offsets(FieldParams F, uint32_t *ex, uint32_t *ey, uint32_t *ez, int64_t rows) {
    __shared__ Jac sh[PST_LANES];
    const int t = threadIdx.x;
    const int64_t stride = rows * PST_LANES, i = (int64_t)blockIdx.x * PST_LANES + t;
    sh[t] = jac_load(ex, ey, ez, stride, i);
    __syncthreads();
    Jac excl = t > 0 ? sh[t - 1] : jac_identity();
    __syncthreads();
    sh[t] = excl;
    __syncthreads();
    for (int s = 1; s < PST_LANES; s <<= 1) {
        Jac other = t >= s ? sh[t - s] : jac_identity();
        __syncthreads();
        excl = ec_add(F, excl, other);
        sh[t] = excl;
        __syncthreads();
    }
    jac_store(ex, ey, ez, stride, i, excl);
}

// K7 phase 3: out[row, j] = excl[row, j / cp] + partial[row, j] for j < n,
// one thread a position over the (rows, n) output, the inlined complete add
// (K2's formula and launch bounds). partial is K6's (rows, PST_LANES * cp),
// excl its (rows, PST_LANES); the padding past n is not read.
__global__ void __launch_bounds__(128, 2)
    k_ec_combine(FieldParams F, const uint32_t *px, const uint32_t *py, const uint32_t *pz,
                 const uint32_t *ex, const uint32_t *ey, const uint32_t *ez, uint32_t *ox,
                 uint32_t *oy, uint32_t *oz, int64_t rows, int64_t n, int64_t cp) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rows * n) return;
    const int64_t row = i / n, j = i - row * n, plen = PST_LANES * cp;
    Jac off = jac_load(ex, ey, ez, rows * PST_LANES, row * PST_LANES + j / cp);
    Jac part = jac_load(px, py, pz, rows * plen, row * plen + j);
    jac_store(ox, oy, oz, rows * n, i, ec_add_inl(F, off, part));
}

typedef void (*EcPartsFn)(FieldParams, const uint32_t *, const uint32_t *, const uint32_t *,
                          uint32_t *, uint32_t *, uint32_t *, uint32_t *, uint32_t *,
                          uint32_t *, int64_t, int64_t, int64_t, int);

// The K6 instantiations, mixed or general: one thread a chunk with tile
// width 4 or 16, or a team of S > 1 threads with tile width 4.
static EcPartsFn ec_parts_fn(int team_log2, int kt, int mixed) {
    if (team_log2 > 0)
        return kt == 4 ? (mixed ? k_ec_parts<true, 4, true> : k_ec_parts<false, 4, true>)
                       : nullptr;
    if (kt == 4) return mixed ? k_ec_parts<true, 4, false> : k_ec_parts<false, 4, false>;
    if (kt == 16) return mixed ? k_ec_parts<true, 16, false> : k_ec_parts<false, 16, false>;
    return nullptr;
}

static int ec_parts_smem(int kt) { return PARTS_WARPS * 24 * 32 * (kt + 1) * 4; }

// Whether k_ec_parts is built for (team_log2, kt, mixed).
static bool ec_parts_valid(int team_log2, int kt, int mixed) {
    return team_log2 >= 0 && team_log2 <= 4 && ec_parts_fn(team_log2, kt, mixed) != nullptr;
}

// Raises k_ec_parts' dynamic shared memory limit to what it uses, once per
// instantiation and device (the call costs host time, and a loop that waits
// for the host pays it on every launch otherwise).
static cudaError_t ec_parts_prepare(int team_log2, int kt, int mixed) {
    static std::atomic<uint64_t> ready[6];  // a bit per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    std::atomic<uint64_t> &done = ready[(team_log2 > 0 ? 4 : kt == 16 ? 2 : 0) + mixed];
    const uint64_t bit = dev < 64 ? 1ull << dev : 0;
    if (bit & done.load(std::memory_order_relaxed)) return cudaSuccess;
    e = cudaFuncSetAttribute((const void *)ec_parts_fn(team_log2, kt, mixed),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, ec_parts_smem(kt));
    if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
    return e;
}

// K6's two launches (phases 1-2) on rows of n, for a valid geometry: the
// partial sums into (px, py, pz), the lane offsets into (ex, ey, ez).
// Returns the first error.
static cudaError_t ec_parts_run(FieldParams F, const uint32_t *x, const uint32_t *y,
                                const uint32_t *z, uint32_t *px, uint32_t *py, uint32_t *pz,
                                uint32_t *ex, uint32_t *ey, uint32_t *ez, int64_t rows,
                                int64_t n, int64_t cp, int mixed, int team_log2, int kt,
                                cudaStream_t s) {
    EcPartsFn fn = ec_parts_fn(team_log2, kt, mixed);
    int smem = ec_parts_smem(kt);
    cudaError_t e = ec_parts_prepare(team_log2, kt, mixed);
    if (e != cudaSuccess) return e;
    // rows * PST_LANES lanes, 32 * PARTS_WARPS >> team_log2 lanes a block
    fn<<<(unsigned)(rows << team_log2), 32 * PARTS_WARPS, smem, s>>>(
        F, x, y, z, px, py, pz, ex, ey, ez, rows, n, cp, team_log2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    k_ec_lane_offsets<<<(unsigned)rows, PST_LANES, 0, s>>>(F, ex, ey, ez, rows);
    return cudaGetLastError();
}

// K8: one warp a column (k8_combine.cuh), K8_WARPS columns a block.
__global__ void __launch_bounds__(32 * K8_WARPS, 1)
    k_combine_windows(FieldParams F, const uint32_t *wx, const uint32_t *wy, const uint32_t *wz,
                      uint32_t *ox, uint32_t *oy, uint32_t *oz, int64_t W, int64_t b, int c) {
    const int64_t col = (int64_t)blockIdx.x * K8_WARPS + threadIdx.x / 32;
    if (col >= b) return;  // whole warps
    k8_combine_column(F, wx, wy, wz, ox, oy, oz, W, b, c, col, threadIdx.x % 32);
}

extern "C" {

int pst_jacobian_add(const uint32_t *fp, const uint32_t *px, const uint32_t *py,
                     const uint32_t *pz, const uint32_t *qx, const uint32_t *qy,
                     const uint32_t *qz, uint32_t *ox, uint32_t *oy, uint32_t *oz, int64_t n,
                     void *stream) {
    if (n > 0) {
        int64_t blocks = (n + 127) / 128;
        k_jacobian_add<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), px, py, pz, qx, qy, qz, ox, oy, oz, n);
    }
    return (int)cudaGetLastError();
}

int pst_jacobian_double(const uint32_t *fp, const uint32_t *px, const uint32_t *py,
                        const uint32_t *pz, uint32_t *ox, uint32_t *oy, uint32_t *oz,
                        int64_t n, void *stream) {
    if (n > 0) {
        int64_t blocks = (n + 127) / 128;
        k_jacobian_double<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), px, py, pz, ox, oy, oz, n);
    }
    return (int)cudaGetLastError();
}

// The endo ladder over n points of g_hi; endo_q: 8 host words (Montgomery).
int pst_endo_ladder(const uint32_t *fp, const uint32_t *endo_q, const uint32_t *x,
                    const uint32_t *y, const uint32_t *z, const int32_t *bits, uint32_t *ox,
                    uint32_t *oy, uint32_t *oz, int64_t n, void *stream) {
    if (n > 0) {
        Fe e;
        std::memcpy(e.v, endo_q, sizeof(e.v));
        int64_t blocks = (n + LADDER_THREADS - 1) / LADDER_THREADS;
        k_endo_ladder<<<(unsigned)blocks, LADDER_THREADS, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), e, x, y, z, bits, ox, oy, oz, n);
    }
    return (int)cudaGetLastError();
}

// K6: team_log2 in [0, 4]; kt 4 or, with team_log2 = 0, 16
// (kernels.parts_geometry).
int pst_ec_scan_parts(const uint32_t *fp, const uint32_t *x, const uint32_t *y,
                      const uint32_t *z, uint32_t *px, uint32_t *py, uint32_t *pz,
                      uint32_t *ex, uint32_t *ey, uint32_t *ez, int64_t rows, int64_t n,
                      int64_t cp, int mixed, int team_log2, int kt, void *stream) {
    if (!ec_parts_valid(team_log2, kt, mixed)) return (int)cudaErrorInvalidValue;
    if (rows > 0 && n > 0) {
        cudaError_t e = ec_parts_run(pst_field_params(fp), x, y, z, px, py, pz, ex, ey, ez,
                                     rows, n, cp, mixed, team_log2, kt, (cudaStream_t)stream);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

// Registers, local (stack) bytes, static and dynamic shared memory of a K6
// kernel: k_ec_parts of (team_log2, kt, mixed), or k_ec_lane_offsets when
// kt = 0.
int pst_ec_scan_parts_attrs(int team_log2, int kt, int mixed, int *out) {
    const void *fn = kt == 0 ? (const void *)k_ec_lane_offsets
                             : (const void *)ec_parts_fn(team_log2, kt, mixed);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, fn);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = kt == 0 ? 0 : ec_parts_smem(kt);
    return (int)e;
}

// K7: K6's kernels, general adds, with team_log2 and kt as for
// pst_ec_scan_parts, write the partial sums, (rows, PST_LANES * cp) a limb,
// and the lane offsets, (rows, PST_LANES) a limb, into the caller's scratch
// (x, y, z partial sums, then x, y, z offsets: 3 * PST_NL * rows *
// PST_LANES * (cp + 1) words, kernels.ec_scan_scratch); then k_ec_combine
// writes the (rows, n) inclusive prefix to out (x, y, z, PST_NL * rows * n
// words each).
int pst_ec_scan_fused(const uint32_t *fp, const uint32_t *x, const uint32_t *y,
                      const uint32_t *z, uint32_t *scratch, uint32_t *out, int64_t rows,
                      int64_t n, int64_t cp, int team_log2, int kt, void *stream) {
    if (!ec_parts_valid(team_log2, kt, 0)) return (int)cudaErrorInvalidValue;
    if (rows > 0 && n > 0) {
        FieldParams F = pst_field_params(fp);
        cudaStream_t s = (cudaStream_t)stream;
        const int64_t pn = PST_NL * rows * PST_LANES * cp, en = PST_NL * rows * PST_LANES,
                      on = PST_NL * rows * n;
        uint32_t *px = scratch, *py = px + pn, *pz = py + pn;
        uint32_t *ex = pz + pn, *ey = ex + en, *ez = ey + en;
        cudaError_t e =
            ec_parts_run(F, x, y, z, px, py, pz, ex, ey, ez, rows, n, cp, 0, team_log2, kt, s);
        if (e != cudaSuccess) return (int)e;
        int64_t blocks = (rows * n + 127) / 128;
        k_ec_combine<<<(unsigned)blocks, 128, 0, s>>>(F, px, py, pz, ex, ey, ez, out, out + on,
                                                      out + 2 * on, rows, n, cp);
    }
    return (int)cudaGetLastError();
}

int pst_combine_windows(const uint32_t *fp, const uint32_t *wx, const uint32_t *wy,
                        const uint32_t *wz, uint32_t *ox, uint32_t *oy, uint32_t *oz,
                        int64_t W, int64_t b, int c, void *stream) {
    if (W > 0 && b > 0) {
        int64_t blocks = (b + K8_WARPS - 1) / K8_WARPS;
        k_combine_windows<<<(unsigned)blocks, 32 * K8_WARPS, 0, (cudaStream_t)stream>>>(
            pst_field_params(fp), wx, wy, wz, ox, oy, oz, W, b, c);
    }
    return (int)cudaGetLastError();
}

static int func_attrs(const void *fn, int *out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, fn);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = 0;
    return (int)e;
}

// Registers, local (stack) bytes, static and dynamic shared memory of
// K7's combine kernel (its scan kernels are K6's).
int pst_ec_scan_fused_attrs(int *out) { return func_attrs((const void *)k_ec_combine, out); }

// Registers, local (stack) bytes, static and dynamic shared memory of K8.
int pst_combine_windows_attrs(int *out) { return func_attrs((const void *)k_combine_windows, out); }

// The same for k_jacobian_add (which 0), k_jacobian_double (1) or
// k_endo_ladder (2).
int pst_group_law_attrs(int which, int *out) {
    const void *fn = which == 0   ? (const void *)k_jacobian_add
                     : which == 1 ? (const void *)k_jacobian_double
                     : which == 2 ? (const void *)k_endo_ladder
                                  : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return func_attrs(fn, out);
}

const char *pst_curve_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
