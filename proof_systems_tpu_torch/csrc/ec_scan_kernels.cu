// K6 (ec_prefix_scan_parts) and K7 (ec_prefix_scan_fused: K6's kernels,
// then k_ec_combine): their kernels and launchers, compiled as a unit of
// their own. What they replace and their design: the header of
// curve_kernels.cu.

#include <atomic>

#include "field.cuh"

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

static int func_attrs(const void *fn, int *out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, fn);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = 0;
    return (int)e;
}

extern "C" {

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

// Registers, local (stack) bytes, static and dynamic shared memory of
// K7's combine kernel (its scan kernels are K6's).
int pst_ec_scan_fused_attrs(int *out) { return func_attrs((const void *)k_ec_combine, out); }

}  // extern "C"
