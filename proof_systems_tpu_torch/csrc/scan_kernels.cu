// K5 (mont_prefix_scan), K12 (mont_prefix_scan_parts) and K9
// (linear_scan) on scan_field.cuh: their kernels and launchers, compiled as
// a unit of their own. What they replace and their design: the header of
// field_kernels.cu and of scan_field.cuh.

#include "inv_field.cuh"
#include "scan_field.cuh"

// K5 (prefix_block_thread, scan_field.cuh, on chain_field.cuh's product):
// one block of 32 << warps_log2 threads a row of x (rows, n), thread t
// owning positions [t sc, t sc + sc); the warps' tiles in dynamic shared
// memory. At most PREFIX_THREADS threads: at 1,024 (64 registers a thread)
// the product spilled to the stack.
#define PREFIX_THREADS 512
__global__ void __launch_bounds__(PREFIX_THREADS)
    k_mont_prefix(FieldParams F, const uint32_t *__restrict__ x, uint32_t *__restrict__ o,
                  int64_t rows, int64_t n, int64_t sc, int warps_log2, int lanes_log2) {
    extern __shared__ uint32_t tiles[];
    __shared__ uint32_t sh[PST_NL * 32];
    const int t = threadIdx.x;
    prefix_block_thread(ProdLatOp{F}, x, o, rows, n, sc, warps_log2, lanes_log2, blockIdx.x,
                        tiles + (t / 32) * SCAN_TILE_WORDS, sh, t);
}

// K12 and K9 (scan_field.cuh). Phase 1: SCAN_WARPS warps a block, each 32 /
// S lanes of one row, S = 1 << team_log2 threads a lane; TEAM = false
// compiles S = 1 alone. Phase 2: one block of PST_LANES threads a row.
template <bool TEAM>
__global__ void __launch_bounds__(32 * SCAN_WARPS)
    k_prod_parts(FieldParams F, const uint32_t *__restrict__ x, uint32_t *__restrict__ part,
                 uint32_t *__restrict__ tot, int64_t rows, int64_t n, int64_t cp, int team_log2) {
    __shared__ uint32_t tiles[SCAN_WARPS * SCAN_TILE_WORDS];
    const int w = threadIdx.x / 32;
    ScanWarp g;
    if (!scan_warp(g, rows, n, cp, TEAM ? team_log2 : 0, (int64_t)blockIdx.x * SCAN_WARPS + w))
        return;  // whole warps
    prod_parts_thread<TEAM>(F, g, x, part, tot, tiles + w * SCAN_TILE_WORDS, threadIdx.x % 32);
}

// In place over the lane totals tot (rows, PST_LANES): their exclusive
// products.
__global__ void __launch_bounds__(PST_LANES)
    k_prod_lanes(FieldParams F, uint32_t *__restrict__ tot, int64_t rows) {
    __shared__ uint32_t sh[2 * PST_NL * PST_LANES];
    const int t = threadIdx.x;
    const int64_t i = (int64_t)blockIdx.x * PST_LANES + t;
    const Fe v = fe_load(tot, rows * PST_LANES, i);
    fe_store(tot, rows * PST_LANES, i, lane_excl(ProdOp{F}, t, v, sh));
}

template <bool TEAM>
__global__ void __launch_bounds__(32 * SCAN_WARPS)
    k_lin_parts(FieldParams F, const uint32_t *__restrict__ x, const uint32_t *__restrict__ tab,
                int64_t tlen, uint32_t *__restrict__ out, uint32_t *__restrict__ toff,
                uint32_t *__restrict__ tot, int64_t rows, int64_t n, int64_t cp, int team_log2) {
    __shared__ uint32_t tiles[SCAN_WARPS * SCAN_TILE_WORDS];
    const int w = threadIdx.x / 32;
    ScanWarp g;
    if (!scan_warp(g, rows, n, cp, TEAM ? team_log2 : 0, (int64_t)blockIdx.x * SCAN_WARPS + w))
        return;
    lin_parts_thread<TEAM>(lin_op(F, tab, tlen, cp), g, x, out, toff, tot,
                           tiles + w * SCAN_TILE_WORDS, threadIdx.x % 32);
}

// In place over the lane values tot (rows, PST_LANES): each lane's incoming
// value E_l = S_(l-1) of S_l = V_l + c^cp S_(l-1).
__global__ void __launch_bounds__(PST_LANES)
    k_lin_lanes(FieldParams F, const uint32_t *__restrict__ tab, int64_t tlen, int64_t cp,
                uint32_t *__restrict__ tot, int64_t rows) {
    __shared__ uint32_t sh[2 * PST_NL * PST_LANES];
    const int t = threadIdx.x;
    const int64_t i = (int64_t)blockIdx.x * PST_LANES + t;
    const Fe v = fe_load(tot, rows * PST_LANES, i);
    fe_store(tot, rows * PST_LANES, i, lane_excl(lin_op(F, tab, tlen, cp), t, v, sh));
}

// One thread a position of the (rows, n) output.
__global__ void __launch_bounds__(256)
    k_lin_combine(FieldParams F, const uint32_t *__restrict__ tab, int64_t tlen, int64_t cp,
                  int64_t sc, int team_log2, uint32_t *out, const uint32_t *__restrict__ toff,
                  const uint32_t *__restrict__ excl, int64_t rows, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rows * n) return;
    lin_combine_at(lin_op(F, tab, tlen, cp), rows, n, sc, team_log2, out, toff, excl, i);
}

// Blocks of phase 1: rows * PST_LANES lanes of S threads, SCAN_WARPS warps a
// block.
static unsigned scan_blocks(int64_t rows, int team_log2) {
    const int64_t warps = (rows * PST_LANES << team_log2) / 32;
    return (unsigned)((warps + SCAN_WARPS - 1) / SCAN_WARPS);
}

static bool scan_team_valid(int team_log2) { return team_log2 >= 0 && team_log2 <= 5; }

// Lets k_mont_prefix take the dynamic shared memory of PREFIX_THREADS
// threads' tiles, once a device.
static cudaError_t mont_prefix_ready() {
    static bool done[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || dev < 0 || dev >= 64 || done[dev]) return e;
    e = cudaFuncSetAttribute(k_mont_prefix, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SCAN_TILE_WORDS * 4 * (PREFIX_THREADS / 32));
    done[dev] = e == cudaSuccess;
    return e;
}

extern "C" {

// K5 with 32 << warps_log2 threads a block (warps_log2 in [0, 4]), sc
// positions a thread, lanes_log2 levels of the warp scan (5 with more than
// one warp); the Pasta moduli only.
int pst_mont_prefix(const uint32_t *fp, const uint32_t *x, uint32_t *o, int64_t rows,
                    int64_t n, int64_t sc, int warps_log2, int lanes_log2, void *stream) {
    const FieldParams F = pst_field_params(fp);
    if (!pst_pasta_shape(F) || (32 << warps_log2) > PREFIX_THREADS || warps_log2 < 0 ||
        lanes_log2 < 0 || lanes_log2 > 5 || (warps_log2 > 0 && lanes_log2 != 5) || sc < 1 ||
        (sc << (5 + warps_log2)) < n)
        return (int)cudaErrorInvalidValue;
    if (rows <= 0 || n <= 0) return 0;
    const cudaError_t e = mont_prefix_ready();
    if (e != cudaSuccess) return (int)e;
    k_mont_prefix<<<(unsigned)rows, 32 << warps_log2, (SCAN_TILE_WORDS * 4) << warps_log2,
                    (cudaStream_t)stream>>>(F, x, o, rows, n, sc, warps_log2, lanes_log2);
    return (int)cudaGetLastError();
}

// K12: the partial products into part (rows, PST_LANES * cp), the
// exclusive products of the lane totals into excl (rows, PST_LANES); teams
// of 1 << team_log2 threads, team_log2 in [0, 5] (kernels.field_scan_team).
int pst_mont_prefix_parts(const uint32_t *fp, const uint32_t *x, uint32_t *part,
                          uint32_t *excl, int64_t rows, int64_t n, int64_t cp, int team_log2,
                          void *stream) {
    if (!scan_team_valid(team_log2)) return (int)cudaErrorInvalidValue;
    if (rows > 0 && n > 0) {
        const FieldParams F = pst_field_params(fp);
        const cudaStream_t s = (cudaStream_t)stream;
        const auto parts = team_log2 ? k_prod_parts<true> : k_prod_parts<false>;
        parts<<<scan_blocks(rows, team_log2), 32 * SCAN_WARPS, 0, s>>>(F, x, part, excl, rows, n,
                                                                       cp, team_log2);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        k_prod_lanes<<<(unsigned)rows, PST_LANES, 0, s>>>(F, excl, rows);
    }
    return (int)cudaGetLastError();
}

// K9: tab (8, tlen) of kernels.linear_kernel_table for (c, cp, sc); scratch
// PST_NL * rows * PST_LANES * (S + 1) words: the team offsets (rows,
// PST_LANES, S) limb-major, then the lane values (rows, PST_LANES).
int pst_linear_scan(const uint32_t *fp, const uint32_t *x, const uint32_t *tab, int64_t tlen,
                    uint32_t *scratch, uint32_t *o, int64_t rows, int64_t n, int64_t cp,
                    int team_log2, void *stream) {
    if (!scan_team_valid(team_log2)) return (int)cudaErrorInvalidValue;
    if (rows > 0 && n > 0) {
        const FieldParams F = pst_field_params(fp);
        const cudaStream_t s = (cudaStream_t)stream;
        const int64_t sc = (cp + (1 << team_log2) - 1) >> team_log2;
        uint32_t *toff = scratch, *tot = scratch + (PST_NL * rows * PST_LANES << team_log2);
        const auto parts = team_log2 ? k_lin_parts<true> : k_lin_parts<false>;
        parts<<<scan_blocks(rows, team_log2), 32 * SCAN_WARPS, 0, s>>>(F, x, tab, tlen, o, toff,
                                                                       tot, rows, n, cp, team_log2);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        k_lin_lanes<<<(unsigned)rows, PST_LANES, 0, s>>>(F, tab, tlen, cp, tot, rows);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        k_lin_combine<<<(unsigned)((rows * n + 255) / 256), 256, 0, s>>>(
            F, tab, tlen, cp, sc, team_log2, o, toff, tot, rows, n);
    }
    return (int)cudaGetLastError();
}

// Registers, local (stack) bytes, static and dynamic shared memory of K12's,
// K9's and K5's kernels: k_prod_parts<false> (which 0), k_prod_parts<true>
// (1), k_prod_lanes (2), k_lin_parts<false> (3), k_lin_parts<true> (4),
// k_lin_lanes (5), k_lin_combine (6), k_mont_prefix (7).
int pst_scan_attrs(int which, int *out) {
    const void *fns[] = {(const void *)k_prod_parts<false>, (const void *)k_prod_parts<true>,
                         (const void *)k_prod_lanes,        (const void *)k_lin_parts<false>,
                         (const void *)k_lin_parts<true>,   (const void *)k_lin_lanes,
                         (const void *)k_lin_combine,       (const void *)k_mont_prefix};
    if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0])))
        return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fns[which]);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = 0;
    return (int)e;
}

}  // extern "C"
