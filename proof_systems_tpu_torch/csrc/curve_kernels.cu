// Curve kernels K2 (jacobian_add), K3 (jacobian_double), K6
// (ec_prefix_scan_parts), K7 (ec_prefix_scan_fused), K8 (combine_windows)
// and the IPA fold step's endo ladder, over Vesta's base field Fq (any
// field: the parameters are a kernel argument). This file holds K2 and K3;
// ladder_kernels.cu holds the endo ladder, ec_scan_kernels.cu K6 and K7,
// and k8_kernels.cu K8. Each file is its own nvcc process, all started
// together, linked into one library (ops/kernels.py).
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

#include "field.cuh"

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

// The endo ladder's attributes (ladder_kernels.cu).
int pst_ladder_attrs(int *out);

// Registers, local (stack) bytes, static and dynamic shared memory of
// k_jacobian_add (which 0), k_jacobian_double (1) or k_endo_ladder (2).
int pst_group_law_attrs(int which, int *out) {
    if (which == 2) return pst_ladder_attrs(out);
    const void *fn = which == 0   ? (const void *)k_jacobian_add
                     : which == 1 ? (const void *)k_jacobian_double
                                  : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return func_attrs(fn, out);
}

const char *pst_curve_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
