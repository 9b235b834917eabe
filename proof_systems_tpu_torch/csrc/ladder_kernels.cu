// The IPA fold step's endo ladder (endo_ladder.cuh): its kernel and
// launcher, compiled as a unit of their own. What it replaces and its
// design: the header of curve_kernels.cu.

#include "endo_ladder.cuh"

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

// Registers, local (stack) bytes, static and dynamic shared memory of
// k_endo_ladder, for pst_group_law_attrs.
int pst_ladder_attrs(int *out) { return func_attrs((const void *)k_endo_ladder, out); }

}  // extern "C"
