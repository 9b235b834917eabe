// K8 (combine_windows, k8_combine.cuh): its kernel and launcher, compiled
// as a unit of their own. What it replaces and its design: the header of
// curve_kernels.cu and of k8_combine.cuh.

#include "k8_combine.cuh"

// K8: one warp a column (k8_combine.cuh), K8_WARPS columns a block.
__global__ void __launch_bounds__(32 * K8_WARPS, 1)
    k_combine_windows(FieldParams F, const uint32_t *wx, const uint32_t *wy, const uint32_t *wz,
                      uint32_t *ox, uint32_t *oy, uint32_t *oz, int64_t W, int64_t b, int c) {
    const int64_t col = (int64_t)blockIdx.x * K8_WARPS + threadIdx.x / 32;
    if (col >= b) return;  // whole warps
    k8_combine_column(F, wx, wy, wz, ox, oy, oz, W, b, c, col, threadIdx.x % 32);
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

// Registers, local (stack) bytes, static and dynamic shared memory of K8.
int pst_combine_windows_attrs(int *out) { return func_attrs((const void *)k_combine_windows, out); }

}  // extern "C"
