// The IPA round's transcript kernels K10 (sponge_squeeze2, on
// chain_field.cuh) and K11 (endo_inv, on inv_field.cuh): their kernels and
// launchers, compiled as a unit of their own. What they replace and their
// design: the header of field_kernels.cu.

#include "inv_field.cuh"
#include "scan_field.cuh"

// One warp on nine lanes (sponge_squeeze2_lanes, chain_field.cuh).
// state (8, 3), xs and ys (8, 2) Montgomery; consts (8, 3 * nrounds + 9).
__global__ void __launch_bounds__(32)
    k_sponge_squeeze2(FieldParams F, const uint32_t *__restrict__ state,
                      const uint32_t *__restrict__ xs, const uint32_t *__restrict__ ys,
                      const uint32_t *__restrict__ consts, int nrounds,
                      uint32_t *__restrict__ ost, uint32_t *__restrict__ ochal) {
    sponge_squeeze2_lanes(F, threadIdx.x, state, xs, ys, consts, nrounds, ost, ochal);
}

// One thread (endo_inv_thread, inv_field.cuh). bits: 128 int32 challenge
// bits, least significant first.
__global__ void __launch_bounds__(32)
    k_endo_inv(FieldParams F, EndoConsts k, const int32_t *__restrict__ bits,
               uint32_t *__restrict__ ou, uint32_t *__restrict__ oinv) {
    endo_inv_thread(F, k, bits, ou, oinv);
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

int pst_sponge_squeeze2(const uint32_t *fp, const uint32_t *state, const uint32_t *xs,
                        const uint32_t *ys, const uint32_t *consts, int nrounds,
                        uint32_t *ost, uint32_t *ochal, void *stream) {
    const FieldParams F = pst_field_params(fp);
    if (!pst_pasta_shape(F)) return (int)cudaErrorInvalidValue;
    k_sponge_squeeze2<<<1, 32, 0, (cudaStream_t)stream>>>(F, state, xs, ys, consts, nrounds,
                                                            ost, ochal);
    return (int)cudaGetLastError();
}

// consts: 24 words, the integers endo R^2, R^2 and R^3 mod p (8 each).
int pst_endo_inv(const uint32_t *fp, const uint32_t *consts, const int32_t *bits, uint32_t *ou,
                 uint32_t *oinv, void *stream) {
    const FieldParams F = pst_field_params(fp);
    if (!pst_pasta_shape(F)) return (int)cudaErrorInvalidValue;
    EndoConsts k;
    std::memcpy(k.endo_r2.v, consts, sizeof(k.endo_r2.v));
    std::memcpy(k.r2.v, consts + PST_NL, sizeof(k.r2.v));
    std::memcpy(k.r3.v, consts + 2 * PST_NL, sizeof(k.r3.v));
    k_endo_inv<<<1, 1, 0, (cudaStream_t)stream>>>(F, k, bits, ou, oinv);
    return (int)cudaGetLastError();
}

// Registers, local (stack) bytes, static and dynamic shared memory of
// k_sponge_squeeze2 (which 0) or k_endo_inv (2), for pst_chain_attrs.
int pst_transcript_attrs(int which, int *out) {
    const void *fn = which == 0   ? (const void *)k_sponge_squeeze2
                     : which == 2 ? (const void *)k_endo_inv
                                  : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return func_attrs(fn, out);
}

}  // extern "C"
