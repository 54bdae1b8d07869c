// K3 forward: the radiance trunk with in-kernel normal normalisation and
// the per-image code operand.
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _radiance_norm_fwd_pallas
// (pl.pallas_call at :708), the forward of radiance_norm. A block takes 64
// samples: it normalises the SDF gradient, n = g / (sqrt(max(|g|^2, 1e-24))
// + 1e-6), writes n out, and runs the ReLU trunk over the first-layer input
// [points, view PE, n, features, code] (W0's natural row order; the code
// when given) without it leaving shared memory (radiance.cuh). g and the
// code are float32, the rest at the operand type; with BF16 every operand
// is rounded to bf16 at the product and each hidden pre-activation before
// the bias add and the ReLU, as in the TPU kernel. The last layer (3
// outputs) stays float32: the sigmoid is applied outside.
//
// Bound on the card: operations (about 3.0e10 FLOP per 100,352-sample
// chunk with a 32-wide code, against ~62 MB of operands and outputs). This
// first version runs float32 FMAs on the CUDA cores.
#include "radiance.cuh"

using namespace mk;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
radiance_norm_kernel(const __grid_constant__ RadIn in, int N, const __grid_constant__ MlpDesc d,
                     const float* __restrict__ P, float* __restrict__ rgb_out,
                     float* __restrict__ nrm_out) {
  extern __shared__ __align__(16) float smem[];
  rad_forward<BF16>(in, N, d, P, rgb_out, nrm_out, smem);
}

extern "C" int radiance_norm_launch(const float* g, const void* sv, int ds, const void* feat,
                                    int F, const float* code, int C, int N, const int* desc,
                                    const float* P, float* rgb_out, float* nrm_out, int bf16,
                                    void* stream) {
  const MlpDesc d = desc_from(desc);
  RadIn in{};
  in.seg[0] = {sv, ds, 0};
  in.seg[1] = {g, 3, 1};
  in.seg[2] = {feat, F, 0};
  in.seg[3] = {code, C, 1};
  in.nseg = C > 0 ? 4 : 3;
  in.d0 = ds + 3 + F + C;
  in.norm_seg = 1;
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  const dim3 grid((N + TILE_M - 1) / TILE_M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? radiance_norm_kernel<true> : radiance_norm_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<grid, THREADS, smem, s>>>(in, N, d, P, rgb_out, nrm_out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
