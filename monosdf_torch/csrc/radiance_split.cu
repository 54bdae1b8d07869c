// K8a forward: the split-operand radiance trunk on the raw SDF gradient.
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _radiance_fwd_pallas
// (pl.pallas_call at :379), the forward of radiance_split. The TPU kernel
// takes its operands as separate lane blocks with W0's rows split to match,
// so the wide input concatenate never reaches memory; here a block
// assembles the first-layer input [points, view PE, n, features, code]
// (W0's natural row order; the code when given) in shared memory from the
// four operands and runs the ReLU trunk on it (radiance.cuh). n is the raw
// gradient, not normalised (the plain rendering path's input). n, sv and
// the code come in float32 and are rounded to the operand type at the
// product; the features at the operand type. With BF16 each hidden
// pre-activation is rounded to bf16 before the bias add and the ReLU; the
// last layer stays float32.
//
// Bound on the card: operations (about 3.0e10 FLOP per 100,352-sample
// chunk with a 32-wide code, against ~80 MB of operands and outputs). This
// first version runs float32 FMAs on the CUDA cores.
#include "radiance.cuh"

using namespace mk;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
radiance_split_kernel(const __grid_constant__ RadIn in, int N, const __grid_constant__ MlpDesc d,
                      const float* __restrict__ P, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  rad_forward<BF16>(in, N, d, P, out, nullptr, smem);
}

extern "C" int radiance_split_launch(const float* n, const float* sv, int ds, const void* feat,
                                     int F, const float* code, int C, int N, const int* desc,
                                     const float* P, float* out, int bf16, void* stream) {
  const MlpDesc d = desc_from(desc);
  RadIn in{};
  in.seg[0] = {sv, ds, 1};
  in.seg[1] = {n, 3, 1};
  in.seg[2] = {feat, F, 0};
  in.seg[3] = {code, C, 1};
  in.nseg = C > 0 ? 4 : 3;
  in.d0 = ds + 3 + F + C;
  in.norm_seg = -1;
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  const dim3 grid((N + TILE_M - 1) / TILE_M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? radiance_split_kernel<true> : radiance_split_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<grid, THREADS, smem, s>>>(in, N, d, P, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
