// K8b forward: the ReLU trunk on one concatenated input row (nerf mode).
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _fwd_pallas (pl.pallas_call
// at :122), the forward of mlp_with_input_grad. h0 (N, d0) float32, [view
// PE, features, code] in nerf mode, is rounded to the operand type at the
// product; a block takes 64 rows and runs the trunk without the layers
// leaving shared memory (radiance.cuh). With BF16 each hidden
// pre-activation is rounded to bf16 before the bias add and the ReLU; the
// last layer stays float32 (acc + bias), the raw pre-activation.
//
// Bound on the card: operations (about 2.8e10 FLOP per 100,352 rows at
// d0 = 283, against ~115 MB of float32 input and output). This first
// version runs float32 FMAs on the CUDA cores.
#include "radiance.cuh"

using namespace mk;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
radiance_mlp_kernel(const __grid_constant__ RadIn in, int N, const __grid_constant__ MlpDesc d,
                    const float* __restrict__ P, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  rad_forward<BF16>(in, N, d, P, out, nullptr, smem);
}

extern "C" int radiance_mlp_launch(const float* h0, int d0, int N, const int* desc,
                                   const float* P, float* out, int bf16, void* stream) {
  const MlpDesc d = desc_from(desc);
  RadIn in{};
  in.seg[0] = {h0, d0, 1};
  in.nseg = 1;
  in.d0 = d0;
  in.norm_seg = -1;
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  const dim3 grid((N + TILE_M - 1) / TILE_M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? radiance_mlp_kernel<true> : radiance_mlp_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<grid, THREADS, smem, s>>>(in, N, d, P, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
