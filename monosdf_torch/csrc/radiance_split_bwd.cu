// K8a backward: the VJP of the split-operand radiance trunk.
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _radiance_bwd_pallas
// (pl.pallas_call at :538). Inputs as the forward (n (N, 3), sv (N, ds) and
// the code (N, C) float32, feat (N, F) at the operand type) plus the
// cotangent co (N, nout) of the pre-activation in float32. Outputs: dn
// (N, 3) float32, df (N, F) at the operand type, dc (N, C) float32 (with a
// code) and the parameter gradients in the packed-weight layout (W0 in its
// natural row order). The points and view PE get no cotangent, as the TPU
// kernel forms none.
//
// A block walks 64-sample tiles (radiance.cuh rad_backward): it recomputes
// the hidden layers, keeps at most two of them and runs the reverse sweep
// in place over them; db of the output layer sums the unrounded float32 co,
// dW and the propagation take it rounded, as the TPU kernel casts at its
// products. dW is summed as in sdf_grad_bwd.cu: a persistent grid, one
// float32 partial per block, reduce_partials in block order.
//
// Bound on the card: operations (about 9e10 FLOP per 100,352 samples, three
// times the forward's). This first version runs float32 FMAs on the CUDA
// cores.
#include "radiance.cuh"

using namespace mk;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
radiance_split_bwd_kernel(const __grid_constant__ RadIn in, const __grid_constant__ RadOut o,
                          int N, const __grid_constant__ MlpDesc d, const float* __restrict__ P,
                          const float* __restrict__ PT, const float* __restrict__ co,
                          float* __restrict__ work, int n_params) {
  extern __shared__ __align__(16) float smem[];
  rad_backward<BF16>(in, o, N, d, P, PT, co, 1, nullptr, nullptr, work, n_params, smem);
}

extern "C" int radiance_split_bwd_launch(const float* n, const float* sv, int ds,
                                         const void* feat, int F, const float* code, int C,
                                         int N, const int* desc, const float* P,
                                         const float* PT, const float* co, float* dn_out,
                                         void* df_out, float* dc_out, float* work, int grid,
                                         int n_params, float* out, int bf16, void* stream) {
  const MlpDesc d = desc_from(desc);
  RadIn in{};
  in.seg[0] = {sv, ds, 1};
  in.seg[1] = {n, 3, 1};
  in.seg[2] = {feat, F, 0};
  in.seg[3] = {code, C, 1};
  in.nseg = C > 0 ? 4 : 3;
  in.d0 = ds + 3 + F + C;
  in.norm_seg = -1;
  RadOut o{};
  o.p[1] = dn_out;
  o.f32[1] = 1;
  o.p[2] = df_out;
  o.f32[2] = 0;
  o.p[3] = dc_out;
  o.f32[3] = 1;
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? radiance_split_bwd_kernel<true> : radiance_split_bwd_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<grid, THREADS, smem, s>>>(in, o, N, d, P, PT, co, work, n_params);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<(n_params + THREADS - 1) / THREADS, THREADS, 0, s>>>(work, grid, n_params, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
