// K8b backward: the VJP of the ReLU trunk on one concatenated input row,
// with the input's cotangent.
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _bwd_pallas (pl.pallas_call
// at :225), the backward of mlp_with_input_grad (custom VJP at :952-981).
// Inputs: h0 (N, d0) float32 and the cotangent co (N, nout) float32.
// Outputs: dh0 (N, d0) float32 and the parameter gradients in the
// packed-weight layout.
//
// A block walks 64-row tiles (radiance.cuh rad_backward): it recomputes the
// hidden layers, keeps at most two of them and runs the reverse sweep in
// place over them; db of the output layer sums the unrounded co, dW and the
// propagation take it rounded to the operand type, as the TPU kernel casts
// at its products; dh0 = CT_0 W0^T. dW is summed as in sdf_grad_bwd.cu: a
// persistent grid, one float32 partial per block, reduce_partials in block
// order.
//
// Bound on the card: operations (about 8e10 FLOP per 100,352 rows at
// d0 = 283, three times the forward's). This first version runs float32
// FMAs on the CUDA cores.
#include "radiance.cuh"

using namespace mk;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
radiance_mlp_bwd_kernel(const __grid_constant__ RadIn in, const __grid_constant__ RadOut o,
                        int N, const __grid_constant__ MlpDesc d, const float* __restrict__ P,
                        const float* __restrict__ PT, const float* __restrict__ co,
                        float* __restrict__ work, int n_params) {
  extern __shared__ __align__(16) float smem[];
  rad_backward<BF16>(in, o, N, d, P, PT, co, 1, nullptr, nullptr, work, n_params, smem);
}

extern "C" int radiance_mlp_bwd_launch(const float* h0, int d0, int N, const int* desc,
                                       const float* P, const float* PT, const float* co,
                                       float* dh0_out, float* work, int grid, int n_params,
                                       float* out, int bf16, void* stream) {
  const MlpDesc d = desc_from(desc);
  RadIn in{};
  in.seg[0] = {h0, d0, 1};
  in.nseg = 1;
  in.d0 = d0;
  in.norm_seg = -1;
  RadOut o{};
  o.p[0] = dh0_out;
  o.f32[0] = 1;
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? radiance_mlp_bwd_kernel<true> : radiance_mlp_bwd_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<grid, THREADS, smem, s>>>(in, o, N, d, P, PT, co, work, n_params);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<(n_params + THREADS - 1) / THREADS, THREADS, 0, s>>>(work, grid, n_params, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
