// K8b forward: the ReLU trunk on one concatenated input row (nerf mode).
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _fwd_pallas (pl.pallas_call
// at :122), the forward of mlp_with_input_grad. h0 (N, d0) float32, [view
// PE, features, code] in nerf mode, is rounded to the operand type at the
// product. With BF16 each hidden pre-activation is rounded to bf16 before
// the bias add and the ReLU; the last layer stays float32 (acc + bias), the
// raw pre-activation.
//
// Bound on the card: operations (about 2.8e10 FLOP per 100,352 rows at
// d0 = 283, against ~115 MB of float32 input and output).
//
// bf16: the tensor cores (radiance_mlp_kernel_tc), K3f's and K8a's kernel
// body (radiance_tc.cuh rb_trunk_forward) on one float32 segment, h0 itself:
// h0 built at bf16 in wgmma's layout (read as float32 runs, 16 bytes a
// read), the hidden layers on wgmma with a fresh float32 sum per 64-deep
// weight stage, the weights packed once per call by
// kernels/radiance_norm.py pack_fwd and streamed through a ring of bulk
// copies on one persistent CTA per SM, and the top layer on the CUDA cores
// in gemm_narrow's order. float32: the SIMT trunk of radiance.cuh
// (rad_forward), float32 FMAs on the CUDA cores, one 64-row tile per block
// (TF32 would miss the float32 bars).
#include "radiance.cuh"

using namespace mk;

#include "radiance_tc.cuh"

// K8b's one segment: h0 itself, float32
static RadIn k8b_input(const float* h0, int d0) {
  RadIn in{};
  in.seg[0] = {h0, d0, 1};
  in.nseg = 1;
  in.d0 = d0;
  in.norm_seg = -1;
  return in;
}

__global__ void __launch_bounds__(THREADS)
radiance_mlp_kernel(const __grid_constant__ RadIn in, int N, const __grid_constant__ MlpDesc d,
                    const float* __restrict__ P, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  rad_forward(in, N, d, P, out, nullptr, smem);
}

__global__ void __launch_bounds__(RB_THREADS, 1)
radiance_mlp_kernel_tc(const __grid_constant__ RadIn in, int N, const __grid_constant__ MlpDesc d,
                       const float* __restrict__ P, const __nv_bfloat16* __restrict__ Wb,
                       const __grid_constant__ RadFwdWb wb, float* __restrict__ out,
                       float* __restrict__ nrm_out) {
  // nrm_out: null (K8b stores no normals: norm_seg < 0)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  rb_trunk_forward(in, N, d, P, Wb, wb, out, nrm_out, smem_raw);
}

// float32: the SIMT kernel, one 64-row tile per block
extern "C" int radiance_mlp_launch(const float* h0, int d0, int N, const int* desc,
                                   const float* P, float* out, void* stream) {
  const MlpDesc d = desc_from(desc);
  const RadIn in = k8b_input(h0, d0);
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  const dim3 grid((N + TILE_M - 1) / TILE_M);
  cudaFuncSetAttribute(radiance_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  radiance_mlp_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(in, N, d, P, out);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores: Wb the packed B operands (wb_off by layer), on
// `ctas` persistent CTAs.
extern "C" int radiance_mlp_tc_launch(const float* h0, int d0, int N, const int* desc,
                                      const float* P, const void* Wb, const int* wb_off,
                                      float* out, int ctas, void* stream) {
  return rb_trunk_forward_launch(radiance_mlp_kernel_tc, k8b_input(h0, d0), N, desc, P, Wb, wb_off,
                                 out, nullptr, ctas, stream);
}

MK_ERROR_STRING_EXPORT
