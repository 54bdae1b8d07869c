// K8a forward: the split-operand radiance trunk on the raw SDF gradient.
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _radiance_fwd_pallas
// (pl.pallas_call at :379), the forward of radiance_split. The TPU kernel
// takes its operands as separate lane blocks with W0's rows split to match,
// so the wide input concatenate never reaches memory; here a block
// assembles the first-layer input [points, view PE, n, features, code]
// (W0's natural row order; the code when given) in shared memory from the
// four operands and runs the ReLU trunk on it. n is the raw gradient, not
// normalised (the plain rendering path's input). n, sv and the code come in
// float32 and are rounded to the operand type at the product; the features
// at the operand type. With BF16 each hidden pre-activation is rounded to
// bf16 before the bias add and the ReLU; the last layer stays float32.
//
// Bound on the card: operations (about 3.0e10 FLOP per 100,352-sample
// chunk with a 32-wide code, against ~80 MB of operands and outputs).
//
// bf16: the tensor cores (radiance_split_kernel_tc), K3f's kernel body
// (radiance_tc.cuh rb_trunk_forward) with K8a's segments and no normals:
// h0 built at bf16 in wgmma's layout (sv, n and the code read as float32
// runs, 16 bytes a read), the hidden layers on wgmma with a fresh float32
// sum per 64-deep weight stage, the weights packed once per call by
// kernels/radiance_norm.py pack_fwd and streamed through a ring of bulk
// copies on one persistent CTA per SM, and the top layer on the CUDA cores
// in gemm_narrow's order. float32: the SIMT trunk of radiance.cuh
// (rad_forward), float32 FMAs on the CUDA cores, one 64-row tile per block
// (TF32 would miss the float32 bars).
#include "radiance.cuh"

using namespace mk;

#include "radiance_tc.cuh"

// K8a's segments: [sv | n (the raw gradient) | feat | code (when C > 0)],
// sv, n and the code float32
static RadIn k8a_input(const float* n, const float* sv, int ds, const void* feat, int F,
                       const float* code, int C) {
  RadIn in{};
  in.seg[0] = {sv, ds, 1};
  in.seg[1] = {n, 3, 1};
  in.seg[2] = {feat, F, 0};
  in.seg[3] = {code, C, 1};
  in.nseg = C > 0 ? 4 : 3;
  in.d0 = ds + 3 + F + C;
  in.norm_seg = -1;
  return in;
}

__global__ void __launch_bounds__(THREADS)
radiance_split_kernel(const __grid_constant__ RadIn in, int N, const __grid_constant__ MlpDesc d,
                      const float* __restrict__ P, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  rad_forward<false>(in, N, d, P, out, nullptr, smem);
}

__global__ void __launch_bounds__(RB_THREADS, 1)
radiance_split_kernel_tc(const __grid_constant__ RadIn in, int N,
                         const __grid_constant__ MlpDesc d, const float* __restrict__ P,
                         const __nv_bfloat16* __restrict__ Wb, const __grid_constant__ RadFwdWb wb,
                         float* __restrict__ out, float* __restrict__ nrm_out) {
  // nrm_out: null (K8a stores no normals: norm_seg < 0)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  rb_trunk_forward(in, N, d, P, Wb, wb, out, nrm_out, smem_raw);
}

// float32: the SIMT kernel, one 64-row tile per block
extern "C" int radiance_split_launch(const float* n, const float* sv, int ds, const void* feat,
                                     int F, const float* code, int C, int N, const int* desc,
                                     const float* P, float* out, void* stream) {
  const MlpDesc d = desc_from(desc);
  const RadIn in = k8a_input(n, sv, ds, feat, F, code, C);
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  const dim3 grid((N + TILE_M - 1) / TILE_M);
  cudaFuncSetAttribute(radiance_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  radiance_split_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(in, N, d, P,
                                                                                     out);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores: Wb the packed B operands (wb_off by layer), on
// `ctas` persistent CTAs.
extern "C" int radiance_split_tc_launch(const float* n, const float* sv, int ds, const void* feat,
                                        int F, const float* code, int C, int N, const int* desc,
                                        const float* P, const void* Wb, const int* wb_off,
                                        float* out, int ctas, void* stream) {
  return rb_trunk_forward_launch(radiance_split_kernel_tc, k8a_input(n, sv, ds, feat, F, code, C),
                                 N, desc, P, Wb, wb_off, out, nullptr, ctas, stream);
}

MK_ERROR_STRING_EXPORT
