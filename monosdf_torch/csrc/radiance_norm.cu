// K3 forward: the radiance trunk with in-kernel normal normalisation and
// the per-image code operand.
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _radiance_norm_fwd_pallas
// (pl.pallas_call at :708), the forward of radiance_norm. Per sample: it
// normalises the SDF gradient, n = g / (sqrt(max(|g|^2, 1e-24)) + 1e-6),
// writes n out, and runs the ReLU trunk over the first-layer input [points,
// view PE, n, features, code] (W0's natural row order; the code when given)
// without it leaving shared memory. g and the code are float32, the rest at
// the operand type; with BF16 every operand is rounded to bf16 at the
// product and each hidden pre-activation before the bias add and the ReLU,
// as in the TPU kernel. The last layer (3 outputs) stays float32: the
// sigmoid is applied outside.
//
// Bound on the card: operations (about 3.0e10 FLOP per 100,352-sample
// chunk with a 32-wide code, against ~62 MB of operands and outputs).
//
// bf16: the tensor cores (radiance_norm_kernel_tc, radiance_tc.cuh
// rb_trunk_forward, K8a's forward body too): the normalisation as
// rad_normals computes it, then K3b's pass-1 forward (radiance_tc.cuh: h0
// built at bf16 in wgmma's layout, the hidden layers on wgmma with a fresh
// float32 sum per 64-deep weight stage, the weights packed once per call by
// kernels/radiance_norm.py pack_fwd and streamed through a ring of bulk
// copies), and the top layer (256 x 3) on the CUDA cores in gemm_narrow's
// order (a warp per row, lanes strided over k, a shuffle tree) with the
// bias added as rad_forward adds it. float32: the SIMT trunk of
// radiance.cuh (rad_forward), float32 FMAs on the CUDA cores, one 64-row
// tile per block (TF32 would miss the float32 bars).
#include "radiance.cuh"

using namespace mk;

#include "radiance_tc.cuh"

// K3's segments: [sv | n (normalised from g) | feat | code (when C > 0)]
static RadIn k3_input(const float* g, const void* sv, int ds, const void* feat, int F,
                      const float* code, int C) {
  RadIn in{};
  in.seg[0] = {sv, ds, 0};
  in.seg[1] = {g, 3, 1};
  in.seg[2] = {feat, F, 0};
  in.seg[3] = {code, C, 1};
  in.nseg = C > 0 ? 4 : 3;
  in.d0 = ds + 3 + F + C;
  in.norm_seg = 1;
  return in;
}

__global__ void __launch_bounds__(THREADS)
radiance_norm_kernel(const __grid_constant__ RadIn in, int N, const __grid_constant__ MlpDesc d,
                     const float* __restrict__ P, float* __restrict__ rgb_out,
                     float* __restrict__ nrm_out) {
  extern __shared__ __align__(16) float smem[];
  rad_forward(in, N, d, P, rgb_out, nrm_out, smem);
}

// bf16: the tensor cores (radiance_tc.cuh rb_trunk_forward)
__global__ void __launch_bounds__(RB_THREADS, 1)
radiance_norm_kernel_tc(const __grid_constant__ RadIn in, int N,
                        const __grid_constant__ MlpDesc d, const float* __restrict__ P,
                        const __nv_bfloat16* __restrict__ Wb, const __grid_constant__ RadFwdWb wb,
                        float* __restrict__ rgb_out, float* __restrict__ nrm_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  rb_trunk_forward(in, N, d, P, Wb, wb, rgb_out, nrm_out, smem_raw);
}

// float32: the SIMT kernel, one 64-row tile per block
extern "C" int radiance_norm_launch(const float* g, const void* sv, int ds, const void* feat,
                                    int F, const float* code, int C, int N, const int* desc,
                                    const float* P, float* rgb_out, float* nrm_out,
                                    void* stream) {
  const MlpDesc d = desc_from(desc);
  const RadIn in = k3_input(g, sv, ds, feat, F, code, C);
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  const dim3 grid((N + TILE_M - 1) / TILE_M);
  cudaFuncSetAttribute(radiance_norm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  radiance_norm_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      in, N, d, P, rgb_out, nrm_out);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores: Wb the packed B operands (wb_off by layer), on
// `ctas` persistent CTAs.
extern "C" int radiance_norm_tc_launch(const float* g, const void* sv, int ds, const void* feat,
                                       int F, const float* code, int C, int N, const int* desc,
                                       const float* P, const void* Wb, const int* wb_off,
                                       float* rgb_out, float* nrm_out, int ctas, void* stream) {
  return rb_trunk_forward_launch(radiance_norm_kernel_tc, k3_input(g, sv, ds, feat, F, code, C), N,
                                 desc, P, Wb, wb_off, rgb_out, nrm_out, ctas, stream);
}

MK_ERROR_STRING_EXPORT
