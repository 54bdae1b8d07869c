// K8a backward: the VJP of the split-operand radiance trunk.
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _radiance_bwd_pallas
// (pl.pallas_call at :538). Inputs as the forward (n (N, 3), sv (N, ds) and
// the code (N, C) float32, feat (N, F) at the operand type) plus the
// cotangent co (N, nout) of the pre-activation in float32. Outputs: dn
// (N, 3) float32, df (N, F) at the operand type, dc (N, C) float32 (with a
// code) and the parameter gradients in the packed-weight layout (W0 in its
// natural row order). The points and view PE get no cotangent, as the TPU
// kernel forms none. There is no normalise step: dn is the normals' columns
// of CT_0 W0^T. db of the output layer sums the unrounded float32 co; dW
// and the propagation take it rounded, as the TPU kernel casts at its
// products.
//
// Bound on the card: operations (about 9e10 FLOP per 100,352 samples, three
// times the forward's).
//
// bf16: the tensor cores, K3b's two passes (radiance_bwd_tc.cuh, whose
// comment gives the design) with K8a's segments: pass 1 recomputes the
// hidden layers on wgmma, runs the reverse sweep with the top layer on the
// CUDA cores and the hidden and input cotangents on wgmma, writes dn, df and
// dc, and stores h0, Y_0, CT_0 and CT_1 in wgmma's layout; pass 2 sums dW_l
// = A_l^T CT_l over the rows on wgmma; the partials are summed in a fixed
// order (two runs give the same bits).
//
// float32: the SIMT kernel (radiance.cuh rad_backward), float32 FMAs on
// the CUDA cores (TF32 would miss the float32 bars). A block walks 64-sample
// tiles: it recomputes the hidden layers, keeps at most two of them and
// runs the reverse sweep in place over them. dW is summed as in
// sdf_grad_bwd.cu: a persistent grid, one float32 partial per block,
// reduce_partials in block order.
#include "radiance.cuh"

using namespace mk;

#define BWD_TC_NAME(part) radiance_split_bwd_##part
#include "radiance_bwd_tc.cuh"

__global__ void __launch_bounds__(THREADS)
radiance_split_bwd_kernel(const __grid_constant__ RadIn in, const __grid_constant__ RadOut o,
                          int N, const __grid_constant__ MlpDesc d, const float* __restrict__ P,
                          const float* __restrict__ PT, const float* __restrict__ co,
                          float* __restrict__ work, int n_params) {
  extern __shared__ __align__(16) float smem[];
  rad_backward<false>(in, o, N, d, P, PT, co, 1, nullptr, nullptr, work, n_params, smem);
}

// K8a's segments: [sv (f32, no cotangent) | n (the raw gradient, f32; dn
// float32) | feat (df at the operand type) | code (f32; dc float32, when
// C > 0)]
static void k8a_segments(const float* n, const float* sv, int ds, const void* feat, int F,
                         const float* code, int C, float* dn_out, void* df_out, float* dc_out,
                         RadIn& in, RadOut& o) {
  in = RadIn{};
  in.seg[0] = {sv, ds, 1};
  in.seg[1] = {n, 3, 1};
  in.seg[2] = {feat, F, 0};
  in.seg[3] = {code, C, 1};
  in.nseg = C > 0 ? 4 : 3;
  in.d0 = ds + 3 + F + C;
  in.norm_seg = -1;
  o = RadOut{};
  o.p[1] = dn_out;
  o.f32[1] = 1;
  o.p[2] = df_out;
  o.f32[2] = 0;
  o.p[3] = dc_out;
  o.f32[3] = 1;
}

// float32: the SIMT kernel, then the blocks' partials summed in order
extern "C" int radiance_split_bwd_launch(const float* n, const float* sv, int ds,
                                         const void* feat, int F, const float* code, int C,
                                         int N, const int* desc, const float* P,
                                         const float* PT, const float* co, float* dn_out,
                                         void* df_out, float* dc_out, float* work, int grid,
                                         int n_params, float* out, void* stream) {
  const MlpDesc d = desc_from(desc);
  RadIn in;
  RadOut o;
  k8a_segments(n, sv, ds, feat, F, code, C, dn_out, df_out, dc_out, in, o);
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(radiance_split_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  radiance_split_bwd_kernel<<<grid, THREADS, smem, s>>>(in, o, N, d, P, PT, co, work, n_params);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<(n_params + THREADS - 1) / THREADS, THREADS, 0, s>>>(work, grid, n_params, out);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the two tensor-core passes (radiance_bwd_tc.cuh rad_bwd_tc_launch,
// whose comment names the arguments), co float32
extern "C" int radiance_split_bwd_tc_launch(
    const float* n, const float* sv, int ds, const void* feat, int F, const float* code, int C,
    int N, const int* desc, const float* P, const void* Wb, const int* mat_off, const int* mat_k,
    int n_mats, int n_blk, const int* route, const float* co, float* dn_out, void* df_out,
    float* dc_out, void* const* ct, void* const* a, const int* kap, float* part1, int grid1,
    int n_small, float* part2, int splits, int n_out, float* out, void* stream) {
  RadIn in;
  RadOut o;
  k8a_segments(n, sv, ds, feat, F, code, C, dn_out, df_out, dc_out, in, o);
  return rad_bwd_tc_launch(in, o, N, desc, P, Wb, mat_off, mat_k, n_mats, n_blk, route, co, 1,
                           nullptr, nullptr, ct, a, kap, part1, grid1, n_small, part2, splits,
                           n_out, out, stream);
}

MK_ERROR_STRING_EXPORT
