// K3b: the backward of the radiance trunk with in-kernel normalisation and
// the per-image code operand.
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _radiance_norm_bwd_pallas
// (pl.pallas_call at :889), the VJP of radiance_norm. Inputs as the forward
// (g (N, 3) and the code (N, C) float32; sv (N, ds), feat (N, F) at the
// operand type) plus the cotangents co (N, nout) of rgb_pre and cn (N, 3) of
// the normals, at the operand type. Outputs: dg (N, 3) float32, df (N, F) at
// the operand type, dc (N, C) float32 (with a code), and the parameter
// gradients in the packed-weight layout (W0 in its natural row order [sv, n,
// feat, code]). sv gets no cotangent.
//
// bf16: the tensor cores, in two passes (radiance_bwd_tc.cuh, whose
// comment gives the design): pass 1 recomputes n and the hidden layers on
// wgmma, runs the reverse sweep with the top layer on the CUDA cores and
// the hidden and input cotangents on wgmma, writes df, dc and dg, and
// stores h0, Y_0, CT_0 and CT_1 in wgmma's layout; pass 2 sums dW_l = A_l^T
// CT_l over the rows on wgmma; the partials are summed in a fixed order.
//
// float32: the SIMT kernel (radiance.cuh rad_backward), float32 FMAs on
// the CUDA cores (TF32 would miss the float32 bars). A block walks 64-sample
// tiles: it recomputes n and the hidden layers as the forward does, keeps at
// most two hidden layers (the bench's 2x256 trunk) and runs the reverse
// sweep in place over them. At layer 0, dW0 from [sv | n | feat | code], df
// and dc from CT_0 W0^T, and the normalise backward takes both normal
// cotangents: dn = cn + CT_0 W0_n^T, dg = dn/q - g (<dn, g> / (q^2 r))
// [|g|^2 > 1e-24], r = sqrt(max(|g|^2, 1e-24)), q = r + 1e-6. dW is summed
// as in sdf_grad_bwd.cu: a persistent grid, one float32 partial per block,
// reduce_partials in block order.
//
// Bound on the card: operations (about 9e10 FLOP per 100,352 samples, three
// times the forward's, against ~130 MB of operands and outputs).
#include "radiance.cuh"

using namespace mk;

#define BWD_TC_NAME(part) radiance_norm_bwd_##part
#include "radiance_bwd_tc.cuh"

__global__ void __launch_bounds__(THREADS)
radiance_norm_bwd_kernel(const __grid_constant__ RadIn in, const __grid_constant__ RadOut o,
                         int N, const __grid_constant__ MlpDesc d, const float* __restrict__ P,
                         const float* __restrict__ PT, const void* __restrict__ co,
                         const void* __restrict__ cn, float* __restrict__ dg_out,
                         float* __restrict__ work, int n_params) {
  extern __shared__ __align__(16) float smem[];
  rad_backward(in, o, N, d, P, PT, static_cast<const float*>(co),
               static_cast<const float*>(cn), dg_out, work, n_params, smem);
}

// K3b's segments: [sv (no cotangent) | n (normalised from g) | feat (df at
// the operand type) | code (dc float32, when C > 0)]
static void k3_segments(const float* g, const void* sv, int ds, const void* feat, int F,
                        const float* code, int C, void* df_out, float* dc_out, RadIn& in,
                        RadOut& o) {
  in = RadIn{};
  in.seg[0] = {sv, ds, 0};
  in.seg[1] = {g, 3, 1};
  in.seg[2] = {feat, F, 0};
  in.seg[3] = {code, C, 1};
  in.nseg = C > 0 ? 4 : 3;
  in.d0 = ds + 3 + F + C;
  in.norm_seg = 1;
  o = RadOut{};
  o.p[2] = df_out;
  o.f32[2] = 0;
  o.p[3] = dc_out;
  o.f32[3] = 1;
}

// float32: the SIMT kernel, then the blocks' partials summed in order
extern "C" int radiance_norm_bwd_launch(const float* g, const void* sv, int ds, const void* feat,
                                        int F, const float* code, int C, int N, const int* desc,
                                        const float* P, const float* PT, const void* co,
                                        const void* cn, float* dg_out, void* df_out,
                                        float* dc_out, float* work, int grid, int n_params,
                                        float* out, void* stream) {
  const MlpDesc d = desc_from(desc);
  RadIn in;
  RadOut o;
  k3_segments(g, sv, ds, feat, F, code, C, df_out, dc_out, in, o);
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(radiance_norm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  radiance_norm_bwd_kernel<<<grid, THREADS, smem, s>>>(in, o, N, d, P, PT, co, cn, dg_out, work,
                                                       n_params);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<(n_params + THREADS - 1) / THREADS, THREADS, 0, s>>>(work, grid, n_params, out);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the two tensor-core passes (radiance_bwd_tc.cuh rad_bwd_tc_launch,
// whose comment names the arguments), co and cn bf16
extern "C" int radiance_norm_bwd_tc_launch(
    const float* g, const void* sv, int ds, const void* feat, int F, const float* code, int C,
    int N, const int* desc, const float* P, const void* Wb, const int* mat_off, const int* mat_k,
    int n_mats, int n_blk, const int* route, const void* co, const void* cn, float* dg_out,
    void* df_out, float* dc_out, void* const* ct, void* const* a, const int* kap, float* part1,
    int grid1, int n_small, float* part2, int splits, int n_out, float* out, void* stream) {
  RadIn in;
  RadOut o;
  k3_segments(g, sv, ds, feat, F, code, C, df_out, dc_out, in, o);
  return rad_bwd_tc_launch(in, o, N, desc, P, Wb, mat_off, mat_k, n_mats, n_blk, route, co, 0, cn,
                           dg_out, ct, a, kap, part1, grid1, n_small, part2, splits, n_out, out,
                           stream);
}

MK_ERROR_STRING_EXPORT
