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
// A block walks 64-sample tiles (radiance.cuh rad_backward): it recomputes
// n and the hidden layers as the forward does, keeps at most two hidden
// layers (the bench's 2x256 trunk) and runs the reverse sweep in place over
// them. At layer 0, dW0 from [sv | rnd(n) | feat | code], df and dc from
// CT_0 W0^T, and the normalise backward takes both normal cotangents:
// dn = cn + CT_0 W0_n^T, dg = dn/q - g (<dn, g> / (q^2 r)) [|g|^2 > 1e-24],
// r = sqrt(max(|g|^2, 1e-24)), q = r + 1e-6.
//
// dW is summed as in sdf_grad_bwd.cu: a persistent grid, one float32
// partial per block, reduce_partials in block order.
//
// Bound on the card: operations (about 9e10 FLOP per 100,352 samples, three
// times the forward's, against ~130 MB of operands and outputs). This first
// version runs float32 FMAs on the CUDA cores.
#include "radiance.cuh"

using namespace mk;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
radiance_norm_bwd_kernel(const __grid_constant__ RadIn in, const __grid_constant__ RadOut o,
                         int N, const __grid_constant__ MlpDesc d, const float* __restrict__ P,
                         const float* __restrict__ PT, const void* __restrict__ co,
                         const void* __restrict__ cn, float* __restrict__ dg_out,
                         float* __restrict__ work, int n_params) {
  extern __shared__ __align__(16) float smem[];
  rad_backward<BF16>(in, o, N, d, P, PT, co, 0, cn, dg_out, work, n_params, smem);
}

extern "C" int radiance_norm_bwd_launch(const float* g, const void* sv, int ds, const void* feat,
                                        int F, const float* code, int C, int N, const int* desc,
                                        const float* P, const float* PT, const void* co,
                                        const void* cn, float* dg_out, void* df_out,
                                        float* dc_out, float* work, int grid, int n_params,
                                        float* out, int bf16, void* stream) {
  const MlpDesc d = desc_from(desc);
  RadIn in{};
  in.seg[0] = {sv, ds, 0};
  in.seg[1] = {g, 3, 1};
  in.seg[2] = {feat, F, 0};
  in.seg[3] = {code, C, 1};
  in.nseg = C > 0 ? 4 : 3;
  in.d0 = ds + 3 + F + C;
  in.norm_seg = 1;
  RadOut o{};
  o.p[2] = df_out;
  o.f32[2] = 0;
  o.p[3] = dc_out;
  o.f32[3] = 1;
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? radiance_norm_bwd_kernel<true> : radiance_norm_bwd_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<grid, THREADS, smem, s>>>(in, o, N, d, P, PT, co, cn, dg_out, work, n_params);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<(n_params + THREADS - 1) / THREADS, THREADS, 0, s>>>(work, grid, n_params, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
