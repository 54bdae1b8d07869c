// K8b backward: the VJP of the ReLU trunk on one concatenated input row,
// with the input's cotangent.
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _bwd_pallas (pl.pallas_call
// at :225), the backward of mlp_with_input_grad (custom VJP at :952-981).
// Inputs: h0 (N, d0) float32 and the cotangent co (N, nout) float32.
// Outputs: dh0 (N, d0) float32, every column (the view PE's too, as the TPU
// kernel returns them), and the parameter gradients in the packed-weight
// layout. db of the output layer sums the unrounded co; dW and the
// propagation take it rounded to the operand type, as the TPU kernel casts
// at its products.
//
// Bound on the card: operations (about 8e10 FLOP per 100,352 rows at
// d0 = 283, three times the forward's).
//
// bf16: the tensor cores, K3b's two passes (radiance_bwd_tc.cuh, whose
// comment gives the design) on one float32 segment, h0, whose d0 columns
// all have a cotangent output: W0^T goes in input blocks of at most 256
// columns (kernels/radiance_norm.py input_blocks; two at d0 = 283 or 315).
// Pass 1 recomputes the hidden layers on wgmma, runs the reverse sweep with
// the top layer on the CUDA cores and the hidden and input cotangents on
// wgmma, writes dh0 float32 from the registers, and stores h0, Y_0, CT_0
// and CT_1 in wgmma's layout; pass 2 sums dW_l = A_l^T CT_l over the rows
// on wgmma; the partials are summed in a fixed order (two runs give the
// same bits).
//
// float32: the SIMT kernel (radiance.cuh rad_backward), float32 FMAs on
// the CUDA cores (TF32 would miss the float32 bars). A block walks 64-row
// tiles: it recomputes the hidden layers, keeps at most two of them and
// runs the reverse sweep in place over them; dh0 = CT_0 W0^T. dW is summed
// as in sdf_grad_bwd.cu: a persistent grid, one float32 partial per block,
// reduce_partials in block order.
#include "radiance.cuh"

using namespace mk;

#define BWD_TC_NAME(part) radiance_mlp_bwd_##part
#include "radiance_bwd_tc.cuh"

__global__ void __launch_bounds__(THREADS)
radiance_mlp_bwd_kernel(const __grid_constant__ RadIn in, const __grid_constant__ RadOut o,
                        int N, const __grid_constant__ MlpDesc d, const float* __restrict__ P,
                        const float* __restrict__ PT, const float* __restrict__ co,
                        float* __restrict__ work, int n_params) {
  extern __shared__ __align__(16) float smem[];
  rad_backward(in, o, N, d, P, PT, co, nullptr, nullptr, work, n_params, smem);
}

// K8b's one segment: h0 (float32; dh0 float32)
static void k8b_segments(const float* h0, int d0, float* dh0_out, RadIn& in, RadOut& o) {
  in = RadIn{};
  in.seg[0] = {h0, d0, 1};
  in.nseg = 1;
  in.d0 = d0;
  in.norm_seg = -1;
  o = RadOut{};
  o.p[0] = dh0_out;
  o.f32[0] = 1;
}

// float32: the SIMT kernel, then the blocks' partials summed in order
extern "C" int radiance_mlp_bwd_launch(const float* h0, int d0, int N, const int* desc,
                                       const float* P, const float* PT, const float* co,
                                       float* dh0_out, float* work, int grid, int n_params,
                                       float* out, void* stream) {
  const MlpDesc d = desc_from(desc);
  RadIn in;
  RadOut o;
  k8b_segments(h0, d0, dh0_out, in, o);
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(radiance_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  radiance_mlp_bwd_kernel<<<grid, THREADS, smem, s>>>(in, o, N, d, P, PT, co, work, n_params);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<(n_params + THREADS - 1) / THREADS, THREADS, 0, s>>>(work, grid, n_params, out);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the two tensor-core passes (radiance_bwd_tc.cuh rad_bwd_tc_launch,
// whose comment names the arguments), co float32
extern "C" int radiance_mlp_bwd_tc_launch(
    const float* h0, int d0, int N, const int* desc, const float* P, const void* Wb,
    const int* mat_off, const int* mat_k, int n_mats, int n_blk, const int* route,
    const float* co, float* dh0_out, void* const* ct, void* const* a, const int* kap,
    float* part1, int grid1, int n_small, float* part2, int splits, int n_out, float* out,
    void* stream) {
  RadIn in;
  RadOut o;
  k8b_segments(h0, d0, dh0_out, in, o);
  return rad_bwd_tc_launch(in, o, N, desc, P, Wb, mat_off, mat_k, n_mats, n_blk, route, co, 1,
                           nullptr, nullptr, ct, a, kap, part1, grid1, n_small, part2, splits,
                           n_out, out, stream);
}

MK_ERROR_STRING_EXPORT
