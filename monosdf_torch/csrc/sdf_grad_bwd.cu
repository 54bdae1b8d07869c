// K2b: the second-order backward of the SDF MLP with its spatial gradient.
//
// Replaces monosdf_tpu/ops/pallas_sdf_grad.py _bwd_pallas (pl.pallas_call at
// :713), the VJP of sdf_mlp_with_grad. Inputs: the points, the forward's
// saved pre-activations Z (z.p[l], (4, N, nout_l) at the operand type), the
// output cotangents c_sdf (N, 1), c_feat (N, F), c_grad (N, 3) at the operand
// type, and the take-MLP flag (N) or null. Output: the parameter gradients
// in the packed-weight layout (csrc/common.cuh MlpDesc). The points'
// cotangent is zero and not computed.
//
// A tile is PTS points, i.e. 64 stacked rows (primal, then the tangents
// along x, y, z), as in the forward. Per tile, from the last layer down:
//   last layer: CT = [c_sdf*flag | c_feat] on the primal rows and
//     c_grad_k*flag in the SDF column of tangent row k;
//   hidden layer l, from Z[l] (s = sigmoid(100 z), u_k the tangent rows):
//     ct_z = ct_h*s + (sum_k ct_t_k*u_k)*100 s(1-s),  ct_u_k = s*ct_t_k;
//   dW_l += A_l^T CT, db_l += sum of CT's primal rows (float32, before the
//     rounding of CT to the operand type), ct_A = CT W_l^T, whose columns of
//     the previous layer's output go on (divided by sqrt 2 after a skip).
// A_l, the layer's input, is rebuilt from Z[l-1] (h = softplus_100(z), t_k =
// s*u_k; at a skip layer with the embedding, / sqrt 2) and rounded once, as
// the TPU kernel's a_in_of; W^T comes packed (PT) at the same offsets as W.
// With BF16 every matmul operand is rounded to bf16, sums are float32.
//
// Bound on the card: operations (about 8.8e11 FLOP at the bench's 104,448
// training points, twice the forward's, 0.89 ms at 989 TFLOP/s bf16) against
// ~1.7 GB of bf16 Z read (0.5 ms at 3.35 TB/s).
//
// float32 (the check path): float32 FMAs on the CUDA cores. The TPU kernel
// summed dW over a sequential grid; here the grid is persistent (one block
// per SM, tiles strided over the blocks), each block adds its tiles' dW
// into its own float32 partial in device memory (a 256 x 256 layer's dW is
// 256 KB, more than a block's shared memory), and reduce_partials sums the
// partials in block order. That is a read-modify-write of the whole 2.1 MB
// partial (the bench's 8x256 MLP) per 16-point tile.
//
// bf16 (the training step's path): the tensor cores in two passes,
// sdf_grad_bwd_tc.cuh (shared with K7b, sdf_grad_grid_bwd.cu): pass 1 (the
// tile loop above with ct_A = CT W^T on wgmma, storing each layer's bf16 CT
// and input A in wgmma's layout), pass 2 (dW = A^T CT, a tall-K GEMM on
// wgmma), and the partials summed in a fixed order (two runs, the same
// bits). Layer 0's ct_A is not computed: the points' cotangent is zero.
// Pass 1 is latency-bound on its 8 consumer warps per SM (the gate step,
// the CT/A stores and four barriers per layer run in series with the
// product); pass 2 and the ~3.7 GB of CT/A scratch are the price of keeping
// dW off the per-tile path. CT is rounded to bf16 before both products in
// either path (rnd<BF16> below), so both compute the same function.
#include "common.cuh"

using namespace mk;

#define BWD_TC_NAME(part) sdf_grad_bwd_##part
#include "sdf_grad_bwd_tc.cuh"

__global__ void __launch_bounds__(THREADS)
sdf_grad_bwd_kernel(const float* __restrict__ x, int N, int multires, MlpDesc d,
                    const float* __restrict__ P, const float* __restrict__ PT,
                    const __grid_constant__ ZPtrs z,
                    const void* __restrict__ c_sdf, const void* __restrict__ c_feat,
                    const void* __restrict__ c_grad, const float* __restrict__ flag,
                    float* __restrict__ work, int n_params) {
  constexpr bool BF16 = false;  // float32 only: bf16 takes sdf_grad_bwd_tc.cuh's passes
  extern __shared__ __align__(16) float smem[];
  float* X0 = smem;
  float* bufA = X0 + TILE_M * LD0;
  float* bufB = bufA + TILE_M * LDA;
  float* Ws = bufB + TILE_M * LDA;
  __shared__ float xs[PTS][3];
  __shared__ float fl[PTS];
  const int tid = threadIdx.x;
  const int d0 = 3 * (1 + 2 * multires);
  const int L = d.n_layers;
  const int n_tiles = (N + PTS - 1) / PTS;
  float* part = work + (size_t)blockIdx.x * n_params;
  zero_partial(part, n_params);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * PTS;
    __syncthreads();  // the previous tile is done with shared memory
    if (tid < PTS) fl[tid] = (flag != nullptr && p0 + tid < N) ? flag[p0 + tid] : 1.0f;
    load_pe_tile(x, N, p0, multires, xs, X0);
    __syncthreads();

    // ---- last layer ---------------------------------------------------
    int l = L - 1;
    int kin = d.kin[l], nout = d.nout[l];
    const int F = nout - 1;
    build_a_in<BF16>(bufA, l, d, z, X0, d0, N, p0);
    const int Kp_last = round_up(nout, KT);
    for (int idx = tid; idx < TILE_M * Kp_last; idx += THREADS) {
      const int r = idx / Kp_last, c = idx - r * Kp_last;
      const int p = r % PTS, k = r / PTS - 1;
      float v = 0.0f;
      if (p0 + p < N) {
        if (r < PTS) {
          if (c == 0) {
            v = load_act<BF16>(c_sdf, p0 + p) * fl[p];
          } else if (c < nout) {
            v = load_act<BF16>(c_feat, (size_t)(p0 + p) * F + (c - 1));
          }
        } else if (c == 0) {
          v = load_act<BF16>(c_grad, (size_t)(p0 + p) * 3 + k) * fl[p];
        }
      }
      bufB[r * LDA + c] = v;
    }
    __syncthreads();
    accum_db(bufB, LDA, PTS, nout, part + d.boff[l]);
    // SDF column over all rows; feature columns over the primal rows (the
    // tangent rows' cotangent is zero there)
    accum_dw_col(bufA, LDA, bufB, LDA, TILE_M, kin, 0, part + d.woff[l], nout);
    accum_dw(bufA, LDA, bufB, LDA, PTS, kin, 1, F, part + d.woff[l], nout);
    propagate<BF16>(bufB, nout, PT + d.woff[l], kin, d.nout[l - 1], d.skip[l] != 0, Ws, bufA);
    float* ct = bufA;
    float* other = bufB;

    // ---- hidden layers ------------------------------------------------
    for (l = L - 2; l >= 0; --l) {
      kin = d.kin[l];
      nout = d.nout[l];
      const int Kp = round_up(nout, KT);
      const void* Zl = z.p[l];
      __syncthreads();  // ct is written
      for (int c = tid; c < Kp; c += THREADS) {
        if (c >= nout) {  // zero pad for the K loop of the next propagate
          for (int r = 0; r < TILE_M; ++r) ct[r * LDA + c] = 0.0f;
          continue;
        }
        float db = 0.0f;
        for (int p = 0; p < PTS; ++p) {
          float zv = 0.0f, u[3] = {0.0f, 0.0f, 0.0f};
          if (p0 + p < N) {
            zv = load_act<BF16>(Zl, (size_t)(p0 + p) * nout + c);
#pragma unroll
            for (int k = 0; k < 3; ++k)
              u[k] = load_act<BF16>(Zl, ((size_t)(k + 1) * N + p0 + p) * nout + c);
          }
          float h, s;
          gate100(zv, h, s);
          const float s2 = 100.0f * s * (1.0f - s);
          float* ch = &ct[p * LDA + c];
          float* t0 = &ct[(PTS + p) * LDA + c];
          float* t1 = &ct[(2 * PTS + p) * LDA + c];
          float* t2 = &ct[(3 * PTS + p) * LDA + c];
          const float ct_sum = *t0 * u[0] + *t1 * u[1] + *t2 * u[2];
          const float ct_z = *ch * s + ct_sum * s2;
          db += ct_z;
          *ch = rnd<BF16>(ct_z);
          *t0 = rnd<BF16>(s * *t0);
          *t1 = rnd<BF16>(s * *t1);
          *t2 = rnd<BF16>(s * *t2);
        }
        part[d.boff[l] + c] += db;
      }
      build_a_in<BF16>(other, l, d, z, X0, d0, N, p0);
      __syncthreads();
      accum_dw(other, LDA, ct, LDA, TILE_M, kin, 0, nout, part + d.woff[l], nout);
      if (l > 0) {
        propagate<BF16>(ct, nout, PT + d.woff[l], kin, d.nout[l - 1], d.skip[l] != 0, Ws, other);
        float* t = ct;
        ct = other;
        other = t;
      }
    }
  }
}

extern "C" int sdf_grad_bwd_launch(const float* x, int N, int multires, const int* desc,
                                   const float* P, const float* PT, void* const* z_in,
                                   const void* c_sdf, const void* c_feat, const void* c_grad,
                                   const float* flag, float* work, int grid, int n_params,
                                   float* out, void* stream) {
  const MlpDesc d = desc_from(desc);
  ZPtrs z;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) z.p[l] = z_in[l];
  const size_t smem = MLP_SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(sdf_grad_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sdf_grad_bwd_kernel<<<grid, THREADS, smem, s>>>(x, N, multires, d, P, PT, z, c_sdf, c_feat, c_grad,
                                                  flag, work, n_params);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<(n_params + THREADS - 1) / THREADS, THREADS, 0, s>>>(work, grid, n_params, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
