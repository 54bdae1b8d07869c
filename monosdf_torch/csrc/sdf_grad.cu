// K2 forward: SDF, features and the spatial gradient of the SDF MLP.
//
// Replaces monosdf_tpu/ops/pallas_sdf_grad.py _fwd_pallas (pl.pallas_call at
// :414), the forward of sdf_mlp_with_grad. A block takes PTS points from raw
// xyz and computes their positional embedding and its three basis tangents
// in-kernel, as TPU kernel_pe does. The primal rows and the 3*PTS tangent
// rows are stacked into one 64-row tile, so every weight stage in shared
// memory serves all four. Between layers: h = softplus_100(z) on the primal
// rows (bias only there), t = sigmoid(100 z) * u on the tangent rows; the
// skip concatenation applies to the tangents too. The last layer gives the
// SDF column for all rows (its tangents are the gradient) and the feature
// columns for the primal rows. The bounding-sphere clamp runs in-kernel:
// take = sdf <= s*(R - |x|), else sdf = s*(R - |x|), grad = -s x/|x|; points
// at or after clamp_rows (when >= 0, the folded eikonal batch) keep the MLP's
// values. With BF16 the operands and the stored activations are rounded to
// bf16 and the features are written as bf16, as in the TPU kernel.
//
// Training outputs (null pointers skip them): flag, 1.0 where the MLP's
// value was kept; and z.p[l], each hidden layer's pre-activation Z at the
// operand type, laid out (4, N, nout_l): the primal row (bias added), then
// the tangent rows along x, y, z.
//
// Bound on the card: operations (about 3.8e11 FLOP per 100,352-point chunk
// against ~50 MB moved, plus ~1.6 GB of bf16 Z when training). This first
// version runs float32 FMAs on the CUDA cores.
#include "common.cuh"

using namespace mk;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
sdf_grad_kernel(const float* __restrict__ x, int N, int multires, MlpDesc d,
                const float* __restrict__ P, float bounding_sphere, float sphere_scale,
                int clamp_rows, float* __restrict__ sdf_out, void* __restrict__ feat_out,
                float* __restrict__ grad_out, float* __restrict__ flag_out,
                const __grid_constant__ ZPtrs z) {
  extern __shared__ __align__(16) float smem[];
  float* X0 = smem;
  float* cur = X0 + TILE_M * LD0;
  float* nxt = cur + TILE_M * LDA;
  float* Ws = nxt + TILE_M * LDA;
  float* Zn = Ws + KT * TILE_N;
  __shared__ float xs[PTS][3];
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int p0 = blockIdx.x * PTS;
  const int d0 = 3 * (1 + 2 * multires);

  load_pe_tile(x, N, p0, multires, xs, X0);
  __syncthreads();
  prep_first<BF16>(cur, X0, d0, TILE_M);

  int width = d0;
  const int L = d.n_layers;
  for (int l = 0; l < L - 1; ++l) {
    if (l > 0) prep_input<BF16>(cur, width, X0, d0, d.skip[l] != 0, TILE_M);
    __syncthreads();
    const int K = d.kin[l], nout = d.nout[l];
    const float* bias = P + d.boff[l];
    float acc[8][8];
    gemm_tile<BF16>(cur, LDA, K, P + d.woff[l], nout, 0, nout, Ws, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(tx, j);
      if (c < nout) {
        const float bc = bias[c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = ty * 8 + i;
          nxt[r * LDA + c] = r < PTS ? acc[i][j] + bc : acc[i][j];
        }
      }
    }
    __syncthreads();
    void* zl = z.p[l];
    for (int idx = tid; idx < PTS * nout; idx += THREADS) {
      const int p = idx / nout, c = idx - p * nout;
      if (zl != nullptr && p0 + p < N) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          store_act<BF16>(zl, ((size_t)k * N + p0 + p) * nout + c, nxt[(k * PTS + p) * LDA + c]);
      }
      float h, s;
      gate100(nxt[p * LDA + c], h, s);
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        float* tk = &nxt[(k * PTS + p) * LDA + c];
        *tk = rnd<BF16>(s * *tk);
      }
      nxt[p * LDA + c] = rnd<BF16>(h);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    width = nout;
  }

  // last layer: SDF column for all rows, feature columns for the primal rows
  prep_input<BF16>(cur, width, X0, d0, d.skip[L - 1] != 0, TILE_M);
  __syncthreads();
  const int K = d.kin[L - 1], nout = d.nout[L - 1], F = nout - 1;
  const float* W = P + d.woff[L - 1];
  const float* bias = P + d.boff[L - 1];
  gemm_narrow<BF16>(cur, LDA, K, W, nout, 0, 1, TILE_M, Zn);
  float acc[8][8];
  gemm_tile<BF16>(cur, LDA, K, W, nout, 1, F, Ws, acc);
  if (ty * 8 < PTS) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(tx, j);
      if (c < F) {
        const float bc = bias[1 + c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int p = ty * 8 + i;
          if (p < PTS && p0 + p < N) store_act<BF16>(feat_out, (size_t)(p0 + p) * F + c, acc[i][j] + bc);
        }
      }
    }
  }
  __syncthreads();
  if (tid < PTS && p0 + tid < N) {
    const int p = tid;
    float sdf = Zn[p * 4] + bias[0];
    float g[3] = {Zn[(PTS + p) * 4], Zn[(2 * PTS + p) * 4], Zn[(3 * PTS + p) * 4]};
    bool take = true;
    if (bounding_sphere > 0.0f) {
      const float x0 = xs[p][0], x1 = xs[p][1], x2 = xs[p][2];
      const float norm = sqrtf(x0 * x0 + x1 * x1 + x2 * x2);
      const float sphere = sphere_scale * (bounding_sphere - norm);
      take = sdf <= sphere || (clamp_rows >= 0 && p0 + p >= clamp_rows);
      if (!take) {
        sdf = sphere;
        const float q = -sphere_scale / fmaxf(norm, 1e-12f);
        g[0] = x0 * q;
        g[1] = x1 * q;
        g[2] = x2 * q;
      }
    }
    const size_t o = (size_t)(p0 + p);
    sdf_out[o] = sdf;
    grad_out[o * 3 + 0] = g[0];
    grad_out[o * 3 + 1] = g[1];
    grad_out[o * 3 + 2] = g[2];
    if (flag_out != nullptr) flag_out[o] = take ? 1.0f : 0.0f;
  }
}

extern "C" int sdf_grad_launch(const float* x, int N, int multires, const int* desc,
                               const float* P, float bounding_sphere, float sphere_scale,
                               int clamp_rows, float* sdf_out, void* feat_out, float* grad_out,
                               float* flag_out, void* const* z_out, int bf16, void* stream) {
  const MlpDesc d = desc_from(desc);
  ZPtrs z;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) z.p[l] = z_out[l];
  const size_t smem = MLP_SMEM_FLOATS * sizeof(float);
  const dim3 grid((N + PTS - 1) / PTS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaFuncSetAttribute(sdf_grad_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    sdf_grad_kernel<true><<<grid, THREADS, smem, s>>>(x, N, multires, d, P, bounding_sphere,
                                                      sphere_scale, clamp_rows, sdf_out, feat_out,
                                                      grad_out, flag_out, z);
  } else {
    cudaFuncSetAttribute(sdf_grad_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    sdf_grad_kernel<false><<<grid, THREADS, smem, s>>>(x, N, multires, d, P, bounding_sphere,
                                                       sphere_scale, clamp_rows, sdf_out, feat_out,
                                                       grad_out, flag_out, z);
  }
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
