// K7f: SDF, features and spatial gradient of the hash-grid trunk over a
// given layer-0 input and its tangents.
//
// Replaces monosdf_tpu/ops/pallas_sdf_grad_grid.py _fwd_pallas_a0
// (pl.pallas_call at :165), the forward of sdf_mlp_with_grad_in. The input
// a0 (4, N, d0) float32 holds [PE(x) | grid features] and its three spatial
// tangents, assembled in PyTorch from the positional encoding and the K6
// encode. The structure is K2f's (sdf_grad.cu): a block takes PTS points and
// stacks their primal row and three tangent rows into one 64-row tile, so
// every weight stage in shared memory serves all four; between layers h =
// softplus_100(z) on the primal rows (bias only there), t = sigmoid(100 z)
// * u on the tangent rows. The last layer gives the SDF column for all rows
// (its tangents are the gradient) and the feature columns for the primal
// rows. The grid trunk has no skip and no sphere clamp. With BF16 the
// operands and the stored activations are rounded to bf16 and the features
// are written as bf16.
//
// Training output (null pointers skip it): z.p[l], each hidden layer's
// pre-activation Z at the operand type, laid out (4, N, nout_l).
//
// Limits: d0 <= 80 (LD0), hidden widths <= 256, a last layer of at most 257
// columns. Bound on the card: bytes at the bench's 104,448 training points
// (~120 MB of float32 a0 read and ~430 MB of bf16 Z written, 0.18 ms at
// 3.35 TB/s, against about 8.4e10 FLOP, 0.085 ms at 989 TFLOP/s bf16).
//
// bf16, with Z (the training step) or without (the render chunk): the
// tensor cores, K2f's training kernel (sdf_grad_tc.cuh, one body for both
// libraries) with a0 as layer 0's input, rounded to bf16 in the activation
// tile; weights packed once per call (kernels/sdf_grad.py pack_fwd). The
// grid model's fixed-sample renders meet their bars with it (PERF.md).
// float32: the SIMT kernel below, float32 FMAs on the CUDA cores (TF32
// would miss the float32 bars).
#include "common.cuh"

using namespace mk;

#include "sdf_grad_tc.cuh"

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
sdf_grad_grid_kernel(const float* __restrict__ a0, int N, int d0, MlpDesc d,
                     const float* __restrict__ P, float* __restrict__ sdf_out,
                     void* __restrict__ feat_out, float* __restrict__ grad_out,
                     const __grid_constant__ ZPtrs z) {
  extern __shared__ __align__(16) float smem[];
  float* X0 = smem;
  float* cur = X0 + TILE_M * LD0;
  float* nxt = cur + TILE_M * LDA;
  float* Ws = nxt + TILE_M * LDA;
  float* Zn = Ws + KT * TILE_N;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int p0 = blockIdx.x * PTS;

  load_a0_tile(a0, N, d0, p0, X0);
  __syncthreads();
  prep_first<BF16>(cur, X0, d0, TILE_M);

  int width = d0;
  const int L = d.n_layers;
  for (int l = 0; l < L - 1; ++l) {
    if (l > 0) prep_input<BF16>(cur, width, X0, d0, false, TILE_M);
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
  prep_input<BF16>(cur, width, X0, d0, false, TILE_M);
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
    const size_t o = (size_t)(p0 + p);
    sdf_out[o] = Zn[p * 4] + bias[0];
#pragma unroll
    for (int k = 0; k < 3; ++k) grad_out[o * 3 + k] = Zn[((k + 1) * PTS + p) * 4];
  }
}

// bf16: the tensor-core body on a0
__global__ void __launch_bounds__(TF_THREADS, 1)
sdf_grad_grid_kernel_tc(const float* __restrict__ a0, int N, int d0, MlpDesc d,
                        const float* __restrict__ P, const __nv_bfloat16* __restrict__ Wb,
                        FwdWb wb, float* __restrict__ sdf_out, __nv_bfloat16* __restrict__ feat_out,
                        float* __restrict__ grad_out, const __grid_constant__ ZPtrs z) {
  sdf_grad_tc_body<true>(nullptr, a0, N, d0, d, P, Wb, wb, 0.0f, 1.0f, -1, sdf_out, feat_out,
                         grad_out, nullptr, z);
}

// bf16: the tensor-core kernel on `ctas` persistent CTAs, with Wb (the
// packed bf16 weights, wb_off their per-layer offsets); float32: the SIMT
// kernel.
extern "C" int sdf_grad_grid_launch(const float* a0, int N, int d0, const int* desc,
                                    const float* P, const void* Wb, const int* wb_off,
                                    float* sdf_out, void* feat_out, float* grad_out,
                                    void* const* z_out, int bf16, int ctas, void* stream) {
  const MlpDesc d = desc_from(desc);
  ZPtrs z;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) z.p[l] = z_out[l];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    FwdWb wb;
    for (int l = 0; l < MK_MAX_LAYERS; ++l) wb.off[l] = wb_off[l];
    const size_t smem = sizeof(FwdSmem);
    cudaFuncSetAttribute(sdf_grad_grid_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const int n_tiles = (N + TF_PTS - 1) / TF_PTS;
    sdf_grad_grid_kernel_tc<<<ctas < n_tiles ? ctas : n_tiles, TF_THREADS, smem, s>>>(
        a0, N, d0, d, P, static_cast<const __nv_bfloat16*>(Wb), wb, sdf_out,
        static_cast<__nv_bfloat16*>(feat_out), grad_out, z);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = MLP_SMEM_FLOATS * sizeof(float);
  cudaFuncSetAttribute(sdf_grad_grid_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sdf_grad_grid_kernel<false><<<(N + PTS - 1) / PTS, THREADS, smem, s>>>(a0, N, d0, d, P, sdf_out,
                                                                         feat_out, grad_out, z);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
