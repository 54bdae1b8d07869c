// K2f: SDF, features and the spatial gradient of the SDF MLP.
//
// Replaces monosdf_tpu/ops/pallas_sdf_grad.py _fwd_pallas (pl.pallas_call at
// :414), the forward of sdf_mlp_with_grad. A tile's points come as raw xyz;
// their positional embedding and its three basis tangents are computed
// in-kernel in float32 (pe_value), as TPU kernel_pe does, and rounded to the
// operand type at each product. The primal rows and the tangent rows run
// through the MLP together: between layers h = softplus_100(z) on the primal
// rows (bias only there), t = sigmoid(100 z) * u on the tangent rows; a skip
// layer concatenates the embedding and its tangents and divides by sqrt 2.
// The last layer gives the SDF column for all rows (its tangents are the
// gradient) and the feature columns for the primal rows. The bounding-sphere
// clamp runs in-kernel: take = sdf <= s*(R - |x|), else sdf = s*(R - |x|),
// grad = -s x/|x|; points at or after clamp_rows (when >= 0, the folded
// eikonal batch) keep the MLP's values. With bf16 the operands and the stored
// activations are rounded to bf16 and the features are written as bf16, as
// in the TPU kernel.
//
// Training outputs (null pointers skip them): flag, 1.0 where the MLP's
// value was kept; and z.p[l], each hidden layer's pre-activation Z at the
// operand type, laid out (4, N, nout_l): the primal row (bias added), then
// the tangent rows along x, y, z (K2b reads this layout).
//
// Bound on the card: operations for the render chunk (about 4.2e11 FLOP per
// 100,352 points, 0.39 ms at 989 TFLOP/s bf16, against ~50 MB moved); bytes
// for the training variant at the step's 104,448 points (~1.7 GB of bf16 Z
// written, 0.52 ms at 3.35 TB/s).
//
// bf16 training variant (Z written): the tensor cores, the body of
// sdf_grad_tc.cuh (shared with K7f, sdf_grad_grid.cu), whose comment gives
// its design.
//
// The render chunk (no Z) and float32 stay on the SIMT kernel below:
// float32 FMAs on the CUDA cores, one 256-thread block per 16 points (64
// stacked rows) and each layer's weights streamed 16 rows at a time. Its
// FMA chains run over the inputs in order, as the plain version's float32
// product does, so its bf16 roundings land where the plain version's do;
// the renders are held to the plain version at fixed samples (bf16 normals
// 1e-2), and through s = sigmoid(100 z) the tangent rows turn the float32
// differences of any other summation order into gradient differences 100x
// larger: the tensor-core kernel's renders of the appearance-code model (no
// SDF clamp) missed that bar (normals 1.4e-2 and 2.4e-2, PERF.md). TF32
// tensor cores would miss the float32 bars (1e-4 against the plain version,
// 2e-5 on renders).
#include "common.cuh"

using namespace mk;

#include "sdf_grad_tc.cuh"

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

// bf16 training variant: the tensor-core body on the raw points
__global__ void __launch_bounds__(TF_THREADS, 1)
sdf_grad_kernel_tc(const float* __restrict__ x, int N, int multires, MlpDesc d,
                   const float* __restrict__ P, const __nv_bfloat16* __restrict__ Wb, FwdWb wb,
                   float bounding_sphere, float sphere_scale, int clamp_rows,
                   float* __restrict__ sdf_out, __nv_bfloat16* __restrict__ feat_out,
                   float* __restrict__ grad_out, float* __restrict__ flag_out,
                   const __grid_constant__ ZPtrs z) {
  sdf_grad_tc_body<false>(x, nullptr, N, 3 * (1 + 2 * multires), d, P, Wb, wb, bounding_sphere,
                          sphere_scale, clamp_rows, sdf_out, feat_out, grad_out, flag_out, z);
}

// The training variant (Z written, bf16) takes the tensor-core kernel with
// Wb (the packed bf16 weights, wb_off their per-layer offsets) on `ctas`
// persistent CTAs; the render chunk (no Z) and float32 the SIMT kernel.
extern "C" int sdf_grad_launch(const float* x, int N, int multires, const int* desc,
                               const float* P, const void* Wb, const int* wb_off,
                               float bounding_sphere, float sphere_scale, int clamp_rows,
                               float* sdf_out, void* feat_out, float* grad_out, float* flag_out,
                               void* const* z_out, int bf16, int ctas, void* stream) {
  const MlpDesc d = desc_from(desc);
  ZPtrs z;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) z.p[l] = z_out[l];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && Wb != nullptr) {
    FwdWb wb;
    for (int l = 0; l < MK_MAX_LAYERS; ++l) wb.off[l] = wb_off[l];
    const size_t smem = sizeof(FwdSmem);
    cudaFuncSetAttribute(sdf_grad_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const int n_tiles = (N + TF_PTS - 1) / TF_PTS;
    sdf_grad_kernel_tc<<<ctas < n_tiles ? ctas : n_tiles, TF_THREADS, smem, s>>>(
        x, N, multires, d, P, static_cast<const __nv_bfloat16*>(Wb), wb, bounding_sphere,
        sphere_scale, clamp_rows, sdf_out, static_cast<__nv_bfloat16*>(feat_out), grad_out,
        flag_out, z);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = MLP_SMEM_FLOATS * sizeof(float);
  const dim3 grid((N + PTS - 1) / PTS);
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
