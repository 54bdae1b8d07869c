// K3b: the backward of the radiance trunk with in-kernel normalisation.
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _radiance_norm_bwd_pallas
// (pl.pallas_call at :889), the VJP of radiance_norm. Inputs as the forward
// (g (N, 3) float32; sv (N, ds), feat (N, F) at the operand type) plus the
// cotangents co (N, nout) of rgb_pre and cn (N, 3) of the normals, at the
// operand type. Outputs: dg (N, 3) float32, df (N, F) at the operand type,
// and the parameter gradients in the packed-weight layout (W0 in its natural
// row order [sv, n, feat]). sv gets no cotangent.
//
// A block takes 64 samples. It recomputes n and the hidden layers as the
// forward does (bf16: each pre-activation rounded before the bias add and
// the ReLU) and keeps each hidden layer's ReLU output in shared memory (at
// most two hidden layers: the bench's 2x256 trunk). The reverse sweep, from
// the top: CT_l = ct * [y_l > 0] (ct = co at the output layer), db_l += sum
// of CT_l (float32), then CT_l rounded to the operand type, dW_l += A_l^T
// CT_l, ct = CT_l W_l^T. At layer 0, A_0 = [sv | n | feat] is rebuilt (n
// rounded to the operand type), df = CT_0 W0_feat^T, and the normalise
// backward takes both normal cotangents: dn = cn + CT_0 W0_n^T,
// dg = dn/q - g (<dn, g> / (q^2 r)) [|g|^2 > 1e-24], r = sqrt(max(|g|^2,
// 1e-24)), q = r + 1e-6.
//
// dW is summed as in sdf_grad_bwd.cu: a persistent grid, one float32
// partial per block, reduce_partials in block order.
//
// Bound on the card: operations (about 8.4e10 FLOP per 100,352 samples,
// three times the forward's, against ~110 MB of bf16 operands and outputs).
// This first version runs float32 FMAs on the CUDA cores.
#include "common.cuh"

using namespace mk;

constexpr int LDY = TILE_N;  // row stride of a hidden layer's output
constexpr int NRM = 8;       // per-row scratch: n (3), g (3), |g|^2, q
constexpr size_t BWD_SMEM_FLOATS =
    TILE_M * NRM + TILE_M * LDA + 2 * TILE_M * LDY + KT * TILE_N + TILE_M * 4;

// The layer-0 input row [sv | rnd(n) | feat], zero-padded to round_up(K0, KT).
template <bool BF16>
__device__ __forceinline__ void build_h0(float* dst, const float* Nr, const void* sv, int ds,
                                         const void* feat, int F, int N, int row0) {
  const int K0 = ds + 3 + F;
  const int Kp = round_up(K0, KT);
  for (int idx = threadIdx.x; idx < TILE_M * Kp; idx += THREADS) {
    const int r = idx / Kp, c = idx - r * Kp;
    const size_t gr = (size_t)(row0 + r);
    float v = 0.0f;
    if (row0 + r < N) {
      if (c < ds) {
        v = load_act<BF16>(sv, gr * ds + c);
      } else if (c < ds + 3) {
        v = rnd<BF16>(Nr[r * NRM + (c - ds)]);
      } else if (c < K0) {
        v = load_act<BF16>(feat, gr * F + (c - ds - 3));
      }
    }
    dst[r * LDA + c] = v;
  }
}

// In place: CT = ct * [y > 0] (Y holds relu(y)); db += its column sums;
// then CT rounded to the operand type, pad columns up to round_up(n, KT) zeroed.
template <bool BF16>
__device__ __forceinline__ void relu_reverse(float* ct, int ldc, const float* Y, int n,
                                             float* db) {
  const int Kp = round_up(n, KT);
  for (int c = threadIdx.x; c < Kp; c += THREADS) {
    if (c >= n) {
      for (int r = 0; r < TILE_M; ++r) ct[r * ldc + c] = 0.0f;
      continue;
    }
    float s = 0.0f;
    for (int r = 0; r < TILE_M; ++r) {
      const float v = ct[r * ldc + c] * (Y[r * LDY + c] > 0.0f ? 1.0f : 0.0f);
      s += v;
      ct[r * ldc + c] = rnd<BF16>(v);
    }
    db[c] += s;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
radiance_norm_bwd_kernel(const float* __restrict__ g, const void* __restrict__ sv, int ds,
                         const void* __restrict__ feat, int F, int N, MlpDesc d,
                         const float* __restrict__ P, const float* __restrict__ PT,
                         const void* __restrict__ co, const void* __restrict__ cn,
                         float* __restrict__ dg_out, void* __restrict__ df_out,
                         float* __restrict__ work, int n_params) {
  extern __shared__ __align__(16) float smem[];
  float* Nr = smem;                  // TILE_M x NRM
  float* bufA = Nr + TILE_M * NRM;   // TILE_M x LDA: h0, the top cotangent
  float* Y0 = bufA + TILE_M * LDA;   // TILE_M x LDY: relu(y_0)
  float* Y1 = Y0 + TILE_M * LDY;     // TILE_M x LDY: relu(y_1), then CT_0
  float* Ws = Y1 + TILE_M * LDY;
  float* Zn = Ws + KT * TILE_N;      // TILE_M x 4: co, then dn
  float* Y[2] = {Y0, Y1};
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int L = d.n_layers, H = L - 1;
  const int K0 = ds + 3 + F;
  const int n_out = d.nout[L - 1];
  const int n_tiles = (N + TILE_M - 1) / TILE_M;
  float* part = work + (size_t)blockIdx.x * n_params;
  zero_partial(part, n_params);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    __syncthreads();  // the previous tile is done with shared memory
    if (tid < TILE_M) {
      const int r = row0 + tid;
      float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
      if (r < N) {
        g0 = g[(size_t)r * 3];
        g1 = g[(size_t)r * 3 + 1];
        g2 = g[(size_t)r * 3 + 2];
      }
      const float sq = g0 * g0 + g1 * g1 + g2 * g2;
      const float q = sqrtf(fmaxf(sq, 1e-24f)) + 1e-6f;
      float* nr = Nr + tid * NRM;
      nr[0] = g0 / q;
      nr[1] = g1 / q;
      nr[2] = g2 / q;
      nr[3] = g0;
      nr[4] = g1;
      nr[5] = g2;
      nr[6] = sq;
      nr[7] = q;
    }
    __syncthreads();
    build_h0<BF16>(bufA, Nr, sv, ds, feat, F, N, row0);

    // ---- forward: the hidden layers' ReLU outputs ---------------------
    const float* cur = bufA;
    int ldc = LDA;
    for (int l = 0; l < H; ++l) {
      __syncthreads();
      const int K = d.kin[l], nout = d.nout[l];
      const float* bias = P + d.boff[l];
      float acc[8][8];
      gemm_tile<BF16>(cur, ldc, K, P + d.woff[l], nout, 0, nout, Ws, acc);
      const int Knext = round_up(nout, KT);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(tx, j);
        if (c < Knext) {
          const float bc = c < nout ? rnd<BF16>(bias[c]) : 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float y = c < nout ? rnd<BF16>(rnd<BF16>(acc[i][j]) + bc) : 0.0f;
            Y[l][(ty * 8 + i) * LDY + c] = fmaxf(y, 0.0f);
          }
        }
      }
      cur = Y[l];
      ldc = LDY;
    }

    // ---- output layer: CT = co ----------------------------------------
    for (int idx = tid; idx < TILE_M * n_out; idx += THREADS) {
      const int r = idx / n_out, j = idx - r * n_out;
      Zn[r * 4 + j] = row0 + r < N ? load_act<BF16>(co, (size_t)(row0 + r) * n_out + j) : 0.0f;
    }
    __syncthreads();
    {
      const int l = L - 1, kin = d.kin[l];
      const float* W = P + d.woff[l];
      for (int j = tid; j < n_out; j += THREADS) {
        float s = 0.0f;
        for (int r = 0; r < TILE_M; ++r) s += Zn[r * 4 + j];
        part[d.boff[l] + j] += s;
      }
      for (int k = tid; k < kin; k += THREADS) {
        for (int j = 0; j < n_out; ++j) {
          float s = 0.0f;
          for (int r = 0; r < TILE_M; ++r) s = fmaf(Y[H - 1][r * LDY + k], Zn[r * 4 + j], s);
          part[d.woff[l] + k * n_out + j] += s;
        }
      }
      // the top cotangent co W^T: into bufA with two hidden layers (h0 is
      // rebuilt later), else into Y1
      float* top = H == 2 ? bufA : Y1;
      const int ldt = H == 2 ? LDA : LDY;
      for (int idx = tid; idx < TILE_M * kin; idx += THREADS) {
        const int r = idx / kin, c = idx - r * kin;
        float s = 0.0f;
        for (int j = 0; j < n_out; ++j) s = fmaf(Zn[r * 4 + j], rnd<BF16>(W[c * n_out + j]), s);
        top[r * ldt + c] = s;
      }
    }

    // ---- hidden layers, top down; CT_0 ends in Y1 ---------------------
    float* ct = H == 2 ? bufA : Y1;
    int ldct = H == 2 ? LDA : LDY;
    for (int l = H - 1; l >= 0; --l) {
      const int kin = d.kin[l], nout = d.nout[l];
      __syncthreads();
      relu_reverse<BF16>(ct, ldct, Y[l], nout, part + d.boff[l]);
      if (l == 0) break;
      __syncthreads();
      accum_dw(Y[l - 1], LDY, ct, ldct, TILE_M, kin, 0, nout, part + d.woff[l], nout);
      // ct_{l-1} = CT_l W_l^T into Y[l], whose ReLU mask has been used
      float acc[8][8];
      gemm_tile<BF16>(ct, ldct, nout, PT + d.woff[l], kin, 0, kin, Ws, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(tx, j);
        if (c < kin) {
#pragma unroll
          for (int i = 0; i < 8; ++i) Y[l][(ty * 8 + i) * LDY + c] = acc[i][j];
        }
      }
      ct = Y[l];
      ldct = LDY;
    }

    // ---- layer 0: dW0 from [sv | n | feat], df, dn, dg ----------------
    __syncthreads();  // CT_0 is rounded; bufA is free
    build_h0<BF16>(bufA, Nr, sv, ds, feat, F, N, row0);
    __syncthreads();
    const int n0 = d.nout[0];
    accum_dw(bufA, LDA, ct, ldct, TILE_M, K0, 0, n0, part + d.woff[0], n0);
    const float* WT0 = PT + d.woff[0];  // n0 x K0
    gemm_narrow<BF16>(ct, ldct, n0, WT0, K0, ds, 3, TILE_M, Zn);
    float acc[8][8];
    gemm_tile<BF16>(ct, ldct, n0, WT0, K0, ds + 3, F, Ws, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(tx, j);
      if (c < F) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = ty * 8 + i;
          if (row0 + r < N) store_act<BF16>(df_out, (size_t)(row0 + r) * F + c, acc[i][j]);
        }
      }
    }
    __syncthreads();  // dn (Zn) is written
    if (tid < TILE_M && row0 + tid < N) {
      const size_t gr = (size_t)(row0 + tid);
      const float* nr = Nr + tid * NRM;
      const float sq = nr[6], q = nr[7];
      const float r = sqrtf(fmaxf(sq, 1e-24f));
      const float live = sq > 1e-24f ? 1.0f : 0.0f;
      float dn[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) dn[k] = load_act<BF16>(cn, gr * 3 + k) + Zn[tid * 4 + k];
      const float dot_cg = dn[0] * nr[3] + dn[1] * nr[4] + dn[2] * nr[5];
      const float f = dot_cg / (q * q * r);
#pragma unroll
      for (int k = 0; k < 3; ++k) dg_out[gr * 3 + k] = dn[k] / q - nr[3 + k] * f * live;
    }
  }
}

extern "C" int radiance_norm_bwd_launch(const float* g, const void* sv, int ds, const void* feat,
                                        int F, int N, const int* desc, const float* P,
                                        const float* PT, const void* co, const void* cn,
                                        float* dg_out, void* df_out, float* work, int grid,
                                        int n_params, float* out, int bf16, void* stream) {
  const MlpDesc d = desc_from(desc);
  const size_t smem = BWD_SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaFuncSetAttribute(radiance_norm_bwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    radiance_norm_bwd_kernel<true><<<grid, THREADS, smem, s>>>(g, sv, ds, feat, F, N, d, P, PT, co, cn,
                                                               dg_out, df_out, work, n_params);
  } else {
    cudaFuncSetAttribute(radiance_norm_bwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    radiance_norm_bwd_kernel<false><<<grid, THREADS, smem, s>>>(g, sv, ds, feat, F, N, d, P, PT, co, cn,
                                                                dg_out, df_out, work, n_params);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<(n_params + THREADS - 1) / THREADS, THREADS, 0, s>>>(work, grid, n_params, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
