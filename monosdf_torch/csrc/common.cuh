// Shared pieces of the MLP kernels (sdf_mlp.cu, sdf_grad.cu, sdf_grad_grid.cu
// and the backward kernels sdf_grad_bwd.cu, sdf_grad_grid_bwd.cu; the
// radiance kernels through radiance.cuh) and the C-interface helpers of
// every kernel library.
//
// The MLP kernels keep one tile of activations (TILE_M rows) in shared
// memory and stream each layer's weights through shared memory KT rows at a
// time. A block of 256 threads computes a TILE_M x 256 output tile; each
// thread owns 8 rows x 8 columns of float32 accumulators (columns tx*4+0..3
// and 128+tx*4+0..3, so a warp's weight reads are contiguous float4s). With
// BF16 set, every matmul operand is rounded to bfloat16 and the sums stay
// float32, as on the TPU's MXU; a product of two bf16 values is exact in
// float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MK_MAX_LAYERS 16

namespace mk {

constexpr int THREADS = 256;
constexpr int TILE_M = 64;   // activation rows per block
constexpr int TILE_N = 256;  // output columns per pass (one per thread)
constexpr int KT = 16;       // weight rows per shared-memory stage
constexpr int LDA = 304;     // activation row stride: widths up to 304
constexpr int LD0 = 80;      // layer-0 input row stride: d0 up to 80 (the grid trunk's 71)
constexpr float SQRT2 = 1.41421356237309515f;

// Layer table of a packed MLP: W_l is kin x nout row-major at P + woff[l],
// b_l at P + boff[l]; skip[l] concatenates the input embedding before layer l.
struct MlpDesc {
  int n_layers;
  int kin[MK_MAX_LAYERS];
  int nout[MK_MAX_LAYERS];
  int woff[MK_MAX_LAYERS];
  int boff[MK_MAX_LAYERS];
  int skip[MK_MAX_LAYERS];
};

inline MlpDesc desc_from(const int* d) {
  MlpDesc m;
  m.n_layers = d[0];
  for (int l = 0; l < MK_MAX_LAYERS; ++l) {
    m.kin[l] = d[1 + l];
    m.nout[l] = d[1 + MK_MAX_LAYERS + l];
    m.woff[l] = d[1 + 2 * MK_MAX_LAYERS + l];
    m.boff[l] = d[1 + 3 * MK_MAX_LAYERS + l];
    m.skip[l] = d[1 + 4 * MK_MAX_LAYERS + l];
  }
  return m;
}

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <bool BF16>
__device__ __forceinline__ float load_act(const void* p, size_t i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else {
    return static_cast<const float*>(p)[i];
  }
}

template <bool BF16>
__device__ __forceinline__ void store_act(void* p, size_t i, float v) {
  if constexpr (BF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// softplus with beta = 100, overflow-safe (pallas_mlp.py _softplus100)
__device__ __forceinline__ float softplus100(float x) {
  return x > 0.2f ? x : log1pf(expf(100.0f * fminf(x, 0.2f))) / 100.0f;
}

// (softplus_100(z), sigmoid(100 z)) from one exponential (pallas_sdf_grad.py _gate100)
__device__ __forceinline__ void gate100(float z, float& h, float& s) {
  const float e = expf(100.0f * fminf(z, 0.2f));
  const bool hot = z > 0.2f;
  s = hot ? 1.0f : e / (1.0f + e);
  h = hot ? z : log1pf(e) / 100.0f;
}

// column of accumulator j of lane tx
__device__ __forceinline__ int tile_col(int tx, int j) {
  return j < 4 ? tx * 4 + j : 128 + tx * 4 + (j - 4);
}

// acc[i][j] = sum_k As[(ty*8+i)*lda + k] * W[k*ldw + col0 + tile_col(tx, j)]
// for k < K, columns < ncols (zero beyond). As must hold zeros in columns
// [K, round_up(K, KT)). Ws is a KT x TILE_N shared-memory stage.
template <bool BF16>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ As, int lda, int K,
                                          const float* __restrict__ W, int ldw, int col0,
                                          int ncols, float* __restrict__ Ws, float acc[8][8]) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();  // the previous stage has been read
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      const int k = k0 + kk;
      float w = 0.0f;
      if (k < K && tid < ncols) w = rnd<BF16>(W[(size_t)k * ldw + col0 + tid]);
      Ws[kk * TILE_N + tid] = w;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < KT; ++kk) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty * 8 + i) * lda + k0 + kk];
      const float4 w0 = *reinterpret_cast<const float4*>(&Ws[kk * TILE_N + tx * 4]);
      const float4 w1 = *reinterpret_cast<const float4*>(&Ws[kk * TILE_N + 128 + tx * 4]);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
}

// out[r*4 + j] = sum_k As[r*lda + k] * W[k*ldw + col0 + j] for r < rows,
// j < ncols <= 4: one warp per row, lanes stride over k, shuffle reduction.
template <bool BF16>
__device__ __forceinline__ void gemm_narrow(const float* __restrict__ As, int lda, int K,
                                            const float* __restrict__ W, int ldw, int col0,
                                            int ncols, int rows, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += THREADS / 32) {
    for (int j = 0; j < ncols; ++j) {
      float s = 0.0f;
      for (int k = lane; k < K; k += 32)
        s = fmaf(As[r * lda + k], rnd<BF16>(W[(size_t)k * ldw + col0 + j]), s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) out[r * 4 + j] = s;
    }
  }
}

// In place: the layer input of a hidden/last layer from the previous
// layer's activations in cur (width cols) and, for a skip layer, the input
// embedding X0 (d0 cols): [h, x0] / sqrt(2). Rounds to the operand type and
// zeroes the pad columns up to round_up(K, KT).
template <bool BF16>
__device__ __forceinline__ void prep_input(float* cur, int width, const float* X0, int d0,
                                           bool skip, int rows) {
  const int Kp = round_up(width + (skip ? d0 : 0), KT);
  for (int idx = threadIdx.x; idx < rows * Kp; idx += THREADS) {
    const int r = idx / Kp, c = idx - r * Kp;
    float v = 0.0f;
    if (c < width) {
      v = skip ? rnd<BF16>(cur[r * LDA + c] / SQRT2) : rnd<BF16>(cur[r * LDA + c]);
    } else if (skip && c < width + d0) {
      v = rnd<BF16>(X0[r * LD0 + (c - width)] / SQRT2);
    }
    cur[r * LDA + c] = v;
  }
}

// In place: the first layer's input, the embedding X0 (d0 cols) rounded to
// the operand type, zero-padded to round_up(d0, KT).
template <bool BF16>
__device__ __forceinline__ void prep_first(float* cur, const float* X0, int d0, int rows) {
  const int Kp = round_up(d0, KT);
  for (int idx = threadIdx.x; idx < rows * Kp; idx += THREADS) {
    const int r = idx / Kp, c = idx - r * Kp;
    cur[r * LDA + c] = c < d0 ? rnd<BF16>(X0[r * LD0 + c]) : 0.0f;
  }
}

// dynamic shared memory of an MLP kernel: X0, two activation buffers, one
// weight stage and the narrow-output scratch
constexpr size_t MLP_SMEM_FLOATS = TILE_M * LD0 + 2 * TILE_M * LDA + KT * TILE_N + TILE_M * 4;

// -- the SDF MLP with its spatial gradient (sdf_grad.cu, sdf_grad_bwd.cu) --

constexpr int PTS = TILE_M / 4;  // points per tile: a primal row and 3 tangent rows each

// Per-layer pointers of the saved pre-activations Z, each (4, N, nout_l). A
// kernel takes it as a __grid_constant__ parameter, so indexing it by layer
// reads the parameter space instead of a local copy.
struct ZPtrs {
  void* p[MK_MAX_LAYERS];
};

// xs <- the tile's PTS points (zero past N); X0 <- their embedding
// [x, sin(2^f x), cos(2^f x), ...] (row p) and its tangent along axis k
// (row (k+1)*PTS + p), as TPU kernel_pe computes them.
__device__ __forceinline__ void load_pe_tile(const float* __restrict__ x, int N, int p0,
                                             int multires, float (*xs)[3], float* X0) {
  const int tid = threadIdx.x;
  const int d0 = 3 * (1 + 2 * multires);
  if (tid < PTS * 3) {
    const int p = tid / 3, k = tid - p * 3;
    xs[p][k] = p0 + p < N ? x[(size_t)(p0 + p) * 3 + k] : 0.0f;
  }
  __syncthreads();
  for (int idx = tid; idx < PTS * LD0; idx += THREADS) {
    const int p = idx / LD0, c = idx - p * LD0;
    float e = 0.0f, t[3] = {0.0f, 0.0f, 0.0f};
    if (c < 3) {
      e = xs[p][c];
      t[c] = 1.0f;
    } else if (c < d0) {
      const int f = (c - 3) / 6, part = ((c - 3) % 6) / 3, k = (c - 3) % 3;
      const float fr = (float)(1 << f);
      const float v = fr * xs[p][k];
      const float sv = sinf(v), cv = cosf(v);
      e = part == 0 ? sv : cv;
      t[k] = part == 0 ? fr * cv : -fr * sv;
    }
    X0[p * LD0 + c] = e;
#pragma unroll
    for (int k = 0; k < 3; ++k) X0[((k + 1) * PTS + p) * LD0 + c] = t[k];
  }
}

// X0 <- the tile's PTS points' layer-0 input given in a0 (4, N, d0) float32:
// a0[0] the input rows, a0[1 + k] their tangents along axis k, as row
// k*PTS + p (zero past N and past d0).
__device__ __forceinline__ void load_a0_tile(const float* __restrict__ a0, int N, int d0, int p0,
                                             float* X0) {
  for (int idx = threadIdx.x; idx < TILE_M * LD0; idx += THREADS) {
    const int r = idx / LD0, c = idx - r * LD0;
    const int k = r / PTS, p = r - k * PTS;
    X0[idx] = (c < d0 && p0 + p < N) ? a0[((size_t)k * N + p0 + p) * d0 + c] : 0.0f;
  }
}

// The layer-l matmul input into dst, rounded to the operand type: the
// layer-0 input X0 for l == 0; else [h | s*u_k] from the stored Z of layer
// l-1, concatenated with X0 and divided by sqrt 2 at a skip layer.
template <bool BF16>
__device__ void build_a_in(float* dst, int l, const MlpDesc& d, const ZPtrs& z,
                           const float* X0, int d0, int N, int p0) {
  if (l == 0) {
    prep_first<BF16>(dst, X0, d0, TILE_M);
    return;
  }
  const int w = d.nout[l - 1];
  const bool skip = d.skip[l] != 0;
  const void* Z = z.p[l - 1];
  for (int idx = threadIdx.x; idx < PTS * w; idx += THREADS) {
    const int p = idx / w, c = idx - p * w;
    float zv = 0.0f, u[3] = {0.0f, 0.0f, 0.0f};
    if (p0 + p < N) {
      zv = load_act<BF16>(Z, (size_t)(p0 + p) * w + c);
#pragma unroll
      for (int k = 0; k < 3; ++k) u[k] = load_act<BF16>(Z, ((size_t)(k + 1) * N + p0 + p) * w + c);
    }
    float h, s;
    gate100(zv, h, s);
    const float v[4] = {h, s * u[0], s * u[1], s * u[2]};
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[(k * PTS + p) * LDA + c] = rnd<BF16>(skip ? v[k] / SQRT2 : v[k]);
  }
  if (skip) {
    for (int idx = threadIdx.x; idx < TILE_M * d0; idx += THREADS) {
      const int r = idx / d0, c = idx - r * d0;
      dst[r * LDA + w + c] = rnd<BF16>(X0[r * LD0 + c] / SQRT2);
    }
  }
}

// out[:, :nprev] = CT[:, :K] W^T (WT: W^T packed row-major, K x ldw), divided
// by sqrt 2 when skip: the cotangent of the previous layer's output.
template <bool BF16>
__device__ void propagate(const float* CT, int K, const float* WT, int ldw, int nprev, bool skip,
                          float* Ws, float* out) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[8][8];
  gemm_tile<BF16>(CT, LDA, K, WT, ldw, 0, nprev, Ws, acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tile_col(tx, j);
    if (c < nprev) {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[(ty * 8 + i) * LDA + c] = skip ? acc[i][j] / SQRT2 : acc[i][j];
    }
  }
}

// -- weight gradients of the backward kernels --------------------------------
//
// A backward block accumulates its rows' dW = A^T CT into its own partial,
// a copy of the packed-weight layout in device memory; reduce_partials sums
// the blocks' partials in a fixed order afterwards, so a run's gradients do
// not depend on which block finished first.

// dst[k * ldd + col0 + c] += sum_{r < rows} A[r * lda + k] * CT[r * ldc + col0 + c]
// for k < kin, c < ncols. Each pass covers 64 k by 256 c; lane tx owns the
// columns tx + 32 j, so the read-modify-write of dst is coalesced.
__device__ __forceinline__ void accum_dw(const float* __restrict__ A, int lda,
                                         const float* __restrict__ CT, int ldc, int rows, int kin,
                                         int col0, int ncols, float* __restrict__ dst, int ldd) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  for (int c0 = 0; c0 < ncols; c0 += TILE_N) {
    for (int k0 = 0; k0 < kin; k0 += 64) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = k0 + ty * 8 + i;
          a[i] = k < kin ? A[r * lda + k] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c0 + tx + 32 * j;
          b[j] = c < ncols ? CT[r * ldc + col0 + c] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + ty * 8 + i;
        if (k < kin) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c0 + tx + 32 * j;
            if (c < ncols) dst[(size_t)k * ldd + col0 + c] += acc[i][j];
          }
        }
      }
    }
  }
}

// The same for one column col: one thread per k.
__device__ __forceinline__ void accum_dw_col(const float* __restrict__ A, int lda,
                                             const float* __restrict__ CT, int ldc, int rows,
                                             int kin, int col, float* __restrict__ dst, int ldd) {
  for (int k = threadIdx.x; k < kin; k += THREADS) {
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s = fmaf(A[r * lda + k], CT[r * ldc + col], s);
    dst[(size_t)k * ldd + col] += s;
  }
}

// Bias gradient: dst[c] += sum_{r < rows} CT[r * ldc + c] for c < ncols.
__device__ __forceinline__ void accum_db(const float* __restrict__ CT, int ldc, int rows,
                                         int ncols, float* __restrict__ dst) {
  for (int c = threadIdx.x; c < ncols; c += THREADS) {
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += CT[r * ldc + c];
    dst[c] += s;
  }
}

// Zero this block's partial (n floats at part); the caller syncs after.
__device__ __forceinline__ void zero_partial(float* part, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) part[i] = 0.0f;
}

// out[i] = sum_b work[b * n + i], over the grid blocks b in order.
__global__ void reduce_partials(const float* __restrict__ work, int grid, int n,
                                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b = 0; b < grid; ++b) s += work[(size_t)b * n + i];
  out[i] = s;
}

}  // namespace mk

#define MK_ERROR_STRING_EXPORT                                    \
  extern "C" const char* error_string(int e) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(e));       \
  }
