// K5: the hash-grid encode backward, the table gradient.
//
// Replaces monosdf_tpu/ops/pallas_fold.py fold_hash_levels (pl.pallas_call
// at :196; oracle fold_hash_levels_xla, caller hashgrid.py
// _fold_transpose_mixed): the TPU scatters one 8-corner cotangent row per
// (point, level) at its base cell and folds the corners back with static
// rolls. On the card each corner's cotangent goes straight to its table
// row with an atomic add, as the reference's CUDA encoder does.
//
// Per (point, level), one thread (level fastest): the corner rows and
// weights of hashgrid.cuh and the cotangents c_feat[p, 2l + ch] and
// c_tg[k, p, 2l + ch] (null: zero) of the features and their tangents, then
// for each corner c
//   d_table[row_c, ch] += c_feat W_c + sum_k c_tg_k dW_c/dx_k,
// the transpose of the encode and of its linearisation in x (the eikonal
// loss's second-order path). With BF16 (a table read at bf16) each corner's
// term is rounded to bf16 first, as the JAX package's quad/fold path does;
// the sums are float32. The wrapper zeroes d_table. Points outside [0,1]^3
// add nothing.
//
// Sums run in the order the atomics land, which changes from run to run:
// float32 rounding of a sum of up to a few hundred terms per row.
//
// The levels' constants sit in shared memory (hashgrid.cuh Level: a warp's
// lanes work on different levels) and a level's modulo is a mask or a
// multiply-high, as in K6.
//
// Bound on the card: bytes (the cotangents read once, the float32 table
// gradient written once; the atomics resolve in the 50 MB L2, which holds
// the bench schedule's 49 MB gradient only in part). On sm_90 one float2
// atomicAdd takes both channels of a row.
#include "common.cuh"
#include "hashgrid.cuh"

using namespace hg;

__device__ __forceinline__ void add2(float* p, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
#endif
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
hash_encode_bwd_kernel(const float* __restrict__ x, int N, const __grid_constant__ HashLevels h,
                       float size, const float* __restrict__ c_feat,
                       const float* __restrict__ c_tg, float* __restrict__ d_table) {
  __shared__ Level sl[HG_MAX_LEVELS];
  stage_levels(h, sl);
  __syncthreads();
  const int L = h.n_levels;
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= static_cast<long long>(N) * L) return;
  const int p = static_cast<int>(t / L), l = static_cast<int>(t - static_cast<long long>(p) * L);
  unsigned row[8];
  float W[8], dW[3][8];
  const float xp[3] = {x[(size_t)p * 3], x[(size_t)p * 3 + 1], x[(size_t)p * 3 + 2]};
  float x01[3];
  if (!unit_coords(xp, size, x01)) return;
  corners(sl[l], x01, row, W, dW);
  const float2 cf = reinterpret_cast<const float2*>(c_feat)[t];
  float2 ct[3] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
  if (c_tg != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      ct[k] = reinterpret_cast<const float2*>(c_tg)[static_cast<size_t>(k) * N * L + t];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float u0 = cf.x * W[c], u1 = cf.y * W[c];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      u0 = fmaf(ct[k].x, dW[k][c], u0);
      u1 = fmaf(ct[k].y, dW[k][c], u1);
    }
    if constexpr (BF16) {
      u0 = __bfloat162float(__float2bfloat16_rn(u0));
      u1 = __bfloat162float(__float2bfloat16_rn(u1));
    }
    add2(d_table + 2 * static_cast<size_t>(row[c]), u0, u1);
  }
}

extern "C" int hash_encode_bwd_launch(const float* x, int N, const int* desc, const float* fdesc,
                                      float size, const float* c_feat, const float* c_tg,
                                      float* d_table, int bf16, void* stream) {
  const HashLevels h = levels_from(desc, fdesc);
  const long long n = static_cast<long long>(N) * h.n_levels;
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    hash_encode_bwd_kernel<true><<<grid, THREADS, 0, s>>>(x, N, h, size, c_feat, c_tg, d_table);
  } else {
    hash_encode_bwd_kernel<false><<<grid, THREADS, 0, s>>>(x, N, h, size, c_feat, c_tg, d_table);
  }
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
