// K6: the hash-grid encode forward, features and their spatial tangents.
//
// Replaces monosdf_tpu/ops/pallas_fold.py _build_quad_hash_impl
// (pl.pallas_call at :353), the TPU's build of a corner-duplicated quad
// table for its row gather (caller hashgrid.py _build_quad_mixed), together
// with the gather and interpolation that read it. The quad table exists for
// the TPU, whose row gather costs about the same per row whatever its width;
// on the card the eight corners are read directly, so this kernel is the
// whole encode: one thread per (point, level), level fastest, so a warp's
// feature writes are contiguous.
//
// Per (point, level): the corner rows (dense, 'add' or 'xor' rule, see
// hashgrid.cuh), 8 x 2 table values read at the table's type (bf16 or
// float32) and combined in float32 with float32 smoothstep weights:
//   feat[p, 2l + ch]     = sum_c W_c T[row_c, ch]
//   tg[k, p, 2l + ch]    = sum_c dW_c/dx_k T[row_c, ch]   (tg may be null)
// Points outside [0,1]^3 and levels at or after n_active (the sampler's
// sweeps read the first levels only) give zeros.
//
// Bound on the card: bytes. The work is a few FLOP per corner; what costs is
// the 8 corner reads per (point, level), scattered over the table. The bf16
// table of the bench schedule (6.1 M rows x 2 channels, 24 MB) fits the
// 50 MB L2, so after the first touches the corner reads are L2 hits; the
// outputs (float32 features and tangents) are written once, coalesced.
#include "common.cuh"
#include "hashgrid.cuh"

using namespace hg;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
hash_encode_kernel(const void* __restrict__ table, const float* __restrict__ x, int N,
                   int n_active, const __grid_constant__ HashLevels h, float size,
                   float* __restrict__ feat, float* __restrict__ tg) {
  const int L = h.n_levels;
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= static_cast<long long>(N) * L) return;
  const int p = static_cast<int>(t / L), l = static_cast<int>(t - static_cast<long long>(p) * L);
  float2 f = make_float2(0.0f, 0.0f);
  float2 g[3] = {f, f, f};
  unsigned row[8];
  float W[8], dW[3][8];
  const float xp[3] = {x[(size_t)p * 3], x[(size_t)p * 3 + 1], x[(size_t)p * 3 + 2]};
  if (l < n_active && corners(h, l, xp, size, row, W, dW)) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float2 v;
      if constexpr (BF16) {
        v = __bfloat1622float2(__ldg(static_cast<const __nv_bfloat162*>(table) + row[c]));
      } else {
        v = __ldg(static_cast<const float2*>(table) + row[c]);
      }
      f.x = fmaf(W[c], v.x, f.x);
      f.y = fmaf(W[c], v.y, f.y);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g[k].x = fmaf(dW[k][c], v.x, g[k].x);
        g[k].y = fmaf(dW[k][c], v.y, g[k].y);
      }
    }
  }
  reinterpret_cast<float2*>(feat)[t] = f;
  if (tg != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      reinterpret_cast<float2*>(tg)[static_cast<size_t>(k) * N * L + t] = g[k];
  }
}

extern "C" int hash_encode_launch(const void* table, const float* x, int N, int n_active,
                                  const int* desc, const float* fdesc, float size, float* feat,
                                  float* tg, int bf16, void* stream) {
  const HashLevels h = levels_from(desc, fdesc);
  const long long n = static_cast<long long>(N) * h.n_levels;
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    hash_encode_kernel<true><<<grid, THREADS, 0, s>>>(table, x, N, n_active, h, size, feat, tg);
  } else {
    hash_encode_kernel<false><<<grid, THREADS, 0, s>>>(table, x, N, n_active, h, size, feat, tg);
  }
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
