// K6: the hash-grid encode forward, features and their spatial tangents.
//
// Replaces monosdf_tpu/ops/pallas_fold.py _build_quad_hash_impl
// (pl.pallas_call at :353), the TPU's build of a corner-duplicated quad
// table for its row gather (caller hashgrid.py _build_quad_mixed), together
// with the gather and interpolation that read it. The quad table exists for
// the TPU, whose row gather costs about the same per row whatever its width;
// on the card the eight corners are read directly, so this kernel is the
// whole encode.
//
// Per (point, level): the corner rows (dense, 'add' or 'xor' rule, see
// hashgrid.cuh), 8 x 2 table values read at the table's type (bf16 or
// float32) and combined in float32 with float32 smoothstep weights, corner
// 0..7 in order, one fmaf each:
//   feat[p, 2l + ch]     = sum_c W_c T[row_c, ch]
//   tg[k, p, 2l + ch]    = sum_c dW_c/dx_k T[row_c, ch]   (tg may be null)
// Points outside [0,1]^3 and levels at or after n_active (the sampler's
// sweeps read the first 6 of 16 levels) give zeros.
//
// Bound on the card: bytes, the float32 outputs (written once, coalesced)
// and the table sectors the corners reach. The design:
// - one thread per ACTIVE (point, level) pair, level fastest, so a warp's
//   writes stay contiguous; the inactive levels' zero columns are written
//   after, with 16-byte stores where the row layout allows;
// - a point's unit coordinates (three float divisions) once per point, and
//   the levels' constants, in shared memory (a warp's lanes read different
//   levels); the level's modulo is a mask or a multiply-high (hashgrid.cuh
//   level_mod), not a 32-bit division;
// - outputs are stored with the streaming hint (st.global.cs): the 55 MB
//   of a step's features and tangents pass through the 50 MB L2, which the
//   24 MB bf16 table's corner reads hit. (Reading corners c and c|1 with one
//   16-byte load where both rows share it measured slower than a 4-byte
//   load per corner, on the card.)
#include <climits>

#include "common.cuh"
#include "hashgrid.cuh"

using namespace hg;

// the two channels of row r of the table, at its type
template <bool BF16>
__device__ __forceinline__ float2 load_row(const void* __restrict__ table, unsigned r) {
  if constexpr (BF16) {
    return __bfloat1622float2(__ldg(static_cast<const __nv_bfloat162*>(table) + r));
  } else {
    return __ldg(static_cast<const float2*>(table) + r);
  }
}

// The zero columns of levels K..L-1 of every row of feat (and of the three
// tangent planes): 16-byte stores where both ends are 16-byte aligned (K
// and L even), else 8-byte ones; unit u of a grid-stride loop over them.
__device__ __forceinline__ void zero_columns(int N, int K, int L, float* __restrict__ feat,
                                             float* __restrict__ tg, int u0, int stride) {
  const int planes = tg != nullptr ? 4 : 1;
  const bool wide = (K % 2 == 0) && (L % 2 == 0);
  const int per_row = wide ? (L - K) / 2 : L - K;  // units per row
  const int n = N * per_row * planes;
  for (int u = u0; u < n; u += stride) {
    const int pr = u / per_row, i = u - pr * per_row;
    const int plane = pr / N, p = pr - plane * N;
    float* base = (plane == 0 ? feat : tg + static_cast<size_t>(plane - 1) * N * 2 * L)
                  + static_cast<size_t>(p) * 2 * L + 2 * K;
    if (wide) {
      __stcs(reinterpret_cast<float4*>(base) + i, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    } else {
      __stcs(reinterpret_cast<float2*>(base) + i, make_float2(0.0f, 0.0f));
    }
  }
}

// Blocks below pair_blocks: pairs [q0, q0 + THREADS) of the N * K active
// (point, level) pairs; the blocks after them write the zero columns.
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
hash_encode_kernel(const void* __restrict__ table, const float* __restrict__ x, int N, int K,
                   int pair_blocks, const __grid_constant__ HashLevels h, float size,
                   float* __restrict__ feat, float* __restrict__ tg) {
  __shared__ float sx[THREADS + 1][3];
  __shared__ bool sin_box[THREADS + 1];
  __shared__ Level sl[HG_MAX_LEVELS];
  const int L = h.n_levels;
  if (static_cast<int>(blockIdx.x) >= pair_blocks) {
    zero_columns(N, K, L, feat, tg, (blockIdx.x - pair_blocks) * THREADS + threadIdx.x,
                 (gridDim.x - pair_blocks) * THREADS);
    return;
  }
  const int n_pairs = N * K;
  const int q0 = blockIdx.x * THREADS;
  const int p0 = q0 / K;
  const int p_end = (min(n_pairs, q0 + THREADS) - 1) / K + 1;  // exclusive
  stage_levels(h, sl);
  // the block's points' unit coordinates, once per point
  for (int i = threadIdx.x; i < p_end - p0; i += THREADS) {
    const int p = p0 + i;
    const float xp[3] = {x[(size_t)p * 3], x[(size_t)p * 3 + 1], x[(size_t)p * 3 + 2]};
    sin_box[i] = unit_coords(xp, size, sx[i]);
  }
  __syncthreads();
  const int q = q0 + threadIdx.x;
  if (q >= n_pairs) return;
  const int p = q / K, l = q - p * K;
  float2 f = make_float2(0.0f, 0.0f);
  float2 g[3] = {f, f, f};
  if (sin_box[p - p0]) {
    unsigned row[8];
    float W[8], dW[3][8];
    corners(sl[l], sx[p - p0], row, W, dW);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 v = load_row<BF16>(table, row[c]);
      f.x = fmaf(W[c], v.x, f.x);
      f.y = fmaf(W[c], v.y, f.y);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g[k].x = fmaf(dW[k][c], v.x, g[k].x);
        g[k].y = fmaf(dW[k][c], v.y, g[k].y);
      }
    }
  }
  const size_t o = static_cast<size_t>(p) * L + l;  // float2 index
  __stcs(reinterpret_cast<float2*>(feat) + o, f);
  if (tg != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      __stcs(reinterpret_cast<float2*>(tg) + static_cast<size_t>(k) * N * L + o, g[k]);
  }
}

extern "C" int hash_encode_launch(const void* table, const float* x, int N, int n_active,
                                  const int* desc, const float* fdesc, float size, float* feat,
                                  float* tg, int bf16, void* stream) {
  const HashLevels h = levels_from(desc, fdesc);
  const int L = h.n_levels, K = n_active < L ? n_active : L;
  // a few hundred blocks write the zero columns beside the pairs' blocks
  const long long zero_units = K < L ? static_cast<long long>(N) * (L - K) * (tg ? 4 : 1) : 0;
  // the kernel counts pairs and zero units in 32-bit ints, with room for one
  // more block or grid stride past the last
  if (static_cast<long long>(N) * K > INT_MAX - THREADS || zero_units > INT_MAX - 512LL * THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pair_blocks = (N * K + THREADS - 1) / THREADS;
  const long long zb = (zero_units + THREADS - 1) / THREADS;
  const int zero_blocks = static_cast<int>(zb < 512 ? zb : 512);
  const dim3 grid(static_cast<unsigned>(pair_blocks + zero_blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    hash_encode_kernel<true><<<grid, THREADS, 0, s>>>(table, x, N, K, pair_blocks, h, size, feat, tg);
  } else {
    hash_encode_kernel<false><<<grid, THREADS, 0, s>>>(table, x, N, K, pair_blocks, h, size, feat, tg);
  }
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
