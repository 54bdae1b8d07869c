// K5: the hash-grid encode backward, the table gradient.
//
// Replaces monosdf_tpu/ops/pallas_fold.py fold_hash_levels (pl.pallas_call
// at :196; oracle fold_hash_levels_xla, caller hashgrid.py
// _fold_transpose_mixed): the TPU scatters one 8-corner cotangent row per
// (point, level) at its base cell and folds the corners back with static
// rolls. On the card each corner's cotangent goes to its table row with an
// atomic add, as the reference's CUDA encoder does.
//
// Per in-box (point, level) and corner c, with the corner rows and weights
// of hashgrid.cuh and the cotangents c_feat[p, 2l + ch] and c_tg[k, p, 2l +
// ch] (null: zero) of the features and their tangents:
//   d_table[row_c, ch] += c_feat W_c + sum_k c_tg_k dW_c/dx_k,
// the transpose of the encode and of its linearisation in x (the eikonal
// loss's second-order path). With BF16 (a table read at bf16) each corner's
// term is rounded to bf16 before anything adds it, as the JAX package's
// quad/fold path does; the sums are float32. The wrapper zeroes d_table.
// Points outside [0,1]^3 add nothing.
//
// Bound on the card: bytes (the cotangents read once, the touched sectors
// of the float32 table gradient written once). What costs the time is the
// atomics, which resolve in the L2 at about the same rate whether 8 or 16
// bytes wide (PERF.md: the time follows their number), so the design cuts
// their number:
// - a CTA takes 32 consecutive points and each warp one level of them
//   (lane = point), so at the coarse levels a warp's lanes share cells:
//   neighbouring samples of one ray. The cotangents are read straight from
//   memory by each lane, a point's row of 2L floats reused by the CTA's
//   warps through L1; a CTA whose points all lie outside the box returns
//   after reading x (most of a grid step's samples lie outside it);
// - lanes whose points fall in one cell of the level (the same base cell,
//   hence the same 8 rows) and are neighbours in the warp form a run; the
//   runs' rounded terms are summed by a segmented shuffle reduction (as
//   many steps as the longest run needs) and the run's first lane issues
//   its atomics. Terms are rounded before any sum, and are summed in
//   another order than before, which the atomics never fixed anyway;
// - corners c and c|1 whose rows share a 16-byte-aligned pair (row_c even,
//   row_c|1 = row_c + 1) take one float4 atomic, else one float2 each.
// At the points of a grid training step these measured slower on the card:
// the cotangents staged through shared memory by 8-warp CTAs; the first two
// levels summed in shared memory over persistent CTAs, then flushed; one
// warp per 32 points over all levels; CTAs ordered level group by level
// group (faster at uniform random points, whose touched gradient rows then
// fit the L2, but not at the step's); and more CTAs per SM (fewer
// registers).
// The levels' constants sit in shared memory (hashgrid.cuh Level, shared
// with K6) and a level's modulo is a mask or a multiply-high, as in K6.
#include "common.cuh"
#include "hashgrid.cuh"

using namespace hg;

namespace {

constexpr int K5_MAX_WARPS = 16;  // a CTA: one warp a level, at most 16
constexpr int TP = 32;            // points a CTA: one a lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void red2(float* p, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
#endif
}

// rows r and r + 1 (r even: 16-byte aligned) in one atomic
__device__ __forceinline__ void red4(float* p, float a, float b, float c, float d) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
#else
  red2(p, a, b);
  red2(p + 2, c, d);
#endif
}

// The base cell of x01 at level lv, as corners() computes it: two points in
// one cell have the same 8 corner rows.
__device__ __forceinline__ void base_cell(const Level& lv, const float x01[3], unsigned g[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = x01[d] * lv.fscale;
    g[d] = static_cast<unsigned>(fminf(fmaxf(floorf(pos), 0.0f), lv.res));
  }
}

// One warp, one level l of the CTA's points (lane = point; cf_row and
// ct_row its rows of c_feat and of c_tg's first plane, plane floats apart):
// the corner terms, their sums over runs of lanes in one cell, the runs'
// atomics.
template <bool BF16>
__device__ __forceinline__ void level_unit(const Level& lv, int l, int lane, bool live,
                                           const float x01[3], const float* __restrict__ cf_row,
                                           const float* __restrict__ ct_row, size_t plane,
                                           float* __restrict__ d_table) {
  unsigned row[8];
  float u[8][2];
  unsigned key[3] = {FULL, FULL, FULL};  // no cell: a dead lane
  if (live) {
    float W[8], dW[3][8];
    corners(lv, x01, row, W, dW);
    base_cell(lv, x01, key);
    const float2 cf = *reinterpret_cast<const float2*>(cf_row + 2 * l);
    float2 ct[3] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
    if (ct_row != nullptr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) ct[k] = *reinterpret_cast<const float2*>(ct_row + k * plane + 2 * l);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float u0 = cf.x * W[c], u1 = cf.y * W[c];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        u0 = fmaf(ct[k].x, dW[k][c], u0);
        u1 = fmaf(ct[k].y, dW[k][c], u1);
      }
      u[c][0] = mk::rnd<BF16>(u0);
      u[c][1] = mk::rnd<BF16>(u1);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) row[c] = 0u, u[c][0] = u[c][1] = 0.0f;
  }

  // runs of neighbouring lanes in one cell; run: the lanes from this one to
  // its run's end
  const unsigned k0 = __shfl_up_sync(FULL, key[0], 1), k1 = __shfl_up_sync(FULL, key[1], 1),
                 k2 = __shfl_up_sync(FULL, key[2], 1);
  const bool head = lane == 0 || key[0] != k0 || key[1] != k1 || key[2] != k2;
  const unsigned heads = __ballot_sync(FULL, head);
  const unsigned after = lane == 31 ? 0u : heads >> (lane + 1);
  const int run = after != 0u ? __ffs(after) : 32 - lane;
  const int longest = __reduce_max_sync(FULL, static_cast<unsigned>(run));
  // a segmented suffix sum: after the step of offset off, a lane holds the
  // sum of its run's terms from it to 2 off - 1 lanes on, so the head ends
  // with the run's sum
  for (int off = 1; off < longest; off <<= 1) {
    const bool take = off < run;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const float v = __shfl_down_sync(FULL, u[c][ch], off);
        if (take) u[c][ch] += v;
      }
    }
  }
  if (!(head && live)) return;
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    if ((row[c] & 1u) == 0u && row[c + 1] == row[c] + 1u) {
      red4(d_table + 2 * static_cast<size_t>(row[c]), u[c][0], u[c][1], u[c + 1][0], u[c + 1][1]);
    } else {
      red2(d_table + 2 * static_cast<size_t>(row[c]), u[c][0], u[c][1]);
      red2(d_table + 2 * static_cast<size_t>(row[c + 1]), u[c + 1][0], u[c + 1][1]);
    }
  }
}

}  // namespace

// Points [32 blockIdx.x, + 32), level l by warp l mod (blockDim.x / 32).
template <bool BF16>
__global__ void __launch_bounds__(32 * K5_MAX_WARPS)
hash_encode_bwd_kernel(const float* __restrict__ x, int N, const __grid_constant__ HashLevels h,
                       float size, const float* __restrict__ c_feat,
                       const float* __restrict__ c_tg, float* __restrict__ d_table) {
  __shared__ Level sl[HG_MAX_LEVELS];
  __shared__ float sx[TP][3];
  __shared__ bool sin_box[TP];
  const int L = h.n_levels, warps = blockDim.x >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * TP, np = min(TP, N - p0);
  stage_levels(h, sl);
  if (tid < np) {
    const size_t p = static_cast<size_t>(p0 + tid);
    const float xp[3] = {x[p * 3], x[p * 3 + 1], x[p * 3 + 2]};
    sin_box[tid] = unit_coords(xp, size, sx[tid]);
  }
  __syncthreads();
  const bool live = lane < np && sin_box[lane];
  if (__ballot_sync(FULL, live) == 0u) return;  // every warp has the same points
  const size_t at = static_cast<size_t>(p0 + lane) * 2 * L;  // the lane's point's rows
  const float* cf_row = c_feat + at;
  const float* ct_row = c_tg != nullptr ? c_tg + at : nullptr;
  for (int l = warp; l < L; l += warps)
    level_unit<BF16>(sl[l], l, lane, live, sx[lane], cf_row, ct_row,
                     static_cast<size_t>(N) * 2 * L, d_table);
}

extern "C" int hash_encode_bwd_launch(const float* x, int N, const int* desc, const float* fdesc,
                                      float size, const float* c_feat, const float* c_tg,
                                      float* d_table, int bf16, void* stream) {
  const HashLevels h = levels_from(desc, fdesc);
  const int L = h.n_levels;
  const dim3 grid(static_cast<unsigned>((N + TP - 1) / TP));
  const int threads = 32 * (L < K5_MAX_WARPS ? L : K5_MAX_WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? hash_encode_bwd_kernel<true> : hash_encode_bwd_kernel<false>;
  kernel<<<grid, threads, 0, s>>>(x, N, h, size, c_feat, c_tg, d_table);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
