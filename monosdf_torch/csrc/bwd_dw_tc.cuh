// Pass 2 of the tensor-core backward kernels: dW_l = A_l^T CT_l as a
// tall-K GEMM over the rows that pass 1 stored in wgmma's operand layout,
// 64 rows a block. Included by sdf_grad_bwd_tc.cuh (K2b, K7b) and
// radiance_bwd_tc.cuh (K3b); the including file defines BWD_TC_NAME(part),
// the kernels' names, and includes common.cuh first.
#pragma once

#include "wgmma.cuh"

namespace {

constexpr int DW_THREADS = 288;             // two consumer warpgroups and one producer warp
constexpr int DW_CONSUMER_WARPS = 8;
constexpr int P2_STAGES = 4;
constexpr int P2_A = 64 * 128;              // elements of a pass-2 A slice (64 rows x 128 inputs)
constexpr int BLK = 64 * 256;               // elements of a tile's 256-wide block

struct Pass2Smem {
  __nv_bfloat16 a[P2_STAGES][P2_A];
  __nv_bfloat16 ct[P2_STAGES][BLK];
  wg::Ring<P2_STAGES> ring;
};

}  // namespace

// per-layer scratch that pass 1 writes and pass 2 reads: CT_l (K2b, K7b:
// at l = L - 1 the feature columns' cotangent) and A_l (the layer input),
// each n_tiles blocks of 64 rows in wgmma's layout (core_offset(r, c, 64));
// A_l's blocks are kap[l] = round_up(kin_l, 128) wide, CT_l's 256
struct Scratch {
  __nv_bfloat16* ct[MK_MAX_LAYERS];
  __nv_bfloat16* a[MK_MAX_LAYERS];
  int kap[MK_MAX_LAYERS];
  int wb_off[MK_MAX_LAYERS];  // K2b's pass-1 packed W_l[:nprev]^T, TB_KC rows a chunk
};

// Pass 2: dW_l = A_l^T CT_l over every tile, on the tensor cores. A CTA
// takes one job: layer l, 128 of its inputs (m-block mb), every output
// column (256), and split s of the tiles; two warpgroups of 64 inputs each,
// wgmma.m64n256k16 reading both operands transposed (MN-major) from a ring
// of bulk copies. Its 128 x 256 float32 sums go to part2[job].
__global__ void __launch_bounds__(DW_THREADS, 1)
BWD_TC_NAME(kernel_dw)(int n_tiles, int L, const __grid_constant__ Scratch sc, int splits,
                       float* __restrict__ part2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Pass2Smem& sm = *reinterpret_cast<Pass2Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int job = blockIdx.x, s = job % splits;
  int mbi = job / splits, l = 0;
  while (mbi >= sc.kap[l] / 128) mbi -= sc.kap[l++] / 128;
  const int mb = mbi;
  const int per = (n_tiles + splits - 1) / splits;
  const int t0 = s * per, t1 = min(n_tiles, t0 + per);
  if (tid == 0) sm.ring.init(DW_CONSUMER_WARPS);
  __syncthreads();

  if (warp == DW_CONSUMER_WARPS) {
    if (lane != 0) return;
    uint32_t k = 0;
    for (int tile = t0; tile < t1; ++tile, ++k)
      sm.ring.produce2(k, sm.a[k % P2_STAGES], sc.a[l] + (size_t)tile * 64 * sc.kap[l] + mb * P2_A,
                       P2_A * sizeof(__nv_bfloat16), sm.ct[k % P2_STAGES],
                       sc.ct[l] + (size_t)tile * BLK, BLK * sizeof(__nv_bfloat16));
    return;
  }

  const int g = warp >> 2, t = tid & 127;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  wg::fence();
  uint32_t k = 0;
  for (int tile = t0; tile < t1; ++tile, ++k) {
    sm.ring.acquire(k);
    const __nv_bfloat16* a = sm.a[k % P2_STAGES] + 64 * 64 * g;
    const __nv_bfloat16* ct = sm.ct[k % P2_STAGES];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t da = wg::desc(a + 128 * j, 128, 1024);
      const uint64_t db = wg::desc(ct + 128 * j, 128, 1024);
      wg::wgmma_m64n256k16<1, 1>(acc, da, db, 1);
    }
    wg::commit();
    if (tile > t0) {  // the previous stage's products are done: release it
      wg::wait<1>();
      if (lane == 0) sm.ring.release(k - 1);
    }
  }
  wg::wait<0>();
  if (lane == 0 && t1 > t0) sm.ring.release(k - 1);
  float* out = part2 + (size_t)job * 128 * 256;
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    const int r = 64 * g + wg::frag_row(t, i), c = wg::frag_col(t, i);
    *reinterpret_cast<float2*>(&out[r * 256 + c]) = make_float2(acc[i], acc[i + 1]);
  }
}
