// The tensor-core backward of the radiance ReLU trunk: the bf16 paths of
// K3b (radiance_norm_bwd.cu) and K8a (radiance_split_bwd.cu). The including
// file defines BWD_TC_NAME(part), the kernels' names, and includes
// radiance.cuh first. The trunk's passes do not depend on the segments of
// the layer-0 input (RadIn, RadOut), which each kernel gives:
// - K3b: [sv bf16 | n normalised in-kernel from g | feat | code f32], a
//   bf16 top cotangent co and the normals' cotangent cn, dg from the
//   normalise backward;
// - K8a: [sv f32 | n the raw gradient, f32 | feat | code f32], a float32
//   co, no cn and no normalise step (norm_seg < 0): the normals' columns of
//   CT_0 W0^T are dn itself, stored float32 as the other segments are.
//
// K2b's two passes (sdf_grad_bwd_tc.cuh) on a plain ReLU trunk, one row
// per sample:
//   pass 1 (kernel_ct): a persistent CTA per SM walks 64-row tiles with two
//     consumer warpgroups (each 128 of a product's 256 output columns,
//     wgmma.m64n128k16 over the whole tile) and a producer warp that
//     streams the bf16 B operands, packed once per call
//     (kernels/radiance_norm.py pack_bwd: W_l, then W_l^T for l >= 1, then
//     W0^T's rows that have a cotangent output, in blocks of <= 256), 64
//     rows a stage through a ring of bulk copies. Per tile:
//     - the input row h0 and the forward recompute, Y_l = relu(rnd(rnd(A
//       W_l) + rnd(b_l))), are K3f's forward (radiance_tc.cuh rb_build_h0,
//       rb_forward; its comment gives the design), with h0 and Y_l stored
//       for pass 2 after each layer;
//     - the top layer on the CUDA cores, one thread per column of Y_{H-1}:
//       dW_H = Y_{H-1}^T rnd(co) and db_H from the unrounded co (K8a's
//       float32 co is kept both ways; K3b's is bf16, so the two coincide),
//       CT_{H-1} = (rnd(co) W_H^T)[Y_{H-1} > 0] with db_{H-1} from its
//       float32 values, all in the SIMT kernel's (rad_backward's) order;
//       CT is rounded in place;
//     - CT_{l-1} = (CT_l W_l^T)[Y_{l-1} > 0] on the tensor cores, db_{l-1}
//       from the float32 values (a fixed-order column sum: shuffles over a
//       warp's rows, then the four warps in order), rounded in place;
//     - the input cotangents CT_0 W0^T for the columns that have an output,
//       block by block (the features' 256 columns, then the normals' 3 and
//       the code's C): df, dc (and K8a's dn) from the registers; K3b's
//       normals' columns into shared memory for the normalise backward,
//       which stays as rad_backward has it;
//     - h0, Y_l (l < H - 1) and CT_l (l < H) go to device memory in wgmma's
//       layout, 64 rows a block, for pass 2: ~2.3 KB a row, written once
//       and read once (~230 MB at the step's 100,352 rows);
//     - the biases' gradients and dW_H add into the CTA's partial in shared
//       memory, written once per CTA.
//   pass 2 (kernel_dw, bwd_dw_tc.cuh, K2b's): dW_l = A_l^T CT_l for l < H,
//     A_0 = h0 and A_l = Y_{l-1}, as tall-K GEMMs over the tiles.
//   kernel_sums: the splits' and CTAs' partials summed in a fixed order. Two
//     runs give the same bits.
// CT is rounded to bf16 before both products, as in the SIMT kernel, so the
// tensor cores compute its function; the float32 sums change only in order.
//
// Shared memory (225 KB of 227): the ring (3 x 32 KB), h0 (64 x 336 bf16,
// 42 KB), two hidden layers (64 x 256 bf16 each, 64 KB; each turns into its
// cotangent in place), the biases (2 KB), the CTA's partial (6 KB), the
// column-sum exchange (4 KB) and the rows' normals, co (rounded and not),
// cn and dn (6 KB).
// No float32 tile is kept: the epilogues run on the sums in registers.
#pragma once

#include "bwd_dw_tc.cuh"
#include "radiance_tc.cuh"

namespace {

constexpr int RB_MAX_HIDDEN = 2;
// the CTA's partial: every bias (<= 2 x 256 + 4) and dW_H (<= 256 x 4)
constexpr int RB_SMALL = 2 * 256 + 4 + 256 * 4;
constexpr int RB_MAX_MATS = 8;

struct RadBwdSmem {
  __nv_bfloat16 w[RB_STAGES][RB_CHUNK];        // the ring of B operands
  __nv_bfloat16 h[TILE_M * LDH];               // h0, the A operand (R = 64)
  __nv_bfloat16 y[RB_MAX_HIDDEN][TILE_M * 256];  // Y_l, then CT_l in place
  float bias[RB_MAX_HIDDEN][256];              // the hidden biases, bf16-rounded
  float part[RB_SMALL];
  float red[RB_CONSUMER_WARPS][128];           // per warp: its rows' column sums
  float nr[TILE_M * NRM];                      // rad_normals' per-row scratch
  float co[TILE_M * 4];                        // the top cotangent, rounded to bf16
  float cou[TILE_M * 4];                       // the top cotangent as given
  float cn[TILE_M * 4];                        // the normals' cotangent
  float dn[TILE_M * 4];                        // the normals' columns of CT_0 W0^T
  wg::Ring<RB_STAGES> ring;
};
static_assert(sizeof(RadBwdSmem) <= 232448, "a CTA's shared memory is 227 KB");
static_assert(TILE_M * 4 == RB_CONSUMERS, "one co and cn entry a consumer thread");

}  // namespace

// The packed B operands in ring order: the forward's W_l (l < H), the
// backward's W_l^T (l = H - 1 .. 1), then the input-cotangent blocks of
// W0^T; each at element offset off[m] of Wb, its depth k[m] (the
// product's K), chunks of RB_KC rows following in order.
struct RadMats {
  int n;
  int nblk;
  int off[RB_MAX_MATS];
  int k[RB_MAX_MATS];
};

namespace {

// the CTA partial's offsets: db_l (l <= H) first, then dW_H (kin_H x n_out)
__device__ __forceinline__ int rb_db(const MlpDesc& d, int l) {
  int o = 0;
  for (int i = 0; i < l; ++i) o += d.nout[i];
  return o;
}

// n bf16 elements from shared memory to device memory, 16 bytes a thread a
// step; zero past src_n (a block wider than the tile's columns)
__device__ __forceinline__ void copy_out(__nv_bfloat16* __restrict__ dst, const __nv_bfloat16* src,
                                         int src_n, int n) {
  for (int i = threadIdx.x; i < n / 8; i += RB_CONSUMERS) {
    const uint4 v = 8 * i < src_n ? reinterpret_cast<const uint4*>(src)[i] : make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(dst)[i] = v;
  }
}

}  // namespace

// Pass 1. route (nblk x 256): column j of input block b goes to segment
// route >> 16, column route & 0xffff (-1: no output).
__global__ void __launch_bounds__(RB_THREADS, 1)
BWD_TC_NAME(kernel_ct)(const __grid_constant__ RadIn in, const __grid_constant__ RadOut o, int N,
                       const __grid_constant__ MlpDesc d, const float* __restrict__ P,
                       const __nv_bfloat16* __restrict__ Wb, const __grid_constant__ RadMats mats,
                       const int* __restrict__ route, const void* __restrict__ co, int co_f32,
                       const __nv_bfloat16* __restrict__ cn, float* __restrict__ dg_out,
                       const __grid_constant__ Scratch sc, float* __restrict__ part1,
                       int n_small) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RadBwdSmem& sm = *reinterpret_cast<RadBwdSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = d.n_layers, H = L - 1;
  const int n_out = d.nout[H], ktop = d.kin[H];
  const int n_tiles = (N + TILE_M - 1) / TILE_M;
  if (tid == 0) sm.ring.init(RB_CONSUMER_WARPS);
  for (int i = tid; i < n_small; i += RB_THREADS) sm.part[i] = 0.0f;
  for (int i = tid; i < RB_MAX_HIDDEN * 256; i += RB_THREADS) {
    const int l = i / 256, c = i % 256;
    sm.bias[l][c] = l < H && c < d.nout[l] ? rnd<true>(P[d.boff[l] + c]) : 0.0f;
  }
  __syncthreads();

  if (warp == RB_CONSUMER_WARPS) {
    if (lane != 0) return;
    uint32_t k = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      for (int m = 0; m < mats.n; ++m) {
        const int nch = (round_up(mats.k[m], 16) + RB_KC - 1) / RB_KC;
        for (int j = 0; j < nch; ++j, ++k)
          sm.ring.produce(k, sm.w[k % RB_STAGES], Wb + mats.off[m] + (size_t)j * RB_CHUNK,
                          RB_CHUNK * sizeof(__nv_bfloat16));
      }
    return;
  }

  const int g = warp >> 2, t = tid & 127;
  // the top layer's weights of this thread's column, rounded
  float wt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (tid < ktop && j < n_out) wt[j] = rnd<true>(P[d.woff[H] + tid * n_out + j]);
  int m = 0;  // the next B operand of the ring

  // acc <- A times B operand m of the ring (rb_products)
  RbStream st{sm.w, &sm.ring, 0};
  auto products = [&](const __nv_bfloat16* A, float (&acc)[64], bool live) {
    rb_products(st, A, mats.k[m++], acc, live, g, lane);
  };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    m = 0;
    wg::bar(1, RB_CONSUMERS);  // the previous tile is done with shared memory
    rad_normals(in, N, row0, sm.nr);
    {  // the rows' cotangents: co (n_out; float32 or bf16) and cn (3, when
       // given), one entry a thread
      const int r = tid >> 2, j = tid & 3;
      const bool ok = row0 + r < N;
      float v = 0.0f;
      if (ok && j < n_out) {
        const size_t i = (size_t)(row0 + r) * n_out + j;
        v = co_f32 ? static_cast<const float*>(co)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(co)[i]);
      }
      sm.cou[tid] = v;
      sm.co[tid] = rnd<true>(v);
      sm.cn[tid] = cn != nullptr && ok && j < 3 ? __bfloat162float(cn[(size_t)(row0 + r) * 3 + j])
                                                : 0.0f;
    }
    wg::bar(1, RB_CONSUMERS);

    rb_build_h0(sm.h, in, sm.nr, N, row0);
    wg::fence_async_smem();
    wg::bar(1, RB_CONSUMERS);
    copy_out(sc.a[0] + (size_t)tile * TILE_M * sc.kap[0], sm.h, TILE_M * round_up(in.d0, 16),
             TILE_M * sc.kap[0]);

    // ---- forward: Y_l = relu(rnd(rnd(A W_l) + rnd(b_l))) (rb_forward) --------
    rb_forward(st, sm.h, d, &sm.bias[0][0], sm.y, g, lane, t, [&](int l, const __nv_bfloat16* Y) {
      if (l + 1 < H) {  // A_{l+1}: Y_l's first kap columns
        const int n = TILE_M * sc.kap[l + 1];
        copy_out(sc.a[l + 1] + (size_t)tile * n, Y, n, n);
      }
    });
    m = H;

    // ---- the top layer on the CUDA cores, in rad_backward's order --------
    __nv_bfloat16* top = sm.y[H - 1];
    if (tid < ktop) {
      float dw[4] = {0.0f, 0.0f, 0.0f, 0.0f}, db = 0.0f;
      for (int r = 0; r < TILE_M; ++r) {
        __nv_bfloat16* p = &top[wg::core_offset(r, tid, TILE_M)];
        const float yv = __bfloat162float(*p);
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < n_out) {
            const float z = sm.co[r * 4 + j];
            dw[j] = fmaf(yv, z, dw[j]);
            s = fmaf(z, wt[j], s);
          }
        }
        const float ct = yv > 0.0f ? s : 0.0f;
        db += ct;
        *p = __float2bfloat16_rn(ct);
      }
      const int dwo = rb_db(d, L) + tid * n_out;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n_out) sm.part[dwo + j] += dw[j];
      sm.part[rb_db(d, H - 1) + tid] += db;
    }
    if (tid < n_out) {
      float s = 0.0f;
      for (int r = 0; r < TILE_M; ++r) s += sm.cou[r * 4 + tid];
      sm.part[rb_db(d, H) + tid] += s;
    }
    wg::fence_async_smem();
    wg::bar(1, RB_CONSUMERS);  // CT_{H-1} is complete
    copy_out(sc.ct[H - 1] + (size_t)tile * BLK, top, BLK, BLK);

    // ---- hidden layers, top down: CT_{l-1} in place over Y_{l-1} --------
    for (int l = H - 1; l >= 1; --l) {
      float acc[64];
      products(sm.y[l], acc, true);
      __nv_bfloat16* Y = sm.y[l - 1];
      float cs[32];  // this thread's 32 columns, summed over its two rows
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = wg::frag_row(t, i), c = 128 * g + wg::frag_col(t, i);
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&Y[wg::core_offset(r, c, TILE_M)]);
        const float2 yv = __bfloat1622float2(*p);
        const float v0 = yv.x > 0.0f ? acc[i] : 0.0f, v1 = yv.y > 0.0f ? acc[i + 1] : 0.0f;
        *p = __floats2bfloat162_rn(v0, v1);
        // acc[i] and acc[i + 2] share a column (rows 8 apart)
        const int q = (i >> 2) * 2;
        if ((i & 2) == 0) {
          cs[q] = v0;
          cs[q + 1] = v1;
        } else {
          cs[q] += v0;
          cs[q + 1] += v1;
        }
      }
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        float v = cs[q];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        cs[q] = v;
      }
      if (lane < 4) {
#pragma unroll
        for (int q = 0; q < 32; ++q) sm.red[warp][8 * (q >> 1) + 2 * lane + (q & 1)] = cs[q];
      }
      wg::fence_async_smem();
      wg::bar(1, RB_CONSUMERS);  // CT_{l-1} and the warps' column sums are complete
      if (tid < d.nout[l - 1]) {
        const int gg = tid >> 7, cc = tid & 127;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < 4; ++w) s += sm.red[4 * gg + w][cc];
        sm.part[rb_db(d, l - 1) + tid] += s;
      }
      copy_out(sc.ct[l - 1] + (size_t)tile * BLK, Y, BLK, BLK);
    }

    // ---- the input cotangents: CT_0 W0^T, block by block ----------------
    for (int b = 0; b < mats.nblk; ++b) {
      // a block's columns with an output come first: the warpgroup's half
      // is live when its first column has one
      float acc[64];
      const int* rt = route + b * 256 + 128 * g;
      const bool live = __ldg(rt) >= 0;
      products(sm.y[0], acc, live);
      if (!live) continue;
#pragma unroll 4
      for (int i = 0; i < 64; i += 2) {
        const int r = wg::frag_row(t, i), j = wg::frag_col(t, i);
        const int gr = row0 + r;
        const int v0 = __ldg(rt + j), v1 = __ldg(rt + j + 1);
        const int s0 = v0 >> 16, c0 = v0 & 0xffff;
        if (v0 >= 0 && v1 == v0 + 1 && s0 != in.norm_seg && ((in.seg[s0].width | c0) & 1) == 0) {
          // both columns to neighbouring, aligned entries of one output: one store
          if (gr < N) {
            const size_t at = (size_t)gr * in.seg[s0].width + c0;
            if (o.f32[s0]) {
              *reinterpret_cast<float2*>(static_cast<float*>(o.p[s0]) + at) =
                  make_float2(acc[i], acc[i + 1]);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(o.p[s0]) + at) =
                  __floats2bfloat162_rn(acc[i], acc[i + 1]);
            }
          }
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = e ? v1 : v0;
          if (v < 0) continue;
          const int s = v >> 16, cc = v & 0xffff;
          if (s == in.norm_seg) {
            sm.dn[r * 4 + cc] = acc[i + e];
          } else if (gr < N) {
            const size_t at = (size_t)gr * in.seg[s].width + cc;
            if (o.f32[s]) {
              static_cast<float*>(o.p[s])[at] = acc[i + e];
            } else {
              static_cast<__nv_bfloat16*>(o.p[s])[at] = __float2bfloat16_rn(acc[i + e]);
            }
          }
        }
      }
    }
    if (in.norm_seg < 0) continue;
    wg::bar(1, RB_CONSUMERS);  // dn is written

    // ---- the normalise backward (rad_backward's) ------------------------
    if (tid < TILE_M && row0 + tid < N) {
      const size_t gr = (size_t)(row0 + tid);
      const float* nr = sm.nr + tid * NRM;
      const float sq = nr[6], q = nr[7];
      const float r = sqrtf(fmaxf(sq, 1e-24f));
      const float live = sq > 1e-24f ? 1.0f : 0.0f;
      float dnv[3];
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) dnv[kk] = sm.cn[tid * 4 + kk] + sm.dn[tid * 4 + kk];
      const float dot_cg = dnv[0] * nr[3] + dnv[1] * nr[4] + dnv[2] * nr[5];
      const float f = dot_cg / (q * q * r);
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) dg_out[gr * 3 + kk] = dnv[kk] / q - nr[3 + kk] * f * live;
    }
  }
  wg::bar(1, RB_CONSUMERS);
  for (int i = tid; i < n_small; i += RB_CONSUMERS) part1[(size_t)blockIdx.x * n_small + i] = sm.part[i];
}

// out <- the parameter gradients (build.pack_mlp's layout): from pass 1's
// partials (summed over its CTAs in order) every bias and dW_H; from pass
// 2's (summed over the splits in order) dW_l for l < H.
__global__ void BWD_TC_NAME(kernel_sums)(MlpDesc d, const __grid_constant__ Scratch sc, int splits,
                                         const float* __restrict__ part2, int grid1, int n_small,
                                         const float* __restrict__ part1, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int L = d.n_layers, H = L - 1;
  if (i < n_small) {
    float acc = 0.0f;
    for (int b = 0; b < grid1; ++b) acc += part1[(size_t)b * n_small + i];
    const int dwo = rb_db(d, L);
    if (i >= dwo) {
      out[d.woff[H] + (i - dwo)] = acc;
    } else {
      int l = 0, c = i;
      while (c >= d.nout[l]) c -= d.nout[l++];
      out[d.boff[l] + c] = acc;
    }
  }
  int j = i, job0 = 0;
  for (int l = 0; l < H; ++l) {
    const int kin = d.kin[l], nout = d.nout[l];
    if (j < kin * nout) {
      const int kk = j / nout, c = j % nout, mb = kk / 128;
      float acc = 0.0f;
      for (int s = 0; s < splits; ++s)
        acc += part2[((size_t)(job0 + mb * splits + s) * 128 + kk % 128) * 256 + c];
      out[d.woff[l] + (size_t)kk * nout + c] = acc;
      return;
    }
    j -= kin * nout;
    job0 += sc.kap[l] / 128 * splits;
  }
}

// The three launches: pass 1 on grid1 persistent CTAs (part1: grid1 x
// n_small floats), pass 2 on one CTA per job (part2: jobs x 128 x 256
// floats, jobs = the A_l blocks' 128-column slices x splits), then the
// ordered sums into out (n_out threads: the larger of n_small and the
// pass-2 weights). Wb: the packed B operands, mat_off / mat_k their offsets
// and depths (n_mats, the last n_blk the input blocks), route (n_blk x 256)
// their columns' outputs; ct / a / kap: pass 2's scratch per layer. co:
// float32 (co_f32) or bf16; cn and dg_out: K3b's (null without a
// normalise step).
inline int rad_bwd_tc_launch(const RadIn& in, const RadOut& o, int N, const int* desc,
                             const float* P, const void* Wb, const int* mat_off, const int* mat_k,
                             int n_mats, int n_blk, const int* route, const void* co, int co_f32,
                             const void* cn, float* dg_out, void* const* ct, void* const* a,
                             const int* kap, float* part1, int grid1, int n_small, float* part2,
                             int splits, int n_out, float* out, void* stream) {
  const MlpDesc d = desc_from(desc);
  const int H = d.n_layers - 1;
  RadMats mats{};
  mats.n = n_mats;
  mats.nblk = n_blk;
  for (int m = 0; m < n_mats && m < RB_MAX_MATS; ++m) {
    mats.off[m] = mat_off[m];
    mats.k[m] = mat_k[m];
  }
  Scratch sc{};
  for (int l = 0; l < MK_MAX_LAYERS; ++l) {
    sc.ct[l] = static_cast<__nv_bfloat16*>(ct[l]);
    sc.a[l] = static_cast<__nv_bfloat16*>(a[l]);
    sc.kap[l] = kap[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int jobs = 0;
  for (int l = 0; l < H; ++l) jobs += sc.kap[l] / 128 * splits;
  const size_t smem1 = sizeof(RadBwdSmem), smem2 = sizeof(Pass2Smem);
  cudaFuncSetAttribute(BWD_TC_NAME(kernel_ct), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  BWD_TC_NAME(kernel_ct)<<<grid1, RB_THREADS, smem1, s>>>(
      in, o, N, d, P, static_cast<const __nv_bfloat16*>(Wb), mats, route, co, co_f32,
      static_cast<const __nv_bfloat16*>(cn), dg_out, sc, part1, n_small);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (jobs > 0) {
    cudaFuncSetAttribute(BWD_TC_NAME(kernel_dw), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
    BWD_TC_NAME(kernel_dw)<<<jobs, DW_THREADS, smem2, s>>>((N + TILE_M - 1) / TILE_M, H, sc, splits,
                                                           part2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  BWD_TC_NAME(kernel_sums)<<<(n_out + 255) / 256, 256, 0, s>>>(d, sc, splits, part2, grid1,
                                                               n_small, part1, out);
  return static_cast<int>(cudaGetLastError());
}
