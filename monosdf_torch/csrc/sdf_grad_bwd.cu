// K2b: the second-order backward of the SDF MLP with its spatial gradient.
//
// Replaces monosdf_tpu/ops/pallas_sdf_grad.py _bwd_pallas (pl.pallas_call at
// :713), the VJP of sdf_mlp_with_grad. Inputs: the points, the forward's
// saved pre-activations Z (z.p[l], (4, N, nout_l) at the operand type), the
// output cotangents c_sdf (N, 1), c_feat (N, F), c_grad (N, 3) at the operand
// type, and the take-MLP flag (N) or null. Output: the parameter gradients
// in the packed-weight layout (csrc/common.cuh MlpDesc). The points'
// cotangent is zero and not computed.
//
// A tile is PTS points, i.e. 64 stacked rows (primal, then the tangents
// along x, y, z), as in the forward. Per tile, from the last layer down:
//   last layer: CT = [c_sdf*flag | c_feat] on the primal rows and
//     c_grad_k*flag in the SDF column of tangent row k;
//   hidden layer l, from Z[l] (s = sigmoid(100 z), u_k the tangent rows):
//     ct_z = ct_h*s + (sum_k ct_t_k*u_k)*100 s(1-s),  ct_u_k = s*ct_t_k;
//   dW_l += A_l^T CT, db_l += sum of CT's primal rows (float32, before the
//     rounding of CT to the operand type), ct_A = CT W_l^T, whose columns of
//     the previous layer's output go on (divided by sqrt 2 after a skip).
// A_l, the layer's input, is rebuilt from Z[l-1] (h = softplus_100(z), t_k =
// s*u_k; at a skip layer with the embedding, / sqrt 2) and rounded once, as
// the TPU kernel's a_in_of; W^T comes packed (PT) at the same offsets as W.
// With BF16 every matmul operand is rounded to bf16, sums are float32.
//
// Bound on the card: operations (about 8.8e11 FLOP at the bench's 104,448
// training points, twice the forward's, 0.89 ms at 989 TFLOP/s bf16) against
// ~1.7 GB of bf16 Z read (0.5 ms at 3.35 TB/s).
//
// float32 (the check path): float32 FMAs on the CUDA cores. The TPU kernel
// summed dW over a sequential grid; here the grid is persistent (one block
// per SM, tiles strided over the blocks), each block adds its tiles' dW
// into its own float32 partial in device memory (a 256 x 256 layer's dW is
// 256 KB, more than a block's shared memory), and reduce_partials sums the
// partials in block order. That is a read-modify-write of the whole 2.1 MB
// partial (the bench's 8x256 MLP) per 16-point tile.
//
// bf16 (the training step's path): the tensor cores, in two passes, so that
// dW never goes through a partial per tile (option (b) of the redesign: on
// chip, a layer's float32 dW (256 KB) and the other layers' cannot stay in
// one SM's 227 KB across the tile loop, and DSMEM across a cluster would
// still have to hold all nine layers' 2.1 MB):
//   pass 1 (sdf_grad_bwd_kernel_ct): the tile loop above with ct_A = CT W^T
//     on wgmma.m64n128k16 (each of two warpgroups 128 of the 256 columns;
//     W_l[:nprev]^T packed once per call as bf16 B operands, streamed by a
//     producer warp through a ring of bulk copies). The gate step runs on
//     the float32 product in shared memory, as the SIMT kernel's; it stores
//     each layer's bf16 CT and its input A (rebuilt from the same Z reads,
//     as build_a_in) to device memory in wgmma's layout, 64 rows a block,
//     and adds db and the last layer's SDF column (a tangent-row column, kin
//     x 1) into the CTA's partial in shared memory, written once per CTA.
//   pass 2 (sdf_grad_bwd_kernel_dw): dW_l = A_l^T CT_l as a tall-K GEMM over
//     all 4N rows: one CTA per (layer, 128 inputs, split of the tiles), two
//     warpgroups on wgmma.m64n256k16 reading both operands transposed from a
//     ring of bulk copies, float32 sums in registers; the last layer's
//     feature columns take CT = [c_feat on the primal rows, 0].
//   reduce_partials_tc: the splits' and CTAs' partials summed in a fixed
//     order. Two runs give the same bits.
// CT is rounded to bf16 before both products in either path (rnd<BF16>
// below), so the tensor cores compute the SIMT path's function; the float32
// sums change only in order. The scratch is ~1.9 GB of CT and ~1.8 GB of A
// at the bench's shapes, written once and read once.
#include "common.cuh"
#include "wgmma.cuh"

using namespace mk;

__global__ void __launch_bounds__(THREADS)
sdf_grad_bwd_kernel(const float* __restrict__ x, int N, int multires, MlpDesc d,
                    const float* __restrict__ P, const float* __restrict__ PT,
                    const __grid_constant__ ZPtrs z,
                    const void* __restrict__ c_sdf, const void* __restrict__ c_feat,
                    const void* __restrict__ c_grad, const float* __restrict__ flag,
                    float* __restrict__ work, int n_params) {
  constexpr bool BF16 = false;  // float32 only: bf16 takes the two passes below
  extern __shared__ __align__(16) float smem[];
  float* X0 = smem;
  float* bufA = X0 + TILE_M * LD0;
  float* bufB = bufA + TILE_M * LDA;
  float* Ws = bufB + TILE_M * LDA;
  __shared__ float xs[PTS][3];
  __shared__ float fl[PTS];
  const int tid = threadIdx.x;
  const int d0 = 3 * (1 + 2 * multires);
  const int L = d.n_layers;
  const int n_tiles = (N + PTS - 1) / PTS;
  float* part = work + (size_t)blockIdx.x * n_params;
  zero_partial(part, n_params);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * PTS;
    __syncthreads();  // the previous tile is done with shared memory
    if (tid < PTS) fl[tid] = (flag != nullptr && p0 + tid < N) ? flag[p0 + tid] : 1.0f;
    load_pe_tile(x, N, p0, multires, xs, X0);
    __syncthreads();

    // ---- last layer ---------------------------------------------------
    int l = L - 1;
    int kin = d.kin[l], nout = d.nout[l];
    const int F = nout - 1;
    build_a_in<BF16>(bufA, l, d, z, X0, d0, N, p0);
    const int Kp_last = round_up(nout, KT);
    for (int idx = tid; idx < TILE_M * Kp_last; idx += THREADS) {
      const int r = idx / Kp_last, c = idx - r * Kp_last;
      const int p = r % PTS, k = r / PTS - 1;
      float v = 0.0f;
      if (p0 + p < N) {
        if (r < PTS) {
          if (c == 0) {
            v = load_act<BF16>(c_sdf, p0 + p) * fl[p];
          } else if (c < nout) {
            v = load_act<BF16>(c_feat, (size_t)(p0 + p) * F + (c - 1));
          }
        } else if (c == 0) {
          v = load_act<BF16>(c_grad, (size_t)(p0 + p) * 3 + k) * fl[p];
        }
      }
      bufB[r * LDA + c] = v;
    }
    __syncthreads();
    accum_db(bufB, LDA, PTS, nout, part + d.boff[l]);
    // SDF column over all rows; feature columns over the primal rows (the
    // tangent rows' cotangent is zero there)
    accum_dw_col(bufA, LDA, bufB, LDA, TILE_M, kin, 0, part + d.woff[l], nout);
    accum_dw(bufA, LDA, bufB, LDA, PTS, kin, 1, F, part + d.woff[l], nout);
    propagate<BF16>(bufB, nout, PT + d.woff[l], kin, d.nout[l - 1], d.skip[l] != 0, Ws, bufA);
    float* ct = bufA;
    float* other = bufB;

    // ---- hidden layers ------------------------------------------------
    for (l = L - 2; l >= 0; --l) {
      kin = d.kin[l];
      nout = d.nout[l];
      const int Kp = round_up(nout, KT);
      const void* Zl = z.p[l];
      __syncthreads();  // ct is written
      for (int c = tid; c < Kp; c += THREADS) {
        if (c >= nout) {  // zero pad for the K loop of the next propagate
          for (int r = 0; r < TILE_M; ++r) ct[r * LDA + c] = 0.0f;
          continue;
        }
        float db = 0.0f;
        for (int p = 0; p < PTS; ++p) {
          float zv = 0.0f, u[3] = {0.0f, 0.0f, 0.0f};
          if (p0 + p < N) {
            zv = load_act<BF16>(Zl, (size_t)(p0 + p) * nout + c);
#pragma unroll
            for (int k = 0; k < 3; ++k)
              u[k] = load_act<BF16>(Zl, ((size_t)(k + 1) * N + p0 + p) * nout + c);
          }
          float h, s;
          gate100(zv, h, s);
          const float s2 = 100.0f * s * (1.0f - s);
          float* ch = &ct[p * LDA + c];
          float* t0 = &ct[(PTS + p) * LDA + c];
          float* t1 = &ct[(2 * PTS + p) * LDA + c];
          float* t2 = &ct[(3 * PTS + p) * LDA + c];
          const float ct_sum = *t0 * u[0] + *t1 * u[1] + *t2 * u[2];
          const float ct_z = *ch * s + ct_sum * s2;
          db += ct_z;
          *ch = rnd<BF16>(ct_z);
          *t0 = rnd<BF16>(s * *t0);
          *t1 = rnd<BF16>(s * *t1);
          *t2 = rnd<BF16>(s * *t2);
        }
        part[d.boff[l] + c] += db;
      }
      build_a_in<BF16>(other, l, d, z, X0, d0, N, p0);
      __syncthreads();
      accum_dw(other, LDA, ct, LDA, TILE_M, kin, 0, nout, part + d.woff[l], nout);
      if (l > 0) {
        propagate<BF16>(ct, nout, PT + d.woff[l], kin, d.nout[l - 1], d.skip[l] != 0, Ws, other);
        float* t = ct;
        ct = other;
        other = t;
      }
    }
  }
}

// -- bf16: the tensor-core kernels ------------------------------------------

namespace {

constexpr int TB_CONSUMERS = 256;           // two warpgroups
constexpr int TB_THREADS = TB_CONSUMERS + 32;  // and one producer warp
constexpr int TB_CONSUMER_WARPS = 8;
constexpr int TB_KC = 32;                   // W rows (layer outputs) per ring stage of pass 1
constexpr int TB_STAGES = 4;
constexpr int TB_CHUNK = TB_KC * 256;       // bf16 elements of a pass-1 stage
constexpr int XLD = 264;                    // row stride of the float32 exchange tile
constexpr int KCT = 272;                    // CT operand width: the last layer's 257 outputs, padded
constexpr int MAX_SMALL = 2816;             // pass-1 partial: every bias, the last layer's SDF column
constexpr int BLK = 64 * 256;               // elements of a tile's 256-wide block

struct Pass1Smem {
  __nv_bfloat16 w[TB_STAGES][TB_CHUNK];     // the weight ring (B operand: W_l[:nprev]^T)
  __nv_bfloat16 ct[64 * KCT];               // CT, the A operand (R = 64)
  float ex[64 * XLD];                       // ct_A = CT W^T, float32; then the reduction scratch
  float x0[TILE_M * LD0];                   // the embedding and its tangents
  float part[MAX_SMALL];                    // this CTA's bias and SDF-column partials
  float ct0[TILE_M];                        // the last layer's SDF-column cotangent
  float xs[PTS][3];
  float fl[PTS];
  wg::Ring<TB_STAGES> ring;
};

constexpr int P2_STAGES = 4;
constexpr int P2_A = 64 * 128;              // elements of a pass-2 A slice (64 rows x 128 inputs)

struct Pass2Smem {
  __nv_bfloat16 a[P2_STAGES][P2_A];
  __nv_bfloat16 ct[P2_STAGES][BLK];
  wg::Ring<P2_STAGES> ring;
};

__device__ __forceinline__ int small_db(const MlpDesc& d, int l) {
  int o = 0;
  for (int i = 0; i < l; ++i) o += d.nout[i];
  return o;
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

__device__ __forceinline__ void store8(__nv_bfloat16* base, int r, int c, const float* v) {
  *reinterpret_cast<uint4*>(base + wg::core_offset(r, c, 64)) = pack8(v);
}

}  // namespace

// per-layer scratch: CT_l (l < L - 1; l = L - 1: the feature columns'
// cotangent) and A_l (the layer input), each n_tiles blocks of 64 rows in
// wgmma's layout (core_offset(r, c, 64)); A_l's blocks are kap[l] =
// round_up(kin_l, 128) wide, CT_l's 256
struct Scratch {
  __nv_bfloat16* ct[MK_MAX_LAYERS];
  __nv_bfloat16* a[MK_MAX_LAYERS];
  int kap[MK_MAX_LAYERS];
  int wb_off[MK_MAX_LAYERS];  // pass 1's packed W_l[:nprev]^T, TB_KC rows a chunk
};

// Pass 1: per tile of PTS points (64 rows, as the SIMT kernel's), from the
// last layer down: CT, the gate step, ct_A = CT W^T on the tensor cores
// (each warpgroup 128 of the 256 output columns, wgmma.m64n128k16); stores
// each layer's bf16 CT and layer input A for pass 2; sums the biases'
// gradient and the last layer's SDF column in this CTA's partial.
__global__ void __launch_bounds__(TB_THREADS, 1)
sdf_grad_bwd_kernel_ct(const float* __restrict__ x, int N, int multires, MlpDesc d,
                       const __nv_bfloat16* __restrict__ Wb, const __grid_constant__ ZPtrs z,
                       const __grid_constant__ Scratch sc,
                       const __nv_bfloat16* __restrict__ c_sdf,
                       const __nv_bfloat16* __restrict__ c_feat,
                       const __nv_bfloat16* __restrict__ c_grad, const float* __restrict__ flag,
                       float* __restrict__ part1, int n_small) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Pass1Smem& sm = *reinterpret_cast<Pass1Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d0 = 3 * (1 + 2 * multires);
  const int L = d.n_layers;
  const int n_tiles = (N + PTS - 1) / PTS;
  if (tid == 0) sm.ring.init(TB_CONSUMER_WARPS);
  for (int i = tid; i < n_small; i += TB_THREADS) sm.part[i] = 0.0f;
  __syncthreads();

  if (warp == TB_CONSUMER_WARPS) {
    if (lane != 0) return;
    uint32_t k = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      for (int l = L - 1; l > 0; --l) {
        const int nch = (round_up(d.nout[l], 16) + TB_KC - 1) / TB_KC;
        for (int j = 0; j < nch; ++j, ++k)
          sm.ring.produce(k, sm.w[k % TB_STAGES], Wb + sc.wb_off[l] + (size_t)j * TB_CHUNK,
                          TB_CHUNK * sizeof(__nv_bfloat16));
      }
    return;
  }

  const int g = warp >> 2, t = tid & 127;
  const int col0_off = small_db(d, L);
  const int nL = d.nout[L - 1], F = nL - 1;
  uint32_t k = 0;

  // ct_A = CT W_l^T into ex (columns [128 g, 128 g + 128) by warpgroup g)
  auto propagate_tc = [&](int l) {
    const int nslab = round_up(d.nout[l], 16) / 16;
    const int nch = (nslab * 16 + TB_KC - 1) / TB_KC;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    wg::fence();
    for (int j = 0; j < nch; ++j, ++k) {
      sm.ring.acquire(k);
      const __nv_bfloat16* w = sm.w[k % TB_STAGES];
#pragma unroll
      for (int s = 0; s < TB_KC / 16; ++s) {
        const int slab = j * (TB_KC / 16) + s;
        if (slab < nslab) {
          const uint64_t da = wg::desc(sm.ct + wg::core_offset(0, 16 * slab, 64), 1024, 128);
          const uint64_t db = wg::desc(w + s * 16 * 256 + wg::core_offset(128 * g, 0, 256), 4096, 128);
          wg::wgmma_m64n128k16<0, 0>(acc, da, db, slab > 0 ? 1 : 0);
        }
      }
      wg::commit();
      if (j > 0) {  // the previous stage's products are done: release it
        wg::wait<1>();
        if (lane == 0) sm.ring.release(k - 1);
      }
    }
    wg::wait<0>();
    if (lane == 0) sm.ring.release(k - 1);
    const bool skip = d.skip[l] != 0;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = wg::frag_row(t, i), c = 128 * g + wg::frag_col(t, i);
      *reinterpret_cast<float2*>(&sm.ex[r * XLD + c]) =
          skip ? make_float2(acc[i] / SQRT2, acc[i + 1] / SQRT2) : make_float2(acc[i], acc[i + 1]);
    }
  };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * PTS;
    wg::bar(1, TB_CONSUMERS);  // the previous tile is done with shared memory
    if (tid < PTS) sm.fl[tid] = (flag != nullptr && p0 + tid < N) ? flag[p0 + tid] : 1.0f;
    load_pe_tile<1>(x, N, p0, multires, sm.xs, sm.x0);
    wg::bar(1, TB_CONSUMERS);

    // A_0: the embedding rows rounded, zero past d0 (kap[0] wide)
    {
      __nv_bfloat16* A0 = sc.a[0] + (size_t)tile * 64 * sc.kap[0];
      const int ncg = sc.kap[0] / 8;
      for (int it = tid; it < 64 * ncg; it += TB_CONSUMERS) {
        const int r = it / ncg, c = 8 * (it % ncg);
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = c + j < LD0 ? sm.x0[r * LD0 + c + j] : 0.0f;
        store8(A0, r, c, v);
      }
    }

    // the last layer's CT: [c_sdf flag | c_feat] on the primal rows, c_grad_k
    // flag in the SDF column of tangent row k; its features part for pass 2
    {
      const int Kp = round_up(nL, 16);
      for (int it = tid; it < 64 * (Kp / 8); it += TB_CONSUMERS) {
        const int r = it / (Kp / 8), c = 8 * (it % (Kp / 8));
        const int p = r % PTS, kk = r / PTS;
        const bool ok = p0 + p < N;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cj = c + j;
          float e = 0.0f;
          if (ok && cj < nL) {
            if (kk == 0) {
              e = cj == 0 ? __bfloat162float(c_sdf[p0 + p]) * sm.fl[p]
                          : __bfloat162float(c_feat[(size_t)(p0 + p) * F + cj - 1]);
            } else if (cj == 0) {
              e = __bfloat162float(c_grad[(size_t)(p0 + p) * 3 + kk - 1]) * sm.fl[p];
            }
          }
          v[j] = e;
        }
        if (c == 0) sm.ct0[r] = v[0];
        store8(sm.ct, r, c, v);
      }
      __nv_bfloat16* CF = sc.ct[L - 1] + (size_t)tile * BLK;
      for (int it = tid; it < 64 * 32; it += TB_CONSUMERS) {
        const int r = it / 32, c = 8 * (it % 32);
        const bool ok = r < PTS && p0 + r < N;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = ok && c + j < F ? __bfloat162float(c_feat[(size_t)(p0 + r) * F + c + j]) : 0.0f;
        store8(CF, r, c, v);
      }
      wg::fence_async_smem();
      wg::bar(1, TB_CONSUMERS);
      const int dbo = small_db(d, L - 1);
      for (int c = tid; c < nL; c += TB_CONSUMERS) {
        float sdb = 0.0f;
        for (int p = 0; p < PTS; ++p)
          sdb += __bfloat162float(sm.ct[wg::core_offset(p, c, 64)]);
        sm.part[dbo + c] += sdb;
      }
    }
    propagate_tc(L - 1);

    // hidden layers, from the top: the gate step on ex, CT_l and A_{l+1}
    const int wp = warp;  // points wp and wp + 8
    const int c8 = 8 * lane;
    for (int l = L - 2; l >= 0; --l) {
      const int nout = d.nout[l];
      const bool skip = d.skip[l + 1] != 0;
      const __nv_bfloat16* Zl = static_cast<const __nv_bfloat16*>(z.p[l]);
      __nv_bfloat16* CTg = sc.ct[l] + (size_t)tile * BLK;
      __nv_bfloat16* Ag = sc.a[l + 1] + (size_t)tile * 64 * sc.kap[l + 1];
      wg::bar(1, TB_CONSUMERS);  // ex written, the products have read ct
      float db[8], w0[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) db[j] = w0[j] = 0.0f;
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        const int p = wp + 8 * pp;
        const bool ok = p0 + p < N;
        float ct[4][8], a[4][8];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 e0 = *reinterpret_cast<const float4*>(&sm.ex[(kk * PTS + p) * XLD + c8]);
          const float4 e1 = *reinterpret_cast<const float4*>(&sm.ex[(kk * PTS + p) * XLD + c8 + 4]);
          ct[kk][0] = e0.x; ct[kk][1] = e0.y; ct[kk][2] = e0.z; ct[kk][3] = e0.w;
          ct[kk][4] = e1.x; ct[kk][5] = e1.y; ct[kk][6] = e1.z; ct[kk][7] = e1.w;
        }
        // the point's Z rows (primal, then the 3 tangents) at these 8
        // columns, all loads issued before any use; zero past nout
        float zr[4][8];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            zr[kk][j] = ok && c8 + j < nout
                            ? __bfloat162float(Zl[((size_t)kk * N + p0 + p) * nout + c8 + j])
                            : 0.0f;
        // branch-free over the 8 columns, so their chains interleave: past
        // nout ct (from the zero-padded product) and so ct_z are 0, and A
        // takes the embedding's columns at a skip layer
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c8 + j;
          const bool live = c < nout;
          float h, sg;
          gate100(zr[0][j], h, sg);
          const float s2 = 100.0f * sg * (1.0f - sg);
          const float ct_sum = ct[1][j] * zr[1][j] + ct[2][j] * zr[2][j] + ct[3][j] * zr[3][j];
          const float ct_z = ct[0][j] * sg + ct_sum * s2;
          db[j] += ct_z;
          ct[0][j] = ct_z;
#pragma unroll
          for (int kk = 1; kk < 4; ++kk) ct[kk][j] *= sg;
          const bool emb = skip && !live && c < nout + d0;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float v = kk == 0 ? h : sg * zr[kk][j];
            const float e = emb ? sm.x0[(kk * PTS + p) * LD0 + (emb ? c - nout : 0)] : 0.0f;
            const float av = live ? v : e;
            a[kk][j] = skip ? av / SQRT2 : av;
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int r = kk * PTS + p;
          store8(sm.ct, r, c8, ct[kk]);
          store8(CTg, r, c8, ct[kk]);
          if (c8 < sc.kap[l + 1]) store8(Ag, r, c8, a[kk]);
          if (l == L - 2) {
            const float c0 = sm.ct0[r];
#pragma unroll
            for (int j = 0; j < 8; ++j) w0[j] += __bfloat162float(__float2bfloat16_rn(a[kk][j])) * c0;
          }
        }
      }
      wg::fence_async_smem();
      wg::bar(1, TB_CONSUMERS);  // every gate read of ex is done: ex is the reduction scratch
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sm.ex[wp * XLD + c8 + j] = db[j];
        sm.ex[(8 + wp) * XLD + c8 + j] = w0[j];
      }
      wg::bar(1, TB_CONSUMERS);
      const int dbo = small_db(d, l);
      for (int c = tid; c < 256; c += TB_CONSUMERS) {
        float sdb = 0.0f, sw = 0.0f;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          sdb += sm.ex[w * XLD + c];
          sw += sm.ex[(8 + w) * XLD + c];
        }
        if (c < nout) sm.part[dbo + c] += sdb;
        if (l == L - 2 && c < d.kin[L - 1]) sm.part[col0_off + c] += sw;
      }
      wg::bar(1, TB_CONSUMERS);  // the scratch is read before the next product writes ex
      if (l > 0) propagate_tc(l);
    }
  }
  wg::bar(1, TB_CONSUMERS);
  for (int i = tid; i < n_small; i += TB_CONSUMERS) part1[(size_t)blockIdx.x * n_small + i] = sm.part[i];
}

// Pass 2: dW_l = A_l^T CT_l over every tile, on the tensor cores. A CTA
// takes one job: layer l, 128 of its inputs (m-block mb), every output
// column (256), and split s of the tiles; two warpgroups of 64 inputs each,
// wgmma.m64n256k16 reading both operands transposed (MN-major) from a ring
// of bulk copies. Its 128 x 256 float32 sums go to part2[job].
__global__ void __launch_bounds__(TB_THREADS, 1)
sdf_grad_bwd_kernel_dw(int n_tiles, int L, const __grid_constant__ Scratch sc, int splits,
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
  if (tid == 0) sm.ring.init(TB_CONSUMER_WARPS);
  __syncthreads();

  if (warp == TB_CONSUMER_WARPS) {
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

// out <- the weight gradients from pass 2's partials (summed over the splits
// in order): every entry of the hidden layers, the last layer's feature
// columns; and from pass 1's (summed over its CTAs in order) the biases and
// the last layer's SDF column.
__global__ void reduce_partials_tc(MlpDesc d, const __grid_constant__ Scratch sc, int splits,
                                   const float* __restrict__ part2, int grid1, int n_small,
                                   const float* __restrict__ part1, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int L = d.n_layers;
  if (i < n_small) {
    float acc = 0.0f;
    for (int b = 0; b < grid1; ++b) acc += part1[(size_t)b * n_small + i];
    const int col0_off = small_db(d, L);
    if (i >= col0_off) {
      out[d.woff[L - 1] + (size_t)(i - col0_off) * d.nout[L - 1]] = acc;
    } else {
      int l = 0, c = i;
      while (c >= d.nout[l]) c -= d.nout[l++];
      out[d.boff[l] + c] = acc;
    }
  }
  // the weights: one thread per (layer, input k, output c) of pass 2's jobs
  int j = i, job0 = 0;
  for (int l = 0; l < L; ++l) {
    const int kin = d.kin[l], last = l == L - 1;
    const int ncols = last ? d.nout[l] - 1 : d.nout[l];
    if (j < kin * ncols) {
      const int kk = j / ncols, c = j % ncols;
      const int mb = kk / 128;
      float acc = 0.0f;
      for (int s = 0; s < splits; ++s)
        acc += part2[((size_t)(job0 + mb * splits + s) * 128 + kk % 128) * 256 + c];
      out[d.woff[l] + (size_t)kk * d.nout[l] + c + last] = acc;
      return;
    }
    j -= kin * ncols;
    job0 += sc.kap[l] / 128 * splits;
  }
}

extern "C" int sdf_grad_bwd_launch(const float* x, int N, int multires, const int* desc,
                                   const float* P, const float* PT, void* const* z_in,
                                   const void* c_sdf, const void* c_feat, const void* c_grad,
                                   const float* flag, float* work, int grid, int n_params,
                                   float* out, void* stream) {
  const MlpDesc d = desc_from(desc);
  ZPtrs z;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) z.p[l] = z_in[l];
  const size_t smem = MLP_SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(sdf_grad_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sdf_grad_bwd_kernel<<<grid, THREADS, smem, s>>>(x, N, multires, d, P, PT, z, c_sdf, c_feat, c_grad,
                                                  flag, work, n_params);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<(n_params + THREADS - 1) / THREADS, THREADS, 0, s>>>(work, grid, n_params, out);
  return static_cast<int>(cudaGetLastError());
}

// bf16: pass 1 on grid1 persistent CTAs (part1: grid1 x n_small floats),
// pass 2 on one CTA per job (part2: jobs x 128 x 256 floats, jobs = the
// layers' 128-input blocks x splits), then the ordered sums into out.
// ct / a: the per-layer scratch pointers; kap: A_l's block widths; wb_off:
// the layers' offsets in Wb.
extern "C" int sdf_grad_bwd_tc_launch(const float* x, int N, int multires, const int* desc,
                                      const void* Wb, const int* wb_off, void* const* z_in,
                                      void* const* ct, void* const* a, const int* kap,
                                      const void* c_sdf, const void* c_feat, const void* c_grad,
                                      const float* flag, float* part1, int grid1, int n_small,
                                      float* part2, int splits, int n_out, float* out,
                                      void* stream) {
  const MlpDesc d = desc_from(desc);
  ZPtrs z;
  Scratch sc;
  int jobs = 0;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) {
    z.p[l] = z_in[l];
    sc.ct[l] = static_cast<__nv_bfloat16*>(ct[l]);
    sc.a[l] = static_cast<__nv_bfloat16*>(a[l]);
    sc.kap[l] = kap[l];
    sc.wb_off[l] = wb_off[l];
    if (l < d.n_layers) jobs += kap[l] / 128 * splits;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = sizeof(Pass1Smem), smem2 = sizeof(Pass2Smem);
  cudaFuncSetAttribute(sdf_grad_bwd_kernel_ct, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  sdf_grad_bwd_kernel_ct<<<grid1, TB_THREADS, smem1, s>>>(
      x, N, multires, d, static_cast<const __nv_bfloat16*>(Wb), z, sc,
      static_cast<const __nv_bfloat16*>(c_sdf), static_cast<const __nv_bfloat16*>(c_feat),
      static_cast<const __nv_bfloat16*>(c_grad), flag, part1, n_small);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncSetAttribute(sdf_grad_bwd_kernel_dw, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  sdf_grad_bwd_kernel_dw<<<jobs, TB_THREADS, smem2, s>>>((N + PTS - 1) / PTS, d.n_layers, sc, splits,
                                                         part2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_tc<<<(n_out + 255) / 256, 256, 0, s>>>(d, sc, splits, part2, grid1, n_small, part1,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
