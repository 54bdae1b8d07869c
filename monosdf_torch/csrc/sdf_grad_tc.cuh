// The tensor-core forward of the SDF MLP with its spatial gradient: K2f's
// training variant (sdf_grad.cu, layer 0 the embedding of raw points,
// computed in-kernel) and K7f's bf16 path (sdf_grad_grid.cu, layer 0 a given
// a0 (4, N, d0) float32), one body (sdf_grad_tc_body) that each library's
// kernel calls under its own name. The including file includes common.cuh
// and uses namespace mk first.
//
// The shape is K1's (sdf_mlp.cu sdf_mlp_kernel_tc). A persistent CTA per
// SM walks over 32-point tiles with two consumer warpgroups and a producer warpgroup (one
// thread of it busy), which hands its registers to the consumers
// (setmaxnreg: 232 a thread, so the float32 sums and the epilogue fit
// without spills). Each warpgroup takes 16 points as its 64-row m64 tile in
// the stacked order (16 primal rows, then 16 rows per tangent), so warp 0
// of a warpgroup holds the primal rows and warps 1-3 the tangent rows at
// the same lanes and columns. The activation tile is bf16 in shared memory
// in wgmma's operand layout. Each hidden layer runs wgmma.m64n128k16 over
// its input width, one 64-deep chain per weight stage and column half into
// a fresh float32 sum that the CUDA cores add into the layer's sums: the
// tensor cores' float32 accumulation is coarser than rounded float32 adds;
// over whole 256-deep chains it moved more bf16 roundings off a float64
// reference than the plain version, in 64-deep chains fewer (PERF.md,
// scripts/rounding_parity.py). The weights (K1's packing, plus the last
// layer's feature columns, packed once per call) stream through K1's ring
// of bulk copies, and both warpgroups read each stage, so a weight byte
// serves 128 rows.
// The epilogue runs on the sums in registers: every warp stores its rows'
// Z; warp 0 puts its primal z (bias added) in a per-warpgroup float32
// exchange buffer, all four warps compute the gate (h, s) of those 16 x 256
// values, and the tangent warps read s back at their own fragment positions
// (t = s u); named barriers over the warpgroup's 128 threads order the three
// steps. The last layer's feature columns are one more layer's products of
// which only the 16 primal rows are kept: three quarters of one layer's
// products in K2f's nine are wasted, accepted for now. Its SDF column, for all 64
// rows, is a warp dot over shared memory; the clamp and flag epilogue is
// the SIMT kernel's. Layer inputs up to 256 wide (the wrapper checks). Z
// and the features go to device memory straight from the registers: each
// quad of lanes transposes its pairs by shuffles, so a lane stores 16 bytes
// and a warp 8 rows x 64 contiguous bytes (widths not a multiple of 8 take
// 2-byte stores). Left out: a staged bulk store of Z that would run under
// the next layer's products.
//
// K7f's input: a0's four rows of a point (primal, three tangents) read as
// float32 and rounded to bf16 into the activation tile, K padded 71 -> 80;
// the grid trunk has no skip and no clamp (x is not read).
#pragma once

#include "wgmma.cuh"

namespace {

constexpr int TF_ROWS = 128;                // rows per tile: two warpgroups of 64
constexpr int TF_PTS = TF_ROWS / 4;         // points per tile: 16 per warpgroup
constexpr int TF_KC = 64;                   // weight rows (layer inputs) per ring stage
constexpr int TF_STAGES = 3;
constexpr int TF_KMAX = 256;                // activation tile width: layer inputs up to 256
constexpr int TF_CHUNK = TF_KC * 256;       // bf16 elements per stage (256 output columns)
constexpr int TF_THREADS = 384;             // 2 consumer warpgroups + 1 producer warpgroup
constexpr int TF_CONSUMER_WARPS = 8;
// registers a thread: the producer warpgroup gives its share to the
// consumers (40 x 128 + 232 x 256 <= 65,536)
constexpr int TF_PRODUCER_REGS = 40;
constexpr int TF_CONSUMER_REGS = 232;

struct FwdSmem {
  __nv_bfloat16 w[TF_STAGES][TF_CHUNK];     // the weight ring, B-operand layout
  __nv_bfloat16 a[TF_ROWS * TF_KMAX];       // the activation tile, A-operand layout (R = 128)
  __nv_bfloat16 x0s[TF_ROWS * LD0];         // the embedding and its tangents / sqrt 2, bf16
  float2 sx[2][64 * 32];                    // per warpgroup: z, then s, of its primal rows
  float bias[2][256];                       // each warpgroup's copy of the layer's bias (warp 0's)
  float w0[TF_KMAX];                        // the last layer's SDF column, bf16-rounded
  float sd[2][64];                          // each row's SDF column
  wg::Ring<TF_STAGES> ring;
};

// byte distances of the operand layouts (wgmma.cuh core_offset)
constexpr uint32_t A_LBO = (TF_ROWS / 8) * 128;  // next 8 columns of the activation tile
constexpr uint32_t B_LBO = (256 / 8) * 128;      // next 8 input rows of a weight stage
constexpr uint32_t CORE_SBO = 128;               // next 8 rows (A) or output columns (B)

// The next layer's input at (r, c) from v, this layer's rounded output there:
// / sqrt 2 at a skip layer, whose columns past nout take the embedding
// (x0s holds it divided and rounded); zero past the input.
__device__ __forceinline__ float next_input(float v, int r, int c, int nout, int d0, bool skip,
                                            const __nv_bfloat16* x0s) {
  if (c < nout) return skip ? v / SQRT2 : v;
  if (skip && c < nout + d0) return __bfloat162float(x0s[r * LD0 + c - nout]);
  return 0.0f;
}

// v (2 values, columns c, c + 1) into row `row` of a (4, N, n) tensor at
// the operand type; a 4-byte store when n is even, else two
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int n, float v0, float v1) {
  if ((n & 1) == 0) {
    if (c < n) *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < n) row[c] = __float2bfloat16_rn(v0);
    if (c + 1 < n) row[c + 1] = __float2bfloat16_rn(v1);
  }
}

// 4 x 4 transpose of 32-bit values within each quad of lanes: lane q holds
// row q in x, and afterwards column q
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int q) {
  const bool odd = q & 1, hi = q & 2;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? x[0] : x[1], 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? x[2] : x[3], 1);
  if (odd) {
    x[0] = r0;
    x[2] = r1;
  } else {
    x[1] = r0;
    x[3] = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, hi ? x[0] : x[2], 2);
  r1 = __shfl_xor_sync(0xffffffffu, hi ? x[1] : x[3], 2);
  if (hi) {
    x[0] = r0;
    x[1] = r1;
  } else {
    x[2] = r0;
    x[3] = r1;
  }
}

// A warp's 16 accumulator rows (wgmma's fragment, 256 columns) into rows p <
// np of a row-major (., n) tensor at dst, at the operand type. With n % 8 ==
// 0 each quad transposes its 4-byte pairs so that a lane stores 8 columns
// (16 bytes) at once: a warp's store covers 8 rows x 64 contiguous bytes.
__device__ __forceinline__ void store_rows(const float (&v)[128], __nv_bfloat16* dst, int n, int np,
                                           int lane) {
  const int q = lane & 3;
  if ((n & 7) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (lane >> 2) + 8 * h;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        uint32_t x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // column group 4 jb + j, row half h: d[4 (4 jb + j) + 2 h]
          const __nv_bfloat162 b = __floats2bfloat162_rn(v[16 * jb + 4 * j + 2 * h],
                                                         v[16 * jb + 4 * j + 2 * h + 1]);
          x[j] = *reinterpret_cast<const uint32_t*>(&b);
        }
        quad_transpose(x, q);
        const int c = 8 * (4 * jb + q);
        if (p < np && c < n)
          *reinterpret_cast<uint4*>(dst + (size_t)p * n + c) = make_uint4(x[0], x[1], x[2], x[3]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int p = (lane >> 2) + 8 * ((i >> 1) & 1);
      if (p < np) store_pair(dst + (size_t)p * n, wg::frag_col(lane, i), n, v[i], v[i + 1]);
    }
  }
}

}  // namespace

// Per layer l: off[l] is the element offset in Wb of its packed bf16 B
// operand (the hidden layers' W_l; at l = L - 1 the last layer's feature
// columns), its chunks (TF_KC input rows each, zero-padded) following in order.
struct FwdWb {
  int off[MK_MAX_LAYERS];
};

// The kernel body, on TF_THREADS threads of a persistent CTA. A0 false
// (K2f): layer 0's input is the embedding of the raw points x, d0 = 3 (1 +
// 2 multires) wide, computed here. A0 true (K7f): it is a0 (4, N, d0)
// float32, given, and x is not read (no clamp: bounding_sphere 0). z.p[l]
// null skips the Z stores (a variant without Z).
template <bool A0>
__device__ __forceinline__ void sdf_grad_tc_body(
    const float* __restrict__ x, const float* __restrict__ a0, int N, int d0, const MlpDesc& d,
    const float* __restrict__ P, const __nv_bfloat16* __restrict__ Wb, const FwdWb& wb,
    float bounding_sphere, float sphere_scale, int clamp_rows, float* __restrict__ sdf_out,
    __nv_bfloat16* __restrict__ feat_out, float* __restrict__ grad_out,
    float* __restrict__ flag_out, const ZPtrs& z) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = d.n_layers;
  const int n_tiles = (N + TF_PTS - 1) / TF_PTS;
  const int kl = d.kin[L - 1], nl = d.nout[L - 1], F = nl - 1;
  if (tid == 0) sm.ring.init(TF_CONSUMER_WARPS);
  for (int c = tid; c < TF_KMAX; c += TF_THREADS)
    sm.w0[c] = c < kl ? rnd<true>(P[d.woff[L - 1] + (size_t)c * nl]) : 0.0f;
  __syncthreads();

  if (warp >= TF_CONSUMER_WARPS) {
    // the producer: every chunk of every layer of every tile, in the
    // consumers' order (the hidden layers, then the feature columns)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TF_PRODUCER_REGS));
    if (warp != TF_CONSUMER_WARPS || lane != 0) return;
    uint32_t k = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      for (int l = 0; l < L; ++l) {
        const int nch = (round_up(d.kin[l], 16) + TF_KC - 1) / TF_KC;
        for (int j = 0; j < nch; ++j, ++k)
          sm.ring.produce(k, sm.w[k % TF_STAGES], Wb + wb.off[l] + (size_t)j * TF_CHUNK,
                          TF_CHUNK * sizeof(__nv_bfloat16));
      }
    return;
  }

  // the consumers: warpgroup g owns rows [64 g, 64 g + 64) of each tile,
  // points [16 g, 16 g + 16): row 16 kk + p is point p's primal (kk = 0) or
  // tangent kk row, held by warp kk of the warpgroup
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TF_CONSUMER_REGS));
  const int g = warp >> 2, t = tid & 127, wq = warp & 3, r0 = 64 * g;
  const int bar_id = 1 + g;
  float2* sx = sm.sx[g];
  uint32_t k = 0;

  // the products of layer l (its input in sm.a) into acc. Per weight stage
  // (64 inputs) and column half, a chain of wgmma.m64n128k16 into a fresh
  // float32 sum, added into acc by the CUDA cores: the tensor cores'
  // float32 accumulation is coarser than rounded float32 adds, and over
  // whole 256-deep chains it moved more bf16 roundings off a float64
  // reference than the plain version's sums do; 64-deep chains and rounded
  // adds move fewer (PERF.md; scripts/rounding_parity.py).
  auto products = [&](int l, float (&acc)[128]) {
    const int nslab = round_up(d.kin[l], 16) / 16;
    const int nch = (nslab * 16 + TF_KC - 1) / TF_KC;
    float part[64];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.0f;
    for (int j = 0; j < nch; ++j, ++k) {
      sm.ring.acquire(k);
      const __nv_bfloat16* w = sm.w[k % TF_STAGES];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wg::fence();
#pragma unroll
        for (int s = 0; s < TF_KC / 16; ++s) {
          const int slab = j * (TF_KC / 16) + s;
          if (slab < nslab) {
            const uint64_t da = wg::desc(sm.a + wg::core_offset(r0, 16 * slab, TF_ROWS), A_LBO, CORE_SBO);
            const uint64_t db = wg::desc(w + s * 16 * 256 + wg::core_offset(128 * h, 0, 256), B_LBO, CORE_SBO);
            wg::wgmma_m64n128k16<0, 0>(part, da, db, s > 0 ? 1 : 0);
          }
        }
        wg::commit();
        wg::wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[64 * h + i] += part[i];  // column 128 h + frag_col
      }
      if (lane == 0) sm.ring.release(k);  // both halves have read the stage
    }
  };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int q0 = tile * TF_PTS + 16 * g;  // the warpgroup's first point
    wg::bar(bar_id, 128);  // the previous tile's last layer is done with sm.a and sm.sd
    // layer 0's input: the embedding or a0's rows (row p) and its tangents
    // (row 16 (kk + 1) + p), rounded; / sqrt 2 for the skip layers
    const int Kp0 = round_up(d0, 16);
    auto put = [&](int p, int c, const float (&v)[4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int r = r0 + 16 * kk + p;
        sm.a[wg::core_offset(r, c, TF_ROWS)] = __float2bfloat16_rn(v[kk]);
        sm.x0s[r * LD0 + c] = __float2bfloat16_rn(v[kk] / SQRT2);
      }
    };
    if constexpr (A0) {
      for (int idx = t; idx < 16 * Kp0; idx += 128) {
        const int p = idx / Kp0, c = idx - p * Kp0;
        const bool ok = c < d0 && q0 + p < N;
        float v[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) v[kk] = ok ? a0[((size_t)kk * N + q0 + p) * d0 + c] : 0.0f;
        put(p, c, v);
      }
    } else {
      for (int idx = t; idx < 16 * Kp0; idx += 128) {
        const int p = idx / Kp0, c = idx - p * Kp0;
        float tg[3] = {0.0f, 0.0f, 0.0f};
        const float e = q0 + p < N ? pe_value(x + (size_t)(q0 + p) * 3, c, d0, tg) : 0.0f;
        const float v[4] = {e, tg[0], tg[1], tg[2]};
        put(p, c, v);
      }
    }
    wg::fence_async_smem();
    wg::bar(bar_id, 128);

    for (int l = 0; l < L - 1; ++l) {
      const int nout = d.nout[l];
      const bool skip = d.skip[l + 1] != 0;
      if (wq == 0) {  // warp 0 alone reads the bias
        for (int c = lane; c < 256; c += 32) sm.bias[g][c] = c < nout ? P[d.boff[l] + c] : 0.0f;
        __syncwarp();
      }
      float acc[128];
      products(l, acc);
      __nv_bfloat16* Z = static_cast<__nv_bfloat16*>(z.p[l]);

      // (1) warp 0: z = acc + b of the primal rows into the exchange buffer,
      // by fragment position; the tangent warps store their rows' Z
      if (wq == 0) {
#pragma unroll
        for (int i = 0; i < 128; i += 2) {
          const float2 b2 = *reinterpret_cast<const float2*>(&sm.bias[g][wg::frag_col(t, i)]);
          acc[i] += b2.x;
          acc[i + 1] += b2.y;
          sx[(i >> 1) * 32 + lane] = make_float2(acc[i], acc[i + 1]);
        }
      } else if (Z != nullptr) {
        store_rows(acc, Z + ((size_t)wq * N + q0) * nout, nout, N - q0, lane);
      }
      wg::bar(bar_id, 128);  // z is in sx; every warp's products have read sm.a

      // (2) all four warps: the gate of the 16 x 256 primal values, h into
      // sm.a, s back into the exchange buffer
      {
        const int lq = t & 31;  // the warp-0 lane whose fragment positions this thread takes
#pragma unroll 4
        for (int m = 0; m < 16; ++m) {
          const int ip = wq + 4 * m, i = 2 * ip;
          const int r = r0 + wg::frag_row(lq, i), c = wg::frag_col(lq, i);
          const float2 z2 = sx[ip * 32 + lq];
          float h0, s0, h1, s1;
          gate100(z2.x, h0, s0);
          gate100(z2.y, h1, s1);
          sx[ip * 32 + lq] = make_float2(s0, s1);
          const float a0 = next_input(rnd<true>(h0), r, c, nout, d0, skip, sm.x0s);
          const float a1 = next_input(rnd<true>(h1), r, c + 1, nout, d0, skip, sm.x0s);
          *reinterpret_cast<__nv_bfloat162*>(&sm.a[wg::core_offset(r, c, TF_ROWS)]) =
              __floats2bfloat162_rn(a0, a1);
        }
      }
      wg::bar(bar_id, 128);  // s is in sx

      // (3) the tangent warps: t = s u into sm.a; warp 0 stores the primal Z
      if (wq == 0) {
        if (Z != nullptr) store_rows(acc, Z + (size_t)q0 * nout, nout, N - q0, lane);
      } else {
#pragma unroll
        for (int i = 0; i < 128; i += 2) {
          const int r = r0 + wg::frag_row(t, i), c = wg::frag_col(t, i);
          const float2 s2 = sx[(i >> 1) * 32 + lane];
          const float a0 = next_input(rnd<true>(s2.x * acc[i]), r, c, nout, d0, skip, sm.x0s);
          const float a1 = next_input(rnd<true>(s2.y * acc[i + 1]), r, c + 1, nout, d0, skip, sm.x0s);
          *reinterpret_cast<__nv_bfloat162*>(&sm.a[wg::core_offset(r, c, TF_ROWS)]) =
              __floats2bfloat162_rn(a0, a1);
        }
      }
      wg::fence_async_smem();
      wg::bar(bar_id, 128);  // the next layer's input is in sm.a
    }

    // the last layer: the feature columns as one layer's products (the
    // primal rows kept), then the SDF column of all 64 rows as a warp dot
    {
      if (wq == 0) {
        for (int c = lane; c < 256; c += 32) sm.bias[g][c] = c < F ? P[d.boff[L - 1] + 1 + c] : 0.0f;
        __syncwarp();
      }
      float acc[128];
      products(L - 1, acc);
      // lane (rr, h) sums row 16 wq + rr over the 8-column groups h, h + 2, ...
      const int rr = lane & 15, h = lane >> 4, r = r0 + 16 * wq + rr;
      float s = 0.0f;
      for (int cg = h; cg < (kl + 7) / 8; cg += 2) {
        const uint4 u = *reinterpret_cast<const uint4*>(&sm.a[wg::core_offset(r, 8 * cg, TF_ROWS)]);
        const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float4 wa = *reinterpret_cast<const float4*>(&sm.w0[8 * cg]);
        const float4 wb4 = *reinterpret_cast<const float4*>(&sm.w0[8 * cg + 4]);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb4.x, wb4.y, wb4.z, wb4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(hv[j]);
          s = fmaf(f.x, wv[2 * j], s);
          s = fmaf(f.y, wv[2 * j + 1], s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (h == 0) sm.sd[g][16 * wq + rr] = s;
      wg::bar(bar_id, 128);  // sd is complete
      if (wq == 0) {
#pragma unroll
        for (int i = 0; i < 128; i += 2) {
          const float2 b2 = *reinterpret_cast<const float2*>(&sm.bias[g][wg::frag_col(t, i)]);
          acc[i] += b2.x;
          acc[i + 1] += b2.y;
        }
        store_rows(acc, feat_out + (size_t)q0 * F, F, N - q0, lane);
      }
    }

    // the clamp and the flag, one thread per point
    if (t < 16 && q0 + t < N) {
      const int p = t;
      const size_t o = (size_t)(q0 + p);
      float sdf = sm.sd[g][p] + P[d.boff[L - 1]];
      float gr[3] = {sm.sd[g][16 + p], sm.sd[g][32 + p], sm.sd[g][48 + p]};
      bool take = true;
      if (!A0 && bounding_sphere > 0.0f) {
        const float x0 = x[o * 3], x1 = x[o * 3 + 1], x2 = x[o * 3 + 2];
        const float norm = sqrtf(x0 * x0 + x1 * x1 + x2 * x2);
        const float sphere = sphere_scale * (bounding_sphere - norm);
        take = sdf <= sphere || (clamp_rows >= 0 && (int)o >= clamp_rows);
        if (!take) {
          sdf = sphere;
          const float q = -sphere_scale / fmaxf(norm, 1e-12f);
          gr[0] = x0 * q;
          gr[1] = x1 * q;
          gr[2] = x2 * q;
        }
      }
      sdf_out[o] = sdf;
      grad_out[o * 3 + 0] = gr[0];
      grad_out[o * 3 + 1] = gr[1];
      grad_out[o * 3 + 2] = gr[2];
      if (flag_out != nullptr) flag_out[o] = take ? 1.0f : 0.0f;
    }
  }
}
