// The tensor-core forward of the radiance ReLU trunk, shared by K3f's bf16
// forward (radiance_norm.cu) and K3b's pass 1 (radiance_bwd_tc.cuh), which
// recomputes it. The including file includes radiance.cuh first.
//
// A persistent CTA per SM walks 64-row tiles (one row per sample) with two
// consumer warpgroups and a producer warp that streams the bf16 B operands
// (W_l, packed once per call: kernels/radiance_norm.py pack_fwd, pack_bwd),
// 64 rows a stage, through a 3-stage ring of bulk copies. Per tile:
// - the input row h0 = [sv | n | feat | code] (n = g / q as rad_normals
//   computes it) is built in shared memory at bf16 in wgmma's layout, 16
//   bytes a read (rb_build_h0);
// - Y_l = relu(rnd(rnd(A W_l) + rnd(b_l))): each warpgroup takes 128 of the
//   256 output columns (wgmma.m64n128k16 over the whole tile); per 64-deep
//   weight stage a fresh float32 sum on the tensor cores, which the CUDA
//   cores add into the layer's sums (as K2f's training kernel does: its
//   bf16 roundings land nearer the plain version's). Y_l is bf16-exact
//   after its rounding, so it is kept as bf16, alternating between two
//   64 x 256 buffers (rb_forward).
#pragma once

#include "wgmma.cuh"

namespace {

constexpr int RB_CONSUMERS = 256;              // two warpgroups
constexpr int RB_THREADS = RB_CONSUMERS + 32;  // and one producer warp
constexpr int RB_CONSUMER_WARPS = 8;
constexpr int RB_KC = 64;                      // B rows per ring stage
constexpr int RB_STAGES = 3;
constexpr int RB_CHUNK = RB_KC * 256;          // bf16 elements of a stage

// The consumers' side of the ring of B operands: its stages and the next use.
struct RbStream {
  __nv_bfloat16 (*w)[RB_CHUNK];
  wg::Ring<RB_STAGES>* ring;
  uint32_t k;
};

// acc <- A (64 x K, R = 64) times the ring's next B operand (depth K),
// columns [128 g, 128 g + 128): per weight stage a chain of
// wgmma.m64n128k16 into a fresh float32 sum that the CUDA cores add into
// acc. live false: the stages are taken and released, no product (a block
// narrower than 128 g)
__device__ __forceinline__ void rb_products(RbStream& st, const __nv_bfloat16* A, int K,
                                            float (&acc)[64], bool live, int g, int lane) {
  const int nslab = round_up(K, 16) / 16;
  const int nch = (nslab * 16 + RB_KC - 1) / RB_KC;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
  for (int j = 0; j < nch; ++j, ++st.k) {
    st.ring->acquire(st.k);
    if (live) {
      const __nv_bfloat16* w = st.w[st.k % RB_STAGES];
      wg::fence();
#pragma unroll
      for (int s = 0; s < RB_KC / 16; ++s) {
        const int slab = j * (RB_KC / 16) + s;
        if (slab < nslab) {
          const uint64_t da = wg::desc(A + wg::core_offset(0, 16 * slab, TILE_M), 1024, 128);
          const uint64_t db = wg::desc(w + s * 16 * 256 + wg::core_offset(128 * g, 0, 256), 4096, 128);
          wg::wgmma_m64n128k16<0, 0>(part, da, db, s > 0 ? 1 : 0);
        }
      }
      wg::commit();
      wg::wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    if (lane == 0) st.ring->release(st.k);
  }
}

// The hidden layers of a tile: Y_l = relu(rnd(rnd(A W_l) + rnd(b_l))) into
// y[l % 2] (64 x 256, wgmma's layout), A = h for l = 0 (the ring's B
// operands W_0 .. W_{H-1} in order; bias[256 l + c]: the biases, rounded,
// zero past nout), a consumer barrier after each layer, then after(l, Y_l). Returns
// Y_{H-1}.
template <class After>
__device__ __forceinline__ const __nv_bfloat16* rb_forward(
    RbStream& st, const __nv_bfloat16* h, const MlpDesc& d, const float* bias,
    __nv_bfloat16 (*y)[TILE_M * 256], int g, int lane, int t, After after) {
  const __nv_bfloat16* cur = h;
  for (int l = 0; l < d.n_layers - 1; ++l) {
    float acc[64];
    rb_products(st, cur, d.kin[l], acc, true, g, lane);
    __nv_bfloat16* Y = y[l & 1];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = wg::frag_row(t, i), c = 128 * g + wg::frag_col(t, i);
      const float y0 = rnd<true>(rnd<true>(acc[i]) + bias[256 * l + c]);
      const float y1 = rnd<true>(rnd<true>(acc[i + 1]) + bias[256 * l + c + 1]);
      *reinterpret_cast<__nv_bfloat162*>(&Y[wg::core_offset(r, c, TILE_M)]) =
          __floats2bfloat162_rn(fmaxf(y0, 0.0f), fmaxf(y1, 0.0f));
    }
    wg::fence_async_smem();
    wg::bar(1, RB_CONSUMERS);  // Y_l is complete; the products have read cur
    after(l, Y);
    cur = Y;
  }
  return cur;
}

}  // namespace

// H <- the tile's input rows at bf16 in wgmma's layout (R = 64), zero past
// N and in the pad columns up to round_up(d0, 16); K3b's normals from nr. A
// segment's rows of the tile are one run of rows x width elements in device
// memory: a thread reads 16 bytes of it at a time where the run is 16-byte
// aligned (as the operands the wrapper allocates are), else one element.
__device__ __forceinline__ void rb_build_h0(__nv_bfloat16* H, const RadIn& in, const float* nr,
                                            int N, int row0) {
  const int tid = threadIdx.x;
  const int rows = min(TILE_M, N - row0);
  int c0 = 0;
  for (int s = 0; s < in.nseg; ++s) {
    const RadSeg& sg = in.seg[s];
    const int w = sg.width, n = rows * w, per = sg.f32 ? 4 : 8;
    const char* base = static_cast<const char*>(sg.p) + (size_t)row0 * w * (sg.f32 ? 4 : 2);
    if (s != in.norm_seg && (reinterpret_cast<uintptr_t>(base) & 15) == 0) {
#pragma unroll 2
      for (int v = tid; v * per < n; v += RB_CONSUMERS) {
        const int e0 = v * per;
        float x[8];
        if (e0 + per <= n) {
          const uint4 u = reinterpret_cast<const uint4*>(base)[v];
          if (sg.f32) {
            const float4 f = *reinterpret_cast<const float4*>(&u);
            x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
          } else {
            const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 f = __bfloat1622float2(b[i]);
              x[2 * i] = f.x, x[2 * i + 1] = f.y;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            x[j] = j < per && e0 + j < n ? (sg.f32 ? reinterpret_cast<const float*>(base)[e0 + j]
                                                   : load_act<true>(base, e0 + j))
                                         : 0.0f;
        }
        int r = e0 / w, c = e0 - r * w;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < per && e0 + j < n) {
            H[wg::core_offset(r, c0 + c, TILE_M)] = __float2bfloat16_rn(x[j]);
            if (++c == w) c = 0, ++r;
          }
        }
      }
    } else {
      for (int e = tid; e < n; e += RB_CONSUMERS) {
        const int r = e / w, c = e - r * w;
        const float v = s == in.norm_seg ? nr[r * NRM + c]
                        : sg.f32         ? reinterpret_cast<const float*>(base)[e]
                                         : load_act<true>(base, e);
        H[wg::core_offset(r, c0 + c, TILE_M)] = __float2bfloat16_rn(v);
      }
    }
    c0 += w;
  }
  const int Kp = round_up(in.d0, 16), pad = Kp - in.d0;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int e = tid; e < (TILE_M - rows) * Kp; e += RB_CONSUMERS)  // the rows past N
    H[wg::core_offset(rows + e / Kp, e % Kp, TILE_M)] = zero;
  for (int e = tid; e < rows * pad; e += RB_CONSUMERS)  // the pad columns
    H[wg::core_offset(e / pad, in.d0 + e % pad, TILE_M)] = zero;
}

