// The tensor-core forward of the radiance ReLU trunk, shared by the bf16
// forwards of K3f (radiance_norm.cu) and K8a (radiance_split.cu), whose
// whole kernel body is rb_trunk_forward, and by the backward's pass 1
// (radiance_bwd_tc.cuh, K3b and K8a), which recomputes it. The including
// file includes radiance.cuh first.
//
// A persistent CTA per SM walks 64-row tiles (one row per sample) with two
// consumer warpgroups and a producer warp that streams the bf16 B operands
// (W_l, packed once per call: kernels/radiance_norm.py pack_fwd, pack_bwd),
// 64 rows a stage, through a 3-stage ring of bulk copies. Per tile:
// - the input row h0 = [sv | n | feat | code] (K3: n = g / q as
//   rad_normals computes it; K8a: the raw gradient) is built in shared
//   memory at bf16 in wgmma's layout, 16 bytes a read (rb_build_h0);
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

namespace {

constexpr int RF_MAX_HIDDEN = 8;

struct RadFwdSmem {
  __nv_bfloat16 w[RB_STAGES][RB_CHUNK];      // the ring of B operands
  __nv_bfloat16 h[TILE_M * LDH];             // h0, the A operand (R = 64)
  __nv_bfloat16 y[2][TILE_M * 256];          // the hidden layers, alternating
  float bias[RF_MAX_HIDDEN][256];            // the hidden biases, bf16-rounded
  float wt[256 * 4];                         // the top layer's W, rounded: (k, j) at 4 k + j
  float nr[TILE_M * NRM];                    // rad_normals' per-row scratch
  wg::Ring<RB_STAGES> ring;
};
static_assert(sizeof(RadFwdSmem) <= 232448, "a CTA's shared memory is 227 KB");

}  // namespace

// off[l]: the element offset in Wb of W_l's packed B operand (l < H)
struct RadFwdWb {
  int off[MK_MAX_LAYERS];
};

// The bf16 forward kernel's body (RB_THREADS threads, sizeof(RadFwdSmem)
// bytes of dynamic shared memory, persistent CTAs over 64-row tiles): per
// tile, K3's normals (in.norm_seg >= 0: normalised from g, stored to
// nrm_out), h0 (rb_build_h0), the hidden layers (rb_forward), then the top
// layer on the CUDA cores in gemm_narrow's order, a warp per row, lane i
// summing k = i, i + 32, ..., then the xor tree; + the float32 bias.
__device__ __forceinline__ void rb_trunk_forward(const RadIn& in, int N, const MlpDesc& d,
                                                 const float* __restrict__ P,
                                                 const __nv_bfloat16* __restrict__ Wb,
                                                 const RadFwdWb& wb, float* __restrict__ rgb_out,
                                                 float* __restrict__ nrm_out,
                                                 unsigned char* smem_raw) {
  RadFwdSmem& sm = *reinterpret_cast<RadFwdSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = d.n_layers, H = L - 1;
  const int n_out = d.nout[H], ktop = d.kin[H];
  const int n_tiles = (N + TILE_M - 1) / TILE_M;
  if (tid == 0) sm.ring.init(RB_CONSUMER_WARPS);
  for (int i = tid; i < H * 256; i += RB_THREADS) {
    const int l = i / 256, c = i % 256;
    sm.bias[l][c] = c < d.nout[l] ? rnd<true>(P[d.boff[l] + c]) : 0.0f;
  }
  for (int i = tid; i < 256 * 4; i += RB_THREADS) {
    const int kk = i / 4, j = i % 4;
    sm.wt[i] = kk < ktop && j < n_out ? rnd<true>(P[d.woff[H] + kk * n_out + j]) : 0.0f;
  }
  __syncthreads();

  if (warp == RB_CONSUMER_WARPS) {
    // the producer: every hidden layer's W_l of every tile, in order
    if (lane != 0) return;
    uint32_t k = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      for (int l = 0; l < H; ++l) {
        const int nch = (round_up(d.kin[l], 16) + RB_KC - 1) / RB_KC;
        for (int j = 0; j < nch; ++j, ++k)
          sm.ring.produce(k, sm.w[k % RB_STAGES], Wb + wb.off[l] + (size_t)j * RB_CHUNK,
                          RB_CHUNK * sizeof(__nv_bfloat16));
      }
    return;
  }

  const int g = warp >> 2, t = tid & 127;
  RbStream st{sm.w, &sm.ring, 0};
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    wg::bar(1, RB_CONSUMERS);  // the previous tile is done with shared memory
    if (in.norm_seg >= 0) {
      rad_normals(in, N, row0, sm.nr);
      wg::bar(1, RB_CONSUMERS);
      if (tid < TILE_M && row0 + tid < N) {
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) nrm_out[(size_t)(row0 + tid) * 3 + kk] = sm.nr[tid * NRM + kk];
      }
    }
    rb_build_h0(sm.h, in, sm.nr, N, row0);
    wg::fence_async_smem();
    wg::bar(1, RB_CONSUMERS);
    const __nv_bfloat16* top =
        rb_forward(st, sm.h, d, &sm.bias[0][0], sm.y, g, lane, t, [](int, const __nv_bfloat16*) {});

    for (int r = warp; r < TILE_M; r += RB_CONSUMER_WARPS) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int kk = lane; kk < ktop; kk += 32) {
        const float a = __bfloat162float(top[wg::core_offset(r, kk, TILE_M)]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n_out) s[j] = fmaf(a, sm.wt[4 * kk + j], s[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      }
      if (lane == 0 && row0 + r < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n_out) rgb_out[(size_t)(row0 + r) * n_out + j] = s[j] + P[d.boff[H] + j];
      }
    }
  }
}

// Launch kernel (a __global__ wrapper of rb_trunk_forward) on min(ctas,
// tiles) CTAs; wb_off[l]: W_l's offset in Wb.
template <class Kernel>
inline int rb_trunk_forward_launch(Kernel kernel, const RadIn& in, int N, const int* desc,
                                   const float* P, const void* Wb, const int* wb_off,
                                   float* rgb_out, float* nrm_out, int ctas, void* stream) {
  const MlpDesc d = desc_from(desc);
  RadFwdWb wb;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) wb.off[l] = wb_off[l];
  const size_t smem = sizeof(RadFwdSmem);
  const int n_tiles = (N + TILE_M - 1) / TILE_M;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<ctas < n_tiles ? ctas : n_tiles, RB_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      in, N, d, P, static_cast<const __nv_bfloat16*>(Wb), wb, rgb_out, nrm_out);
  return static_cast<int>(cudaGetLastError());
}
