// K1: the SDF MLP forward of the sampler's no-grad sweeps, and K1-PE, the
// same kernel on raw points.
//
// Replaces monosdf_tpu/ops/pallas_mlp.py fused_sdf_mlp (pl.pallas_call at
// :310), K1-PE its multires form (kernel_pe :140 with pe_consts :51). Input:
// the layer-0 input (N, d0), float32 or bfloat16 (BF16), or with multires >=
// 0 raw points (N, 3) float32 whose embedding [x, sin(2^f x), cos(2^f x),
// ...] the kernel computes in float32 (sinf / cosf: pe_value) and rounds to
// the operand type before layer 0, as kernel_pe does. Every hidden layer is
// softplus(beta=100) of W h + b; a skip layer first concatenates the layer-0
// input and divides by sqrt(2); the last layer is linear and narrow (the
// sweeps read the SDF column only). With BF16 the matmul operands are
// rounded to bf16 (sums in float32) and the output is rounded to bf16, as
// the TPU kernel emits it.
//
// Bound on the card: operations. One sweep of 131,072 points through the
// 8x256 MLP is about 1.3e11 FLOP against a few MB of input, so the tensor
// cores' rate bounds it (0.13 ms at 989 TFLOP/s bf16).
//
// bf16 (the sweeps' path): the tensor cores. A persistent CTA per SM walks
// over 128-row tiles with two consumer warpgroups (64 rows each) and one
// producer warp. The activation tile is bf16 in shared memory in wgmma's
// operand layout (wgmma.cuh); each hidden layer is a chain of
// wgmma.m64n256k16 over its input width, sums in float32 registers. The
// weights come packed once per call as bf16 in the B-operand layout, 64
// input rows a chunk (kernels/sdf_mlp.py pack_wgmma_b), and stream through a
// ring of three 32 KB stages that the producer fills with bulk copies
// (cp.async.bulk on mbarriers); both warpgroups read each stage, so every
// weight byte fetched serves 128 rows. The bias + softplus epilogue runs on
// the accumulator registers and writes the next layer's input back as bf16
// (the rounding of the SIMT path's prep_input); the narrow last layer is a
// warp dot over shared memory.
//
// float32 (the check path) stays on the SIMT code below: float32 FMAs on the
// CUDA cores, a 64-row tile in shared memory and each layer's weights
// streamed 16 rows at a time. TF32 tensor cores would miss the float32 bars
// (1e-4 against the plain version, 2e-5 on renders).
#include "common.cuh"
#include "wgmma.cuh"

using namespace mk;

template <bool PE>
__global__ void __launch_bounds__(THREADS)
sdf_mlp_kernel(const void* __restrict__ x, int N, int d0, MlpDesc d,
               const float* __restrict__ P, float* __restrict__ out) {
  constexpr bool BF16 = false;  // float32 only: bf16 takes sdf_mlp_kernel_tc
  extern __shared__ __align__(16) float smem[];
  float* X0 = smem;
  float* cur = X0 + TILE_M * LD0;
  float* nxt = cur + TILE_M * LDA;
  float* Ws = nxt + TILE_M * LDA;
  float* Zn = Ws + KT * TILE_N;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int row0 = blockIdx.x * TILE_M;

  for (int idx = tid; idx < TILE_M * LD0; idx += THREADS) {
    const int r = idx / LD0, c = idx - r * LD0;
    float v = 0.0f;
    if (row0 + r < N) {
      if constexpr (PE) {
        v = pe_value(static_cast<const float*>(x) + (size_t)(row0 + r) * 3, c, d0);
      } else if (c < d0) {
        v = load_act<BF16>(x, (size_t)(row0 + r) * d0 + c);
      }
    }
    X0[idx] = v;
  }
  __syncthreads();
  prep_first<BF16>(cur, X0, d0, TILE_M);

  int width = d0;
  const int L = d.n_layers;
  for (int l = 0; l < L; ++l) {
    if (l > 0) prep_input<BF16>(cur, width, X0, d0, d.skip[l] != 0, TILE_M);
    __syncthreads();
    const int K = d.kin[l], nout = d.nout[l];
    const float* W = P + d.woff[l];
    const float* bias = P + d.boff[l];
    if (l < L - 1) {
      float acc[8][8];
      gemm_tile<BF16>(cur, LDA, K, W, nout, 0, nout, Ws, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(tx, j);
        if (c < nout) {
          const float bc = bias[c];
#pragma unroll
          for (int i = 0; i < 8; ++i) nxt[(ty * 8 + i) * LDA + c] = softplus100(acc[i][j] + bc);
        }
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
      width = nout;
    } else {
      gemm_narrow<BF16>(cur, LDA, K, W, nout, 0, nout, TILE_M, Zn);
      __syncthreads();
      for (int idx = tid; idx < TILE_M * nout; idx += THREADS) {
        const int r = idx / nout, j = idx - r * nout;
        if (row0 + r < N) out[(size_t)(row0 + r) * nout + j] = rnd<BF16>(Zn[r * 4 + j] + bias[j]);
      }
    }
  }
}

// -- bf16: the tensor-core kernel -------------------------------------------

namespace {

constexpr int TC_ROWS = 128;                // rows per tile: two warpgroups of 64
constexpr int TC_KC = 64;                   // weight rows (input units) per ring stage
constexpr int TC_STAGES = 3;
constexpr int TC_KMAX = 320;                // activation tile width: inputs up to 304, padded
constexpr int TC_CHUNK = TC_KC * 256;       // bf16 elements per stage (256 output columns)
constexpr int TC_THREADS = 288;             // 2 consumer warpgroups + 1 producer warp
constexpr int TC_CONSUMER_WARPS = 8;

struct TcSmem {
  __nv_bfloat16 w[TC_STAGES][TC_CHUNK];     // the weight ring, B-operand layout
  __nv_bfloat16 a[TC_ROWS * TC_KMAX];       // the activation tile, A-operand layout (R = 128)
  float x0[TC_ROWS * LD0];                  // the layer-0 input, float32
  float bias[2][256];                       // each warpgroup's copy of the layer's bias
  wg::Ring<TC_STAGES> ring;
};

// byte distances of the operand layouts (wgmma.cuh core_offset)
constexpr uint32_t A_LBO = (TC_ROWS / 8) * 128;  // next 8 columns of the activation tile
constexpr uint32_t B_LBO = (256 / 8) * 128;      // next 8 input rows of a weight stage
constexpr uint32_t CORE_SBO = 128;               // next 8 rows (A) or output columns (B)

__device__ __forceinline__ void put_a(__nv_bfloat16* a, int r, int c, float v) {
  a[wg::core_offset(r, c, TC_ROWS)] = __float2bfloat16_rn(v);
}

}  // namespace

// Per hidden layer l: wb_off[l] is the element offset of its packed weights
// in Wb, its chunks (TC_KC input rows each, zero-padded) following in order.
struct WbDesc {
  int off[MK_MAX_LAYERS];
};

template <bool PE>
__global__ void __launch_bounds__(TC_THREADS, 1)
sdf_mlp_kernel_tc(const void* __restrict__ x, int N, int d0, MlpDesc d,
                  const float* __restrict__ P, const __nv_bfloat16* __restrict__ Wb, WbDesc wb,
                  float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  TcSmem& sm = *reinterpret_cast<TcSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = d.n_layers;
  const int n_tiles = (N + TC_ROWS - 1) / TC_ROWS;
  if (tid == 0) sm.ring.init(TC_CONSUMER_WARPS);
  __syncthreads();

  if (warp == TC_CONSUMER_WARPS) {
    // the producer: every chunk of every hidden layer of every tile, in the
    // consumers' order
    if (lane != 0) return;
    uint32_t k = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      for (int l = 0; l < L - 1; ++l) {
        const int nch = (round_up(d.kin[l], 16) + TC_KC - 1) / TC_KC;
        for (int j = 0; j < nch; ++j, ++k)
          sm.ring.produce(k, sm.w[k % TC_STAGES], Wb + wb.off[l] + (size_t)j * TC_CHUNK,
                          TC_CHUNK * sizeof(__nv_bfloat16));
      }
    return;
  }

  // the consumers: warpgroup g owns rows [64 g, 64 g + 64) of each tile
  const int g = warp >> 2, t = tid & 127, r0 = 64 * g;
  const int bar_id = 1 + g;
  uint32_t k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TC_ROWS;
    wg::bar(bar_id, 128);  // the previous tile's last layer has read the activations
    const int Kp0 = round_up(d0, 16);
    for (int idx = t; idx < 64 * LD0; idx += 128) {
      const int r = r0 + idx / LD0, c = idx % LD0;
      float v = 0.0f;
      if (row0 + r < N) {
        if constexpr (PE) {
          v = pe_value(static_cast<const float*>(x) + (size_t)(row0 + r) * 3, c, d0);
        } else if (c < d0) {
          v = __bfloat162float(static_cast<const __nv_bfloat16*>(x)[(size_t)(row0 + r) * d0 + c]);
        }
      }
      sm.x0[r * LD0 + c] = v;
      if (c < Kp0) put_a(sm.a, r, c, v);
    }
    wg::fence_async_smem();
    wg::bar(bar_id, 128);

    for (int l = 0; l < L - 1; ++l) {
      const int nslab = round_up(d.kin[l], 16) / 16;
      const int nch = (nslab * 16 + TC_KC - 1) / TC_KC;
      const int nout = d.nout[l];
      for (int c = t; c < 256; c += 128) sm.bias[g][c] = c < nout ? P[d.boff[l] + c] : 0.0f;
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      wg::fence();
      for (int j = 0; j < nch; ++j, ++k) {
        sm.ring.acquire(k);
        const __nv_bfloat16* w = sm.w[k % TC_STAGES];
#pragma unroll
        for (int s = 0; s < TC_KC / 16; ++s) {
          const int slab = j * (TC_KC / 16) + s;
          if (slab < nslab) {
            const uint64_t da = wg::desc(sm.a + wg::core_offset(r0, 16 * slab, TC_ROWS), A_LBO, CORE_SBO);
            const uint64_t db = wg::desc(w + s * 16 * 256, B_LBO, CORE_SBO);
            wg::wgmma_m64n256k16<0, 0>(acc, da, db, slab > 0 ? 1 : 0);
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
      wg::bar(bar_id, 128);  // every warp's products have read the activations

      // epilogue: softplus(acc + b) -> the next layer's input, in place
      const bool skip = d.skip[l + 1] != 0;
#pragma unroll
      for (int i = 0; i < 128; i += 2) {
        const int r = r0 + wg::frag_row(t, i), c = wg::frag_col(t, i);
        const float2 b2 = *reinterpret_cast<const float2*>(&sm.bias[g][c]);
        const float bb[2] = {b2.x, b2.y};
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ce = c + e;
          if (ce < nout) {
            const float z = acc[i + e] + bb[e];
            // fast exp/log: the result is rounded to bf16 next
            v[e] = z > 0.2f ? z : __logf(1.0f + __expf(100.0f * z)) * 0.01f;
          } else if (skip && ce < nout + d0) {
            v[e] = sm.x0[r * LD0 + ce - nout];
          } else {
            v[e] = 0.0f;
          }
          if (skip) v[e] = v[e] / SQRT2;
        }
        *reinterpret_cast<__nv_bfloat162*>(&sm.a[wg::core_offset(r, c, TC_ROWS)]) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
      if (skip) {  // the embedding's columns past 256 and the zero pad
        const int Kp = round_up(nout + d0, 16);
        for (int idx = t; idx < 64 * (Kp - 256); idx += 128) {
          const int r = r0 + idx / (Kp - 256), c = 256 + idx % (Kp - 256);
          put_a(sm.a, r, c, c < nout + d0 ? sm.x0[r * LD0 + c - nout] / SQRT2 : 0.0f);
        }
      }
      wg::fence_async_smem();
      wg::bar(bar_id, 128);
    }

    // the narrow last layer: each warp 16 rows, lanes over the input
    const int l = L - 1, K = d.kin[l], nout = d.nout[l];
    const float* W = P + d.woff[l];
    const float* bias = P + d.boff[l];
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + 16 * (warp & 3) + rr;
      for (int j = 0; j < nout; ++j) {
        float s = 0.0f;
        for (int c = lane; c < K; c += 32)
          s = fmaf(__bfloat162float(sm.a[wg::core_offset(r, c, TC_ROWS)]),
                   rnd<true>(W[(size_t)c * nout + j]), s);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0 && row0 + r < N) out[(size_t)(row0 + r) * nout + j] = rnd<true>(s + bias[j]);
      }
    }
  }
}

template <bool PE>
static int launch_simt(const void* x, int N, int d0, const MlpDesc& d, const float* P, float* out,
                       cudaStream_t s) {
  const size_t smem = MLP_SMEM_FLOATS * sizeof(float);
  const dim3 grid((N + TILE_M - 1) / TILE_M);
  cudaFuncSetAttribute(sdf_mlp_kernel<PE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sdf_mlp_kernel<PE><<<grid, THREADS, smem, s>>>(x, N, d0, d, P, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool PE>
static int launch_tc(const void* x, int N, int d0, const MlpDesc& d, const float* P,
                     const __nv_bfloat16* Wb, const int* wb_off, float* out, int ctas,
                     cudaStream_t s) {
  WbDesc wb;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) wb.off[l] = wb_off[l];
  const size_t smem = sizeof(TcSmem);
  cudaFuncSetAttribute(sdf_mlp_kernel_tc<PE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int n_tiles = (N + TC_ROWS - 1) / TC_ROWS;
  sdf_mlp_kernel_tc<PE><<<ctas < n_tiles ? ctas : n_tiles, TC_THREADS, smem, s>>>(
      x, N, d0, d, P, Wb, wb, out);
  return static_cast<int>(cudaGetLastError());
}

// multires < 0: x is the (N, d0) layer-0 input; else raw (N, 3) points and
// d0 = 3 (1 + 2 multires). bf16 takes the tensor-core kernel with Wb (the
// packed bf16 weights, wb_off their per-layer offsets) on `ctas` persistent
// CTAs; float32 the SIMT kernel.
extern "C" int sdf_mlp_launch(const void* x, int N, int d0, int multires, const int* desc,
                              const float* P, const void* Wb, const int* wb_off, float* out,
                              int bf16, int ctas, void* stream) {
  const MlpDesc d = desc_from(desc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pe = multires >= 0;
  if (bf16) {
    const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(Wb);
    return pe ? launch_tc<true>(x, N, d0, d, P, w, wb_off, out, ctas, s)
              : launch_tc<false>(x, N, d0, d, P, w, wb_off, out, ctas, s);
  }
  return pe ? launch_simt<true>(x, N, d0, d, P, out, s) : launch_simt<false>(x, N, d0, d, P, out, s);
}

MK_ERROR_STRING_EXPORT
