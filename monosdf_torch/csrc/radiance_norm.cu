// K3 forward: the radiance trunk with in-kernel normal normalisation and
// the per-image code operand.
//
// Replaces monosdf_tpu/ops/pallas_rgb_grad.py _radiance_norm_fwd_pallas
// (pl.pallas_call at :708), the forward of radiance_norm. Per sample: it
// normalises the SDF gradient, n = g / (sqrt(max(|g|^2, 1e-24)) + 1e-6),
// writes n out, and runs the ReLU trunk over the first-layer input [points,
// view PE, n, features, code] (W0's natural row order; the code when given)
// without it leaving shared memory. g and the code are float32, the rest at
// the operand type; with BF16 every operand is rounded to bf16 at the
// product and each hidden pre-activation before the bias add and the ReLU,
// as in the TPU kernel. The last layer (3 outputs) stays float32: the
// sigmoid is applied outside.
//
// Bound on the card: operations (about 3.0e10 FLOP per 100,352-sample
// chunk with a 32-wide code, against ~62 MB of operands and outputs).
//
// bf16: the tensor cores (radiance_norm_kernel_tc): the normalisation as
// rad_normals computes it, then K3b's pass-1 forward (radiance_tc.cuh: h0
// built at bf16 in wgmma's layout, the hidden layers on wgmma with a fresh
// float32 sum per 64-deep weight stage, the weights packed once per call by
// kernels/radiance_norm.py pack_fwd and streamed through a ring of bulk
// copies), and the top layer (256 x 3) on the CUDA cores in gemm_narrow's
// order (a warp per row, lanes strided over k, a shuffle tree) with the
// bias added as rad_forward adds it. float32: the SIMT trunk of
// radiance.cuh (rad_forward), float32 FMAs on the CUDA cores, one 64-row
// tile per block (TF32 would miss the float32 bars).
#include "radiance.cuh"

using namespace mk;

#include "radiance_tc.cuh"

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

// K3's segments: [sv | n (normalised from g) | feat | code (when C > 0)]
static RadIn k3_input(const float* g, const void* sv, int ds, const void* feat, int F,
                      const float* code, int C) {
  RadIn in{};
  in.seg[0] = {sv, ds, 0};
  in.seg[1] = {g, 3, 1};
  in.seg[2] = {feat, F, 0};
  in.seg[3] = {code, C, 1};
  in.nseg = C > 0 ? 4 : 3;
  in.d0 = ds + 3 + F + C;
  in.norm_seg = 1;
  return in;
}

__global__ void __launch_bounds__(THREADS)
radiance_norm_kernel(const __grid_constant__ RadIn in, int N, const __grid_constant__ MlpDesc d,
                     const float* __restrict__ P, float* __restrict__ rgb_out,
                     float* __restrict__ nrm_out) {
  extern __shared__ __align__(16) float smem[];
  rad_forward<false>(in, N, d, P, rgb_out, nrm_out, smem);
}

// wb_off[l]: the element offset in Wb of W_l's packed B operand (l < H)
struct RadFwdWb {
  int off[MK_MAX_LAYERS];
};

__global__ void __launch_bounds__(RB_THREADS, 1)
radiance_norm_kernel_tc(const __grid_constant__ RadIn in, int N,
                        const __grid_constant__ MlpDesc d, const float* __restrict__ P,
                        const __nv_bfloat16* __restrict__ Wb, const __grid_constant__ RadFwdWb wb,
                        float* __restrict__ rgb_out, float* __restrict__ nrm_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
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
    rad_normals(in, N, row0, sm.nr);
    wg::bar(1, RB_CONSUMERS);
    if (tid < TILE_M && row0 + tid < N) {
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) nrm_out[(size_t)(row0 + tid) * 3 + kk] = sm.nr[tid * NRM + kk];
    }
    rb_build_h0(sm.h, in, sm.nr, N, row0);
    wg::fence_async_smem();
    wg::bar(1, RB_CONSUMERS);
    const __nv_bfloat16* top =
        rb_forward(st, sm.h, d, &sm.bias[0][0], sm.y, g, lane, t, [](int, const __nv_bfloat16*) {});

    // the top layer in gemm_narrow's order: a warp per row, lane i summing
    // k = i, i + 32, ..., then the xor tree; + the float32 bias
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

// float32: the SIMT kernel, one 64-row tile per block
extern "C" int radiance_norm_launch(const float* g, const void* sv, int ds, const void* feat,
                                    int F, const float* code, int C, int N, const int* desc,
                                    const float* P, float* rgb_out, float* nrm_out,
                                    void* stream) {
  const MlpDesc d = desc_from(desc);
  const RadIn in = k3_input(g, sv, ds, feat, F, code, C);
  const size_t smem = RAD_SMEM_FLOATS * sizeof(float);
  const dim3 grid((N + TILE_M - 1) / TILE_M);
  cudaFuncSetAttribute(radiance_norm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  radiance_norm_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      in, N, d, P, rgb_out, nrm_out);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores: Wb the packed B operands (wb_off by layer), on
// `ctas` persistent CTAs.
extern "C" int radiance_norm_tc_launch(const float* g, const void* sv, int ds, const void* feat,
                                       int F, const float* code, int C, int N, const int* desc,
                                       const float* P, const void* Wb, const int* wb_off,
                                       float* rgb_out, float* nrm_out, int ctas, void* stream) {
  const MlpDesc d = desc_from(desc);
  const RadIn in = k3_input(g, sv, ds, feat, F, code, C);
  RadFwdWb wb;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) wb.off[l] = wb_off[l];
  const size_t smem = sizeof(RadFwdSmem);
  const int n_tiles = (N + TILE_M - 1) / TILE_M;
  cudaFuncSetAttribute(radiance_norm_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  radiance_norm_kernel_tc<<<ctas < n_tiles ? ctas : n_tiles, RB_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      in, N, d, P, static_cast<const __nv_bfloat16*>(Wb), wb, rgb_out, nrm_out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
