// K2f: SDF, features and the spatial gradient of the SDF MLP.
//
// Replaces monosdf_tpu/ops/pallas_sdf_grad.py _fwd_pallas (pl.pallas_call at
// :414), the forward of sdf_mlp_with_grad. A tile's points come as raw xyz;
// their positional embedding and its three basis tangents are computed
// in-kernel in float32 (pe_value), as TPU kernel_pe does, and rounded to the
// operand type at each product. The primal rows and the tangent rows run
// through the MLP together: between layers h = softplus_100(z) on the primal
// rows (bias only there), t = sigmoid(100 z) * u on the tangent rows; a skip
// layer concatenates the embedding and its tangents and divides by sqrt 2.
// The last layer gives the SDF column for all rows (its tangents are the
// gradient) and the feature columns for the primal rows. The bounding-sphere
// clamp runs in-kernel: take = sdf <= s*(R - |x|), else sdf = s*(R - |x|),
// grad = -s x/|x|; points at or after clamp_rows (when >= 0, the folded
// eikonal batch) keep the MLP's values. With bf16 the operands and the stored
// activations are rounded to bf16 and the features are written as bf16, as
// in the TPU kernel.
//
// Training outputs (null pointers skip them): flag, 1.0 where the MLP's
// value was kept; and z.p[l], each hidden layer's pre-activation Z at the
// operand type, laid out (4, N, nout_l): the primal row (bias added), then
// the tangent rows along x, y, z (K2b reads this layout).
//
// Bound on the card: operations for the render chunk (about 4.2e11 FLOP per
// 100,352 points, 0.39 ms at 989 TFLOP/s bf16, against ~50 MB moved); bytes
// for the training variant at the step's 104,448 points (~1.7 GB of bf16 Z
// written, 0.52 ms at 3.35 TB/s).
//
// bf16 training variant (Z written): the tensor cores, the body of
// sdf_grad_tc.cuh (shared with K7f, sdf_grad_grid.cu), whose comment gives
// its design.
//
// bf16 render chunk (no Z): sdf_grad_kernel_fma below, on the CUDA cores.
// The renders are held to the plain version at fixed samples (bf16 normals
// 1e-2), and through s = sigmoid(100 z) the tangent rows turn the float32
// differences of any other summation order into gradient differences 100x
// larger: the tensor-core kernel's renders of the appearance-code model (no
// SDF clamp) missed that bar (normals 1.4e-2 and 2.4e-2, PERF.md). So the
// chunk's kernel keeps every FMA chain of the SIMT kernel below, in its
// order, and gives its outputs bit for bit; its comment gives its design.
//
// The SIMT kernel (sdf_grad_kernel): float32, where it is the kernel (TF32
// tensor cores would miss the float32 bars: 1e-4 against the plain version,
// 2e-5 on renders), and at bf16 the order reference of the chunk's kernel,
// which only the card tests and chip_smoke.py launch
// (kernels/sdf_grad.py sdf_mlp_with_grad_simt). One 256-thread block per 16
// points (64 stacked rows), each layer's weights streamed 16 rows at a
// time; its FMA chains run over the inputs in order, as the plain version's
// float32 product does, so its bf16 roundings land where the plain
// version's do.
#include "common.cuh"

using namespace mk;

#include "sdf_grad_tc.cuh"

// Point o's outputs from the MLP's SDF (bias added) and gradient: the
// bounding-sphere clamp (take = sdf <= s*(R - |x|), else the sphere's SDF and
// gradient; points at or after clamp_rows, when >= 0, keep the MLP's), then
// sdf, grad and the flag (when given). Shared by the SIMT kernel and the
// render chunk's kernel, so both compute it with the same instructions.
__device__ __forceinline__ void point_out(int o, float sdf, const float (&gm)[3], const float* xp,
                                          float bounding_sphere, float sphere_scale,
                                          int clamp_rows, float* __restrict__ sdf_out,
                                          float* __restrict__ grad_out,
                                          float* __restrict__ flag_out) {
  float g[3] = {gm[0], gm[1], gm[2]};
  bool take = true;
  if (bounding_sphere > 0.0f) {
    const float x0 = xp[0], x1 = xp[1], x2 = xp[2];
    const float norm = sqrtf(x0 * x0 + x1 * x1 + x2 * x2);
    const float sphere = sphere_scale * (bounding_sphere - norm);
    take = sdf <= sphere || (clamp_rows >= 0 && o >= clamp_rows);
    if (!take) {
      sdf = sphere;
      const float q = -sphere_scale / fmaxf(norm, 1e-12f);
      g[0] = x0 * q;
      g[1] = x1 * q;
      g[2] = x2 * q;
    }
  }
  sdf_out[o] = sdf;
  grad_out[(size_t)o * 3 + 0] = g[0];
  grad_out[(size_t)o * 3 + 1] = g[1];
  grad_out[(size_t)o * 3 + 2] = g[2];
  if (flag_out != nullptr) flag_out[o] = take ? 1.0f : 0.0f;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
sdf_grad_kernel(const float* __restrict__ x, int N, int multires, MlpDesc d,
                const float* __restrict__ P, float bounding_sphere, float sphere_scale,
                int clamp_rows, float* __restrict__ sdf_out, void* __restrict__ feat_out,
                float* __restrict__ grad_out, float* __restrict__ flag_out,
                const __grid_constant__ ZPtrs z) {
  extern __shared__ __align__(16) float smem[];
  float* X0 = smem;
  float* cur = X0 + TILE_M * LD0;
  float* nxt = cur + TILE_M * LDA;
  float* Ws = nxt + TILE_M * LDA;
  float* Zn = Ws + KT * TILE_N;
  __shared__ float xs[PTS][3];
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int p0 = blockIdx.x * PTS;
  const int d0 = 3 * (1 + 2 * multires);

  load_pe_tile(x, N, p0, multires, xs, X0);
  __syncthreads();
  prep_first<BF16>(cur, X0, d0, TILE_M);

  int width = d0;
  const int L = d.n_layers;
  for (int l = 0; l < L - 1; ++l) {
    if (l > 0) prep_input<BF16>(cur, width, X0, d0, d.skip[l] != 0, TILE_M);
    __syncthreads();
    const int K = d.kin[l], nout = d.nout[l];
    const float* bias = P + d.boff[l];
    float acc[8][8];
    gemm_tile<BF16>(cur, LDA, K, P + d.woff[l], nout, 0, nout, Ws, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(tx, j);
      if (c < nout) {
        const float bc = bias[c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = ty * 8 + i;
          nxt[r * LDA + c] = r < PTS ? acc[i][j] + bc : acc[i][j];
        }
      }
    }
    __syncthreads();
    void* zl = z.p[l];
    for (int idx = tid; idx < PTS * nout; idx += THREADS) {
      const int p = idx / nout, c = idx - p * nout;
      if (zl != nullptr && p0 + p < N) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          store_act<BF16>(zl, ((size_t)k * N + p0 + p) * nout + c, nxt[(k * PTS + p) * LDA + c]);
      }
      float h, s;
      gate100(nxt[p * LDA + c], h, s);
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        float* tk = &nxt[(k * PTS + p) * LDA + c];
        *tk = rnd<BF16>(s * *tk);
      }
      nxt[p * LDA + c] = rnd<BF16>(h);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    width = nout;
  }

  // last layer: SDF column for all rows, feature columns for the primal rows
  prep_input<BF16>(cur, width, X0, d0, d.skip[L - 1] != 0, TILE_M);
  __syncthreads();
  const int K = d.kin[L - 1], nout = d.nout[L - 1], F = nout - 1;
  const float* W = P + d.woff[L - 1];
  const float* bias = P + d.boff[L - 1];
  gemm_narrow<BF16>(cur, LDA, K, W, nout, 0, 1, TILE_M, Zn);
  float acc[8][8];
  gemm_tile<BF16>(cur, LDA, K, W, nout, 1, F, Ws, acc);
  if (ty * 8 < PTS) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(tx, j);
      if (c < F) {
        const float bc = bias[1 + c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int p = ty * 8 + i;
          if (p < PTS && p0 + p < N) store_act<BF16>(feat_out, (size_t)(p0 + p) * F + c, acc[i][j] + bc);
        }
      }
    }
  }
  __syncthreads();
  if (tid < PTS && p0 + tid < N) {
    const int p = tid;
    const float g[3] = {Zn[(PTS + p) * 4], Zn[(2 * PTS + p) * 4], Zn[(3 * PTS + p) * 4]};
    point_out(p0 + p, Zn[p * 4] + bias[0], g, xs[p], bounding_sphere, sphere_scale, clamp_rows,
              sdf_out, grad_out, flag_out);
  }
}

// bf16 training variant: the tensor-core body on the raw points
__global__ void __launch_bounds__(TF_THREADS, 1)
sdf_grad_kernel_tc(const float* __restrict__ x, int N, int multires, MlpDesc d,
                   const float* __restrict__ P, const __nv_bfloat16* __restrict__ Wb, FwdWb wb,
                   float bounding_sphere, float sphere_scale, int clamp_rows,
                   float* __restrict__ sdf_out, __nv_bfloat16* __restrict__ feat_out,
                   float* __restrict__ grad_out, float* __restrict__ flag_out,
                   const __grid_constant__ ZPtrs z) {
  sdf_grad_tc_body<false>(x, nullptr, N, 3 * (1 + 2 * multires), d, P, Wb, wb, bounding_sphere,
                          sphere_scale, clamp_rows, sdf_out, feat_out, grad_out, flag_out, z);
}

// ---- the bf16 render chunk: float32 FMAs on the CUDA cores ----------------
//
// Every output is the SIMT kernel's sum, computed with the same instructions
// in the same order: each hidden and feature output one fmaf chain over k =
// 0 .. K-1 from 0.0f in one thread (gemm_tile's), the bias added after it;
// the SDF column gemm_narrow's 32 lane-strided chains and xor tree (one
// thread holds a row's 32 chains); the embedding from pe_value, the gate from
// gate100, the clamp from point_out. So its outputs equal the SIMT kernel's
// bit for bit, and the renders keep the plain version's bf16 roundings. What
// changes is where the operands live:
// - a persistent CTA per SM walks 32-point tiles: 128 rows, point p's
//   primal row 4p and its three tangent rows 4p + 1 .. 3;
// - the activation tile stays in shared memory (k-major: element (k, r) at
//   k * 128 + r) and each layer's output goes back over its input in place
//   after one barrier. It holds the bf16-rounded values as float32 (128
//   KB): bf16 storage would halve it but cost a conversion instruction per
//   value in the inner loop, and on the H100 those cost more time than the
//   shared-memory loads they save;
// - the weights are rounded to bf16 once per call and packed as float32,
//   16 input rows x 256 columns a stage (kernels/sdf_grad.py pack_chunk);
//   they stream through a 4-deep mbarrier ring of bulk copies that thread 0
//   refills a stage behind the slowest warp, so no CTA-wide barrier is paid
//   per stage, and a weight byte serves 32 points;
// - each of 256 threads (8 warps: 255 registers a thread) holds 16 rows
//   (four points, all four rows of each) x 8 columns of float32 sums: a k
//   step is four float4 activation loads, two float4 weight loads and 128
//   FMAs, and the gate runs on the registers (a point's primal and tangent
//   sums sit in one thread);
// - the last layer's feature columns are summed for the primal rows only.
// The bound is the CUDA cores' float32 FMA rate (~3.8e11 FLOP a 100,352-
// point chunk, 5.7 ms at 67 TFLOP/s); the shared-memory loads (0.75 byte an
// FMA) take about as long again, and the tensor cores would sum in another
// order (PERF.md).

namespace {

constexpr int FC_PTS = 32;                  // points per tile
constexpr int FC_ROWS = 4 * FC_PTS;         // rows per tile
constexpr int FC_KT = KT;                   // weight rows per ring stage
constexpr int FC_STAGES = 4;
constexpr int FC_KMAX = 256;                // layer inputs up to 256
constexpr int FC_THREADS = 256;
constexpr int FC_WARPS = FC_THREADS / 32;
constexpr int FC_STAGE = FC_KT * 256;       // floats of a ring stage
constexpr int FC_TP = 4;                    // points a thread sums
constexpr int FC_TR = 4 * FC_TP;            // rows a thread sums
constexpr int FC_TC = 8;                    // columns a thread sums
constexpr int FC_RB = FC_ROWS / (4 * FC_TR);  // warps along the rows (2), along the columns 4

struct ChunkSmem {
  float w[FC_STAGES][FC_STAGE];             // the weight ring
  float a[FC_KMAX * FC_ROWS];               // the activation tile, k-major
  __nv_bfloat16 x0s[LD0 * FC_ROWS];         // the embedding rows / sqrt 2, rounded, k-major
  float w0[FC_KMAX];                        // the last layer's SDF column, bf16-rounded
  float zn[FC_ROWS];                        // each row's SDF column
  float xs[FC_PTS][3];
  wg::Ring<FC_STAGES> ring;
};
static_assert(sizeof(ChunkSmem) <= 232448, "a CTA's shared memory is 227 KB");

// The CTA's weight stages in ring order (for each of its tiles, every
// layer's), issued by thread 0: `next` the next use to fill, of `total`;
// l, j its layer and stage there.
struct FcFeed {
  uint32_t next, total;
  int l, j;
};

// Thread 0: fill the ring's next use, once its stage's previous use has
// been released by every warp (Ring::produce waits for that).
__device__ __forceinline__ void fc_feed(FcFeed& f, ChunkSmem& sm, const float* Wc, const int* off,
                                        const MlpDesc& d) {
  if (f.next >= f.total) return;
  sm.ring.produce(f.next, sm.w[f.next % FC_STAGES], Wc + off[f.l] + (size_t)f.j * FC_STAGE,
                  FC_STAGE * sizeof(float));
  ++f.next;
  if (++f.j == round_up(d.kin[f.l], FC_KT) / FC_KT) {
    f.j = 0;
    if (++f.l == d.n_layers) f.l = 0;
  }
}

// column j (< FC_TC) of the thread whose first column is c0: two groups of
// 4, 32 apart
__device__ __forceinline__ int fc_col(int c0, int j) { return c0 + (j >> 2) * 32 + (j & 3); }

// One ring stage (FC_KT input rows) into acc: a points at (k0, r0) of the
// activation tile, w at column c0 of the stage. PRIMAL: the thread's primal
// rows (r0 + 4 p) only.
template <bool PRIMAL>
__device__ __forceinline__ void fc_stage(const float* __restrict__ a, const float* __restrict__ w,
                                         float (&acc)[PRIMAL ? FC_TP : FC_TR][FC_TC]) {
  constexpr int R = PRIMAL ? FC_TP : FC_TR;
#pragma unroll
  for (int kk = 0; kk < FC_KT; ++kk) {
    float av[R];
#pragma unroll
    for (int h = 0; h < FC_TP; ++h) {
      if constexpr (PRIMAL) {
        av[h] = a[kk * FC_ROWS + 4 * h];
      } else {
        const float4 u = *reinterpret_cast<const float4*>(a + kk * FC_ROWS + 4 * h);
        av[4 * h] = u.x, av[4 * h + 1] = u.y, av[4 * h + 2] = u.z, av[4 * h + 3] = u.w;
      }
    }
    float wv[FC_TC];
#pragma unroll
    for (int q = 0; q < FC_TC / 4; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(w + kk * 256 + 32 * q);
      wv[4 * q] = u.x, wv[4 * q + 1] = u.y, wv[4 * q + 2] = u.z, wv[4 * q + 3] = u.w;
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < FC_TC; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
  }
}

}  // namespace

// wc.off[l]: the float offset in Wc of layer l's packed stages (l = L - 1:
// the feature columns); wc.off[L]: the SDF column.
__global__ void __launch_bounds__(FC_THREADS, 1)
sdf_grad_kernel_fma(const float* __restrict__ x, int N, int multires,
                    const __grid_constant__ MlpDesc d, const float* __restrict__ P,
                    const float* __restrict__ Wc, const __grid_constant__ FwdWb wc,
                    float bounding_sphere, float sphere_scale, int clamp_rows,
                    float* __restrict__ sdf_out, __nv_bfloat16* __restrict__ feat_out,
                    float* __restrict__ grad_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = d.n_layers;
  const int d0 = 3 * (1 + 2 * multires), kp0 = round_up(d0, FC_KT);
  const int kl = d.kin[L - 1], F = d.nout[L - 1] - 1;
  const int n_tiles = (N + FC_PTS - 1) / FC_PTS;
  if (tid == 0) sm.ring.init(FC_WARPS);
  for (int k = tid; k < kl; k += FC_THREADS) sm.w0[k] = Wc[wc.off[L] + k];
  __syncthreads();
  // thread 0 fills the ring: its first FC_STAGES uses now, then the use
  // FC_STAGES ahead after each stage (no producer warp: with 8 warps, 2 on
  // each SM sub-partition, a thread may hold 255 registers)
  FcFeed feed{0, 0, 0, 0};
  if (tid == 0) {
    uint32_t per_tile = 0;
    for (int l = 0; l < L; ++l) per_tile += round_up(d.kin[l], FC_KT) / FC_KT;
    const int my_tiles = blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    feed.total = per_tile * my_tiles;
    for (int i = 0; i < FC_STAGES; ++i) fc_feed(feed, sm, Wc, wc.off, d);
  }

  // thread: rows r0 .. r0 + 15 (points r0 / 4 .. r0 / 4 + 3), columns
  // fc_col(c0, j); lanes 8 g .. 8 g + 7 share their rows and read 8
  // neighbouring float4s of a weight row, the lane groups g their rows'
  // float4s of an activation row
  const int r0 = (warp % FC_RB) * 4 * FC_TR + (lane >> 3) * FC_TR;
  const int c0 = (warp / FC_RB) * 8 * FC_TC + (lane & 7) * 4;
  bool any_skip = false;
  for (int l = 1; l < L; ++l) any_skip |= d.skip[l] != 0;
  uint32_t k = 0;  // the next use of the ring

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * FC_PTS;
    wg::bar(1, FC_THREADS);  // the previous tile is done with shared memory
    if (tid < FC_PTS * 3) {
      const int p = tid / 3, c = tid - p * 3;
      sm.xs[p][c] = p0 + p < N ? x[(size_t)(p0 + p) * 3 + c] : 0.0f;
    }
    wg::bar(1, FC_THREADS);
    // layer 0's input: the embedding and its tangents, rounded, zero in the
    // pad columns; divided by sqrt 2 and rounded for the skip layers
    for (int idx = tid; idx < FC_PTS * kp0; idx += FC_THREADS) {
      const int p = idx / kp0, c = idx - p * kp0;
      float t[3] = {0.0f, 0.0f, 0.0f};
      const float e = pe_value(sm.xs[p], c, d0, t);
      *reinterpret_cast<float4*>(&sm.a[c * FC_ROWS + 4 * p]) =
          make_float4(rnd<true>(e), rnd<true>(t[0]), rnd<true>(t[1]), rnd<true>(t[2]));
      if (any_skip && c < d0) {
        __nv_bfloat16* xs = &sm.x0s[c * FC_ROWS + 4 * p];
        xs[0] = __float2bfloat16_rn(e / SQRT2);
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) xs[1 + kk] = __float2bfloat16_rn(t[kk] / SQRT2);
      }
    }
    wg::bar(1, FC_THREADS);

    for (int l = 0; l < L - 1; ++l) {
      float acc[FC_TR][FC_TC];
#pragma unroll
      for (int i = 0; i < FC_TR; ++i)
#pragma unroll
        for (int j = 0; j < FC_TC; ++j) acc[i][j] = 0.0f;
      const int nst = round_up(d.kin[l], FC_KT) / FC_KT;
      for (int j = 0; j < nst; ++j, ++k) {
        sm.ring.acquire(k);
        fc_stage<false>(sm.a + j * FC_KT * FC_ROWS + r0, sm.w[k % FC_STAGES] + c0, acc);
        __syncwarp();
        if (lane == 0) sm.ring.release(k);
        if (tid == 0) fc_feed(feed, sm, Wc, wc.off, d);
      }
      wg::bar(1, FC_THREADS);  // every warp has read the layer's input

      // the output over the input, in place: h = softplus_100(z) on the
      // primal rows (bias added), t = sigmoid(100 z) u on the tangent rows,
      // rounded; / sqrt 2 and rounded again before a skip layer
      const int nout = d.nout[l];
      const bool skip = d.skip[l + 1] != 0;
      const float* bias = P + d.boff[l];
#pragma unroll
      for (int j = 0; j < FC_TC; ++j) {
        const int c = fc_col(c0, j);
        if (c < nout) {
          const float bc = __ldg(bias + c);
#pragma unroll
          for (int pi = 0; pi < FC_TP; ++pi) {
            float h, s;
            gate100(acc[4 * pi][j] + bc, h, s);
            float v[4] = {rnd<true>(h), rnd<true>(s * acc[4 * pi + 1][j]),
                          rnd<true>(s * acc[4 * pi + 2][j]), rnd<true>(s * acc[4 * pi + 3][j])};
            if (skip) {
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) v[kk] = rnd<true>(v[kk] / SQRT2);
            }
            *reinterpret_cast<float4*>(&sm.a[c * FC_ROWS + r0 + 4 * pi]) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      }
      // a skip layer's embedding columns, and the next input's pad columns
      const int kn = d.kin[l + 1], kpn = round_up(kn, FC_KT);
      if (skip) {
        float* dst = &sm.a[nout * FC_ROWS];
        for (int i = tid; i < d0 * FC_ROWS; i += FC_THREADS) dst[i] = __bfloat162float(sm.x0s[i]);
      }
      for (int i = tid; i < (kpn - kn) * FC_ROWS; i += FC_THREADS) sm.a[kn * FC_ROWS + i] = 0.0f;
      wg::bar(1, FC_THREADS);
    }

    // the last layer: the feature columns for the primal rows
    {
      float acc[FC_TP][FC_TC];
#pragma unroll
      for (int i = 0; i < FC_TP; ++i)
#pragma unroll
        for (int j = 0; j < FC_TC; ++j) acc[i][j] = 0.0f;
      const int nst = round_up(kl, FC_KT) / FC_KT;
      for (int j = 0; j < nst; ++j, ++k) {
        sm.ring.acquire(k);
        fc_stage<true>(sm.a + j * FC_KT * FC_ROWS + r0, sm.w[k % FC_STAGES] + c0, acc);
        __syncwarp();
        if (lane == 0) sm.ring.release(k);
        if (tid == 0) fc_feed(feed, sm, Wc, wc.off, d);
      }
      const float* bias = P + d.boff[L - 1] + 1;
#pragma unroll
      for (int pi = 0; pi < FC_TP; ++pi) {
        const int gp = p0 + r0 / 4 + pi;
        if (gp >= N) continue;
        __nv_bfloat16* row = feat_out + (size_t)gp * F;
#pragma unroll
        for (int j = 0; j < FC_TC; ++j) {
          const int c = fc_col(c0, j);
          if (c < F) row[c] = __float2bfloat16_rn(acc[pi][j] + __ldg(bias + c));
        }
      }
    }
    // the SDF column of every row in gemm_narrow's order: chain i sums k =
    // i, i + 32, ...; then the xor tree, as its shuffles add at lane 0
    if (tid < FC_ROWS) {
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      for (int kb = 0; kb < kl; kb += 32) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (kb + i < kl) s[i] = fmaf(sm.a[(kb + i) * FC_ROWS + tid], sm.w0[kb + i], s[i]);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] += s[i + 16];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] += s[i + 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += s[i + 4];
      s[0] += s[2], s[1] += s[3];
      s[0] += s[1];
      sm.zn[tid] = s[0];
    }
    wg::bar(1, FC_THREADS);
    if (tid < FC_PTS && p0 + tid < N) {
      const int p = tid;
      const float g[3] = {sm.zn[4 * p + 1], sm.zn[4 * p + 2], sm.zn[4 * p + 3]};
      point_out(p0 + p, sm.zn[4 * p] + P[d.boff[L - 1]], g, sm.xs[p], bounding_sphere,
                sphere_scale, clamp_rows, sdf_out, grad_out, nullptr);
    }
  }
}

// The render chunk at bf16 (no Z): sdf_grad_kernel_fma on `ctas` persistent
// CTAs over Wc, the weights packed once per call (wc_off: layer offsets,
// then the SDF column's).
extern "C" int sdf_grad_fma_launch(const float* x, int N, int multires, const int* desc,
                                   const float* P, const float* Wc, const int* wc_off,
                                   float bounding_sphere, float sphere_scale, int clamp_rows,
                                   float* sdf_out, void* feat_out, float* grad_out, int ctas,
                                   void* stream) {
  const MlpDesc d = desc_from(desc);
  FwdWb wc;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) wc.off[l] = wc_off[l];
  const size_t smem = sizeof(ChunkSmem);
  cudaFuncSetAttribute(sdf_grad_kernel_fma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int n_tiles = (N + FC_PTS - 1) / FC_PTS;
  sdf_grad_kernel_fma<<<ctas < n_tiles ? ctas : n_tiles, FC_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, N, multires, d, P, Wc, wc, bounding_sphere, sphere_scale, clamp_rows, sdf_out,
      static_cast<__nv_bfloat16*>(feat_out), grad_out);
  return static_cast<int>(cudaGetLastError());
}

// The training variant (Z written, bf16) takes the tensor-core kernel with
// Wb (the packed bf16 weights, wb_off their per-layer offsets) on `ctas`
// persistent CTAs; float32, and bf16 without Wb (the render chunk's order
// reference), the SIMT kernel.
extern "C" int sdf_grad_launch(const float* x, int N, int multires, const int* desc,
                               const float* P, const void* Wb, const int* wb_off,
                               float bounding_sphere, float sphere_scale, int clamp_rows,
                               float* sdf_out, void* feat_out, float* grad_out, float* flag_out,
                               void* const* z_out, int bf16, int ctas, void* stream) {
  const MlpDesc d = desc_from(desc);
  ZPtrs z;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) z.p[l] = z_out[l];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && Wb != nullptr) {
    FwdWb wb;
    for (int l = 0; l < MK_MAX_LAYERS; ++l) wb.off[l] = wb_off[l];
    const size_t smem = sizeof(FwdSmem);
    cudaFuncSetAttribute(sdf_grad_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const int n_tiles = (N + TF_PTS - 1) / TF_PTS;
    sdf_grad_kernel_tc<<<ctas < n_tiles ? ctas : n_tiles, TF_THREADS, smem, s>>>(
        x, N, multires, d, P, static_cast<const __nv_bfloat16*>(Wb), wb, bounding_sphere,
        sphere_scale, clamp_rows, sdf_out, static_cast<__nv_bfloat16*>(feat_out), grad_out,
        flag_out, z);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = MLP_SMEM_FLOATS * sizeof(float);
  const dim3 grid((N + PTS - 1) / PTS);
  if (bf16) {
    cudaFuncSetAttribute(sdf_grad_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    sdf_grad_kernel<true><<<grid, THREADS, smem, s>>>(x, N, multires, d, P, bounding_sphere,
                                                      sphere_scale, clamp_rows, sdf_out, feat_out,
                                                      grad_out, flag_out, z);
  } else {
    cudaFuncSetAttribute(sdf_grad_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    sdf_grad_kernel<false><<<grid, THREADS, smem, s>>>(x, N, multires, d, P, bounding_sphere,
                                                       sphere_scale, clamp_rows, sdf_out, feat_out,
                                                       grad_out, flag_out, z);
  }
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
