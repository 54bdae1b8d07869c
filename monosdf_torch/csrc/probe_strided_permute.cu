// M: the strided-slice and lane-permutation product probe.
//
// Replaces the Pallas kernel of scripts/probe_hash_primitives.py wave 7 (f)
// (sk, pl.pallas_call at :936):
//   out = sum_{beta = 0..8} x[beta::8][:n_out] @ P,
// x (>= 8 n_out + 1, 128) float32, P (128, 128) float32 (the probe's 0/1
// lane permutation), out (n_out, 128) float32, the nine products added in
// beta order in float32, as the TPU kernel's acc +=. The TPU kernel computes
// the products on its matrix unit in its own body; so does this one, on the
// CUDA cores.
//
// It is one float32 GEMM (M = n_out, N = 128, K = 9 x 128) whose row r of A
// is x's contiguous run of rows 8r .. 8r + 8: the beta slices are an address
// pattern, not a gather. The order of arithmetic of each output is fixed:
// per beta a fresh fmaf chain over k = 0..127 from 0, then added to the
// accumulator (from 0) in beta order. So the kernel gives the same bits for
// any float32 P as any kernel with that order, and with a 0/1 permutation
// every chain has one nonzero term, so it equals the plain version exactly.
//
// Bound on the card: operations, 2 x 9 x n_out x 128 x 128 float32 FLOP at
// the FMA peak (4.5 us at n_out = 1024) against 4.3 MB of x. Design:
// - a CTA of WARPS warps takes WARPS output rows, one a warp, every lane:
//   thread t holds lanes 4t .. 4t + 3 of its row for all nine beta rows,
//   36 independent FMA chains, so each k costs a warp one broadcast x load
//   (float4 over k, shared by 4 k) per beta row and one float4 P load per k:
//   13 shared loads for 144 FMAs, and the shared-memory wavefronts (25 per
//   4 k) stay under the FMA issue slots (144 per 4 k);
// - 128 CTAs of 8 warps at n_out = 1024 (2 warps a scheduler); more tiles
//   than SMs (n_out 4096, 8192) run in one launch, two CTAs an SM;
// - the CTA's x window (8 WARPS + 1 rows, 33 KB) and P (64 KB) reach shared
//   memory by Hopper bulk copies (cp.async.bulk, one thread issuing), P in
//   NSTAGE chunks of k rows on their own mbarriers, so the products over the
//   first chunk start while the rest lands;
// - the shared-memory attribute is set once per device.
// On an H100 at n_out = 1024 the products alone take ~8.5 us of the
// kernel's ~9.3 and the staging alone ~2.1 (mostly hidden under them): the
// SMs issue the FMAs at about 55% of their peak. 4 warps a CTA, 2 rows a
// warp, 1-8 stages and clusters of 2 or 4 CTAs sharing P by multicast
// copies measured no faster (16-row CTAs and clusters of 4 slower).
#include "common.cuh"

namespace {

constexpr int LANES = 128;
constexpr int ROW_BYTES = LANES * sizeof(float);
constexpr int WARPS = 8;                     // output rows per CTA, one per warp
constexpr int THREADS = WARPS * 32;
constexpr int XROWS = 8 * WARPS + 1;         // the x window of a full tile
constexpr int NSTAGE = 4;                    // P's chunks of k rows
constexpr int KCH = LANES / NSTAGE;          // k rows per chunk
constexpr int P_BYTES = LANES * ROW_BYTES;   // 64 KB
constexpr int CH_BYTES = KCH * ROW_BYTES;    // 16 KB
constexpr size_t SMEM = static_cast<size_t>(P_BYTES) + XROWS * ROW_BYTES + NSTAGE * sizeof(uint64_t);
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// dynamic shared memory: P (128 x 128), the x window (XROWS x 128), then the
// NSTAGE mbarriers (barrier 0 also counts the x window's bytes)
__global__ void __launch_bounds__(THREADS, 2)
strided_permute_kernel(const float* __restrict__ x, const float* __restrict__ P, int n_out,
                       float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float4* Ps = reinterpret_cast<const float4*>(smem);
  const float4* xs = reinterpret_cast<const float4*>(smem + P_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P_BYTES + XROWS * ROW_BYTES);
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = blockIdx.x * WARPS;
  const int nr = min(WARPS, n_out - r0);
  if (threadIdx.x == 0) {
    for (int c = 0; c < NSTAGE; ++c)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bars[c])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const uint32_t x_bytes = (8 * (nr - 1) + 9) * ROW_BYTES;  // x rows 8 r0 .. 8 (r0 + nr - 1) + 8
    for (int c = 0; c < NSTAGE; ++c) {
      const uint32_t bar = smem_addr(&bars[c]);
      const uint32_t tx = CH_BYTES + (c == 0 ? x_bytes : 0u);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(tx)
                   : "memory");
      if (c == 0)
        bulk_load(smem_addr(smem + P_BYTES), x + static_cast<size_t>(8) * r0 * LANES, x_bytes, bar);
      bulk_load(smem_addr(smem + c * CH_BYTES), P + c * KCH * LANES, CH_BYTES, bar);
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them
  if (w >= nr) return;  // a ragged last tile: warp 0 waits for every copy

  float q[9][4];
#pragma unroll
  for (int b = 0; b < 9; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) q[b][i] = 0.0f;
  const float4* xw = xs + 8 * w * (LANES / 4);  // x row 8 (r0 + w) of the window
  for (int c = 0; c < NSTAGE; ++c) {
    bar_wait(smem_addr(&bars[c]), 0);
#pragma unroll 2
    for (int k4 = c * KCH / 4; k4 < (c + 1) * KCH / 4; ++k4) {
      float4 xv[9];
#pragma unroll
      for (int b = 0; b < 9; ++b) xv[b] = xw[b * (LANES / 4) + k4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 p = Ps[(4 * k4 + kk) * (LANES / 4) + t];
#pragma unroll
        for (int b = 0; b < 9; ++b) {
          const float xk = kk == 0 ? xv[b].x : kk == 1 ? xv[b].y : kk == 2 ? xv[b].z : xv[b].w;
          q[b][0] = fmaf(xk, p.x, q[b][0]);
          q[b][1] = fmaf(xk, p.y, q[b][1]);
          q[b][2] = fmaf(xk, p.z, q[b][2]);
          q[b][3] = fmaf(xk, p.w, q[b][3]);
        }
      }
    }
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int b = 0; b < 9; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += q[b][i];
  reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + w) * LANES)[t] =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

}  // namespace

// x and P 16-byte aligned (the wrapper checks); n_out >= 1
extern "C" int probe_strided_permute_launch(const float* x, const float* P, int n_out, float* out,
                                            void* stream) {
  if (n_out < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool granted[MAX_DEVICES] = {};  // the attribute set on this device
  if (dev >= MAX_DEVICES || !granted[dev]) {
    e = cudaFuncSetAttribute(strided_permute_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    if (dev < MAX_DEVICES) granted[dev] = true;
  }
  strided_permute_kernel<<<(n_out + WARPS - 1) / WARPS, THREADS, SMEM,
                           static_cast<cudaStream_t>(stream)>>>(x, P, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
