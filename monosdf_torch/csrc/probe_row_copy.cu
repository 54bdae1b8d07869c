// R: the per-row bulk-copy probe.
//
// Replaces the Pallas kernel of scripts/probe_hash_primitives.py wave 7 (e)
// (dma_kern, pl.pallas_call at :901): out = sum_i tab[idx_i, 0], where each
// 512-byte row tab[idx_i, :] is copied from HBM into on-chip memory by its
// own asynchronous copy, 8 in flight (pltpu.make_async_copy with 8 DMA
// semaphores on the TPU's one core).
//
// Here each row goes from global to shared memory by its own Hopper bulk
// copy (cp.async.bulk ... mbarrier::complete_tx::bytes), completing on one
// of 8 mbarriers, a ring of 8 stages per CTA: one thread issues the first 8
// copies, then for each row waits on its stage's barrier (the stage's k-th
// use completes phase k), adds the row's first value and issues the copy 8
// rows ahead into the freed stage. CTA b walks the contiguous slice
// [b n / ctas, (b + 1) n / ctas) of idx in order; a second launch of one
// thread sums the CTAs' partials in CTA order. With one CTA the loop has
// the TPU kernel's form; with one CTA per SM the card's aggregate rate.
//
// Bound on the card: bytes, the index and the 32-byte sectors that hold the
// rows' first values; the probe measures the latency of a ring of 8 row
// copies per SM instead. Indices are clamped into the table.
#include "common.cuh"

namespace {

constexpr int STAGES = 8;
constexpr int ROW_BYTES = 128 * sizeof(float);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void copy_row(uint32_t dst, const float* src, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(ROW_BYTES)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(ROW_BYTES), "r"(bar)
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

__global__ void __launch_bounds__(32)
row_copy_kernel(const float* __restrict__ tab, int rows, const int* __restrict__ idx, int n,
                float* __restrict__ partials) {
  __shared__ __align__(128) float stage[STAGES][128];
  __shared__ __align__(8) uint64_t bars[STAGES];
  if (threadIdx.x != 0) return;
  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) * n / gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n / gridDim.x);
  for (int s = 0; s < STAGES; ++s) bar_init(smem_addr(&bars[s]));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  auto issue = [&](int i) {
    const int r = min(max(idx[i], 0), rows - 1);
    const int s = (i - lo) % STAGES;
    copy_row(smem_addr(stage[s]), tab + static_cast<size_t>(r) * 128, smem_addr(&bars[s]));
  };
  for (int i = lo; i < min(hi, lo + STAGES); ++i) issue(i);
  float acc = 0.0f;
  for (int i = lo; i < hi; ++i) {
    const int k = i - lo;
    const int s = k % STAGES;
    bar_wait(smem_addr(&bars[s]), static_cast<uint32_t>((k / STAGES) & 1));
    acc += stage[s][0];
    if (i + STAGES < hi) {
      // the stage's generic-proxy read before the async proxy writes it again
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(i + STAGES);
    }
  }
  partials[blockIdx.x] = acc;
}

__global__ void sum_partials_kernel(const float* __restrict__ partials, int n, float* out) {
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) acc += partials[i];
  out[0] = acc;
}

}  // namespace

extern "C" int probe_row_copy_launch(const float* tab, int rows, const int* idx, int n, int ctas,
                                     float* partials, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_copy_kernel<<<ctas, 32, 0, s>>>(tab, rows, idx, n, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_partials_kernel<<<1, 1, 0, s>>>(partials, ctas, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
