// R: the per-row bulk-copy probe.
//
// Replaces the Pallas kernel of scripts/probe_hash_primitives.py wave 7 (e)
// (dma_kern, pl.pallas_call at :901): out = sum_i tab[idx_i, 0], where each
// 512-byte row tab[idx_i, :] is copied from HBM into on-chip memory by its
// own asynchronous copy, 8 in flight (pltpu.make_async_copy with 8 DMA
// semaphores on the TPU's one core).
//
// Here each row goes from global to shared memory whole, by its own Hopper
// bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes), into a ring of
// `stages` 512-byte slots per CTA, each completing on its own mbarrier.
// What bounds it on the card is the rows' bytes (the copy floor: n rows x
// 512 B at 3.35 TB/s) once enough copies are in flight to cover the latency
// of a random row in HBM: ~1 us x 3.35 TB/s, ~3.4 MB on the card, ~26 KB
// per SM. So every thread of the CTA is a producer: thread t of T owns the
// slots t, t + T, ..., t + (D - 1) T (D = stages / T) and the rows lo + t +
// T j of the CTA's slice [lo, hi) of idx, in order. It issues its first D
// copies; then for each of its rows it waits on the row's slot (the slot's
// k-th use completes phase k), adds the row's first value to its own sum
// and issues its copy D rows ahead into the freed slot, the index of that
// row loaded one row earlier (a warp's index loads are coalesced, and their
// latency hides behind the wait). T D rows are in flight per CTA.
//
// The sums are added in a fixed order, so two runs give the same bits: a
// warp's threads by a shuffle tree, the warps in order, and the CTAs'
// partials by the last CTA to finish, in the same launch (a counter in
// device memory, bumped by each CTA after its partial is fenced, and set
// back to 0 by the last): lane l of its first warp sums the partials of the
// CTAs [l c, (l + 1) c) (c = ceil(ctas / 32)) in order, then lane 0 the 32
// lane sums in order. Indices are clamped into the table.
#include "common.cuh"

namespace {

constexpr int ROW_FLOATS = 128;
constexpr int ROW_BYTES = ROW_FLOATS * sizeof(float);
constexpr int MAX_THREADS = 128;
// the workspace: the completion counter, then the CTAs' partials 128 bytes on
constexpr int PARTIALS_AT = 32;

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

__device__ __forceinline__ const float* row_of(const float* tab, int rows, const int* idx, int i) {
  const int r = min(max(__ldg(idx + i), 0), rows - 1);
  return tab + static_cast<size_t>(r) * ROW_FLOATS;
}

// dynamic shared memory: stages slots of one row, then their mbarriers
__global__ void __launch_bounds__(MAX_THREADS)
row_copy_kernel(const float* __restrict__ tab, int rows, const int* __restrict__ idx, int n,
                int depth, unsigned* __restrict__ ws, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float warp_sums[MAX_THREADS / 32];
  __shared__ float lane_sums[32];
  __shared__ int last;
  const int T = blockDim.x, t = threadIdx.x;
  float(*stage)[ROW_FLOATS] = reinterpret_cast<float(*)[ROW_FLOATS]>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(T) * depth * ROW_BYTES);
  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) * n / gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n / gridDim.x);
  const int mine = hi - lo > t ? (hi - lo - t + T - 1) / T : 0;  // this thread's rows
  for (int k = 0; k < depth; ++k) bar_init(smem_addr(&bars[t + k * T]));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  for (int j = 0; j < min(depth, mine); ++j)
    copy_row(smem_addr(stage[t + j * T]), row_of(tab, rows, idx, lo + t + j * T),
             smem_addr(&bars[t + j * T]));
  const float* next = depth < mine ? row_of(tab, rows, idx, lo + t + depth * T) : nullptr;
  float acc = 0.0f;
  int k = 0;           // the slot of row j: t + k T, k = j % depth
  uint32_t phase = 0;  // its use: (j / depth) & 1
  for (int j = 0; j < mine; ++j) {
    const int s = t + k * T;
    bar_wait(smem_addr(&bars[s]), phase);
    acc += stage[s][0];
    if (j + depth < mine) {
      // the slot's generic-proxy read before the async proxy writes it again
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      copy_row(smem_addr(stage[s]), next, smem_addr(&bars[s]));
      if (j + depth + 1 < mine) next = row_of(tab, rows, idx, lo + t + (j + depth + 1) * T);
    }
    if (++k == depth) {
      k = 0;
      phase ^= 1u;
    }
  }

  // the CTA's partial: each warp's threads by a shuffle tree, the warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((t & 31) == 0) warp_sums[t >> 5] = acc;
  __syncthreads();
  float* partials = reinterpret_cast<float*>(ws + PARTIALS_AT);
  if (t == 0) {
    float cta = 0.0f;
    for (int w = 0; w < T / 32; ++w) cta += warp_sums[w];
    partials[blockIdx.x] = cta;
    __threadfence();  // the partial before the count that announces it
    last = atomicAdd(ws, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || t >= 32) return;
  // the last CTA: every partial is written; sum them in the fixed order
  __threadfence();
  const int c = (gridDim.x + 31) / 32;
  float v = 0.0f;
  for (int b = t * c; b < min((t + 1) * c, static_cast<int>(gridDim.x)); ++b)
    v += __ldcg(partials + b);
  lane_sums[t] = v;
  __syncwarp();
  if (t == 0) {
    float total = 0.0f;
    for (int l = 0; l < 32; ++l) total += lane_sums[l];
    out[0] = total;
    *ws = 0u;  // the next launch counts from 0
  }
}

}  // namespace

// ws: 32 + ctas 32-bit words of device memory, its first 0 (the kernel
// leaves it 0 again); stages: a multiple of 32, threads = min(128, stages).
extern "C" int probe_row_copy_launch(const float* tab, int rows, const int* idx, int n, int ctas,
                                     int stages, unsigned* ws, float* out, void* stream) {
  if (stages < 32 || stages % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = min(MAX_THREADS, stages);
  if (stages % threads != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(stages) * (ROW_BYTES + sizeof(uint64_t));
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static size_t allowed[64] = {};  // the dynamic shared memory granted, per device
  if (dev < 64 && smem > allowed[dev]) {
    e = cudaFuncSetAttribute(row_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = smem;
  }
  row_copy_kernel<<<ctas, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      tab, rows, idx, n, stages / threads, ws, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
