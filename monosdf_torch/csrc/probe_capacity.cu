// C: the on-chip capacity probe.
//
// Replaces the Pallas kernels of scripts/probe_hash_primitives.py that ask
// for the whole output resident in VMEM (kern, pl.pallas_call at :495, wave
// 4, and :853, wave 7 (d)): out (rows, 128) float32 is zeros with
// out[0, 0] = 1, built on chip and written out once. On the TPU the probe
// asks for 32-110 MB of VMEM. Here one CTA holds the whole output in
// dynamic shared memory, so the request is the kernel's dynamic shared
// memory: above the card's opt-in maximum per block (sharedMemPerBlockOptin,
// 227 KB on an H100) cudaFuncSetAttribute refuses it (*where = 1) or the
// launch does (*where = 2), and the C entry returns that error.
//
// Bound on the card: bytes, the output written once. One CTA does the
// work, so what sets its time is one SM's rate: the zero-fill at 128 bytes
// of shared memory a clock, and the store out at the SM's write rate to
// L2. The store goes by Hopper's bulk copies
// (cp.async.bulk.global.shared::cta), so no thread spends a load and a
// store per 16 bytes on it: warp w fills the PIECE-byte pieces w, w + 32,
// ... of the output in shared memory, makes its writes visible to the
// async proxy (fence.proxy.async) and its lane 0 issues the piece's bulk
// store, which runs while the warp fills its next piece. No CTA-wide
// barrier is needed; each issuing lane waits until its stores have read
// shared memory before the CTA exits.
//
// The host sets the kernel's shared-memory attribute only when a request
// exceeds the largest granted so far on the device (a high-water mark):
// a size above the card's limit always reaches cudaFuncSetAttribute.
//
// probe_device_limits reports the card's on-chip capacities that compare
// with VMEM: sharedMemPerBlockOptin, l2CacheSize, persistingL2CacheMaxSize.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int PIECE = 4096;  // bytes of one bulk store
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(THREADS) capacity_kernel(int bytes, float* __restrict__ out) {
  extern __shared__ __align__(128) float4 buf[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pieces = (bytes + PIECE - 1) / PIECE;
  for (int p = warp; p < pieces; p += WARPS) {
    const int lo = p * PIECE, len = min(PIECE, bytes - lo);
    float4* q = buf + lo / 16;
    for (int i = lane; i < len / 16; i += 32)
      q[i] = make_float4(lo + i == 0 ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
    // the lanes' generic-proxy writes before the async proxy reads them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                       reinterpret_cast<char*>(out) + lo),
                   "r"(smem_addr(q)), "r"(len)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  // the shared memory is released at exit; the stores' writes complete by
  // the end of the grid
  if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

}  // namespace

extern "C" int probe_capacity_launch(float* out, int rows, int* where, void* stream) {
  const size_t bytes = static_cast<size_t>(rows) * 128 * sizeof(float);
  *where = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  static size_t granted[MAX_DEVICES] = {};  // the dynamic shared memory granted, per device
  if (e == cudaSuccess && (dev >= MAX_DEVICES || bytes > granted[dev])) {
    e = bytes > static_cast<size_t>(INT_MAX)
            ? cudaErrorInvalidValue
            : cudaFuncSetAttribute(capacity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
    if (e == cudaSuccess && dev < MAX_DEVICES) granted[dev] = bytes;
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    *where = 1;
    return static_cast<int>(e);
  }
  capacity_kernel<<<1, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(static_cast<int>(bytes),
                                                                            out);
  e = cudaGetLastError();
  if (e != cudaSuccess) *where = 2;
  return static_cast<int>(e);
}

extern "C" int probe_device_limits(int* out3) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out3[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out3[1], cudaDevAttrL2CacheSize, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out3[2], cudaDevAttrMaxPersistingL2CacheSize, dev);
  return static_cast<int>(e);
}

MK_ERROR_STRING_EXPORT
