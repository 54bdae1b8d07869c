// C: the on-chip capacity probe.
//
// Replaces the Pallas kernels of scripts/probe_hash_primitives.py that ask
// for the whole output resident in VMEM (kern, pl.pallas_call at :495, wave
// 4, and :853, wave 7 (d)): out (rows, 128) float32 is zeros with
// out[0, 0] = 1, built on chip and written out once. On the TPU the probe
// asks for 32-110 MB of VMEM. Here one CTA holds the whole output in
// dynamic shared memory (zero-fill, set [0, 0], write out), so the request
// is the kernel's dynamic shared memory: above the card's opt-in maximum per
// block (sharedMemPerBlockOptin, 227 KB on an H100) cudaFuncSetAttribute
// refuses it (*where = 1) or the launch does (*where = 2), and the C entry
// returns that error.
//
// probe_device_limits reports the card's on-chip capacities that compare
// with VMEM: sharedMemPerBlockOptin, l2CacheSize, persistingL2CacheMaxSize.
//
// Bound on the card: bytes, the output written once; one CTA of 1024
// threads, so the probe measures a single SM's fill and write rate.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS) capacity_kernel(int rows, float* __restrict__ out) {
  extern __shared__ __align__(16) float4 buf[];
  const int n4 = rows * 32;
  for (int i = threadIdx.x; i < n4; i += THREADS) buf[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  if (threadIdx.x == 0) buf[0].x = 1.0f;
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out);
  for (int i = threadIdx.x; i < n4; i += THREADS) o[i] = buf[i];
}

}  // namespace

extern "C" int probe_capacity_launch(float* out, int rows, int* where, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(rows) * 128 * sizeof(float);
  *where = 0;
  cudaError_t e = bytes > static_cast<size_t>(0x7fffffff)
                      ? cudaErrorInvalidValue
                      : cudaFuncSetAttribute(capacity_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
  if (e != cudaSuccess) {
    cudaGetLastError();
    *where = 1;
    return static_cast<int>(e);
  }
  capacity_kernel<<<1, THREADS, bytes, s>>>(rows, out);
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
