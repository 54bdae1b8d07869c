// S: the run-scatter probe, runs of R rows added into a float32 accumulator.
//
// Replaces the Pallas kernels of scripts/probe_hash_primitives.py
// (pl.pallas_call at :192, wave 1 pl_store, R = 8; and :534, wave 4
// probe_rmw, R = 1):
//   out = 0;  for each run j:  out[off_j + k, :] += vals[R j + k, :]  (k < R),
// out (rows, 128) float32, vals (R n_runs, 128) float32 or bf16 (widened to
// float32), offsets int32 in [0, rows - R]. The TPU kernels keep the
// accumulator in VMEM and add run after run in order. Here every run row is
// added by 32 threads, each with one float4 atomicAdd (sm_90, CUDA 12.1 and
// later; four float atomics before) into L2, so overlapping runs and
// colliding rows add; the order of the adds, and so the float32 rounding of
// a row that takes several, changes from run to run. The accumulator is
// zeroed on the stream (cudaMemsetAsync) before the kernel. A run whose
// offset lies outside [0, rows - R] adds nothing.
//
// Bound on the card: bytes (the offsets and values read once, the
// accumulator written once); colliding updates serialise on their L2
// lines' atomic units, which is what the probe's all-zero-index case shows.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

__device__ __forceinline__ void add4(float* p, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(p), v);
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

// thread t: run j = t / (32 R), its row k = (t / 32) % R, lanes 4q..4q+3
template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_rows_kernel(const int* __restrict__ offs, const T* __restrict__ vals, long long n_thr,
                    int R, int rows, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= n_thr) return;
  const long long vrow = t >> 5;  // R j + k
  const int q = static_cast<int>(t & 31);
  const long long j = vrow / R;
  const int k = static_cast<int>(vrow - j * R);
  const int off = offs[j];
  if (off < 0 || off > rows - R) return;
  add4(out + static_cast<size_t>(off + k) * 128 + 4 * q, load4(vals + vrow * 128 + 4 * q));
}

}  // namespace

extern "C" int probe_scatter_rows_launch(const int* offs, const void* vals, int n_runs, int R,
                                         int rows, int bf16, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(rows) * 128 * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_thr = static_cast<long long>(n_runs) * R * 32;
  if (n_thr == 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>((n_thr + THREADS - 1) / THREADS);
  if (bf16) {
    scatter_rows_kernel<<<grid, THREADS, 0, s>>>(offs, static_cast<const __nv_bfloat16*>(vals),
                                                 n_thr, R, rows, out);
  } else {
    scatter_rows_kernel<<<grid, THREADS, 0, s>>>(offs, static_cast<const float*>(vals), n_thr, R,
                                                 rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
