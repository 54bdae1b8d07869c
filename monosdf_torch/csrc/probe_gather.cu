// G: the dynamic-gather probe.
//
// Replaces the Pallas kernels of scripts/probe_hash_primitives.py probe_dg
// (pl.pallas_call at :154, wave 1) and probe (:998, wave 8): with the table
// and the index resident on chip, reps times
//   out[r, c] += tbl[idx[r, c], c]     (axis 0)
//   out[r, c] += tbl[r, idx[r, c]]     (axis 1),
// a float32 sum of the (float32 or bf16) table values, out (n, 128) float32.
// The TPU kernel keeps the whole table in VMEM and defeats the hoisting of
// the repeated gather with idx + (i - i). Here each rep adds `zero * it` to
// the row (zero is a kernel argument, always 0, that the compiler cannot
// prove 0), so every rep reads again.
//
// Where the table lives: a table that fits one block's shared memory (the
// card's opt-in maximum, 227 KB on an H100) is staged there by every block,
// as the TPU stages it in VMEM, and the reps read shared memory; a larger
// one is read through L2 (ld.global.cg: cached in L2, not in L1, so each
// rep is an L2 access). Axis 1 reads within a row, so each block stages its
// own 16 rows. The C entry reports the choice (*staged).
//
// Bound on the card: the table, the index and the output once (bytes); the
// probe measures the rate of the reps' reads instead, which is its point.
// Indices are clamped into the table, so a bad one cannot read outside it.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int AX1_ROWS = 16;  // rows a block stages for axis 1

__device__ __forceinline__ float load_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_l2(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// axis 0 through L2: one thread per output element
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_l2_kernel(const T* __restrict__ tbl, const int* __restrict__ idx, int rows, long long n_el,
                 int reps, int zero, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= n_el) return;
  const int c = static_cast<int>(t & 127);
  const int r = min(max(idx[t], 0), rows - 1);
  float acc = 0.0f;
  for (int it = 0; it < reps; ++it) {
    acc += load_l2(tbl + static_cast<size_t>(r + it * zero) * 128 + c);
  }
  out[t] = acc;
}

// axis 0 from shared memory: every block stages the whole table, then walks
// its share of the outputs
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_smem_kernel(const T* __restrict__ tbl, const int* __restrict__ idx, int rows,
                   long long n_el, int reps, int zero, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int n_vec = rows * 128 * static_cast<int>(sizeof(T)) / 16;
  const int4* src = reinterpret_cast<const int4*>(tbl);
  int4* dst = reinterpret_cast<int4*>(smem_raw);
  for (int i = threadIdx.x; i < n_vec; i += THREADS) dst[i] = src[i];
  __syncthreads();
  for (long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; t < n_el;
       t += static_cast<long long>(gridDim.x) * THREADS) {
    const int c = static_cast<int>(t & 127);
    const int r = min(max(idx[t], 0), rows - 1);
    float acc = 0.0f;
    for (int it = 0; it < reps; ++it) acc += to_f(s[(r + it * zero) * 128 + c]);
    out[t] = acc;
  }
}

// axis 1: block b stages rows [16 b, 16 b + 16) and gathers within them
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_ax1_kernel(const T* __restrict__ tbl, const int* __restrict__ idx, int rows, int reps,
                  int zero, float* __restrict__ out) {
  __shared__ T s[AX1_ROWS * 128];
  const int r0 = blockIdx.x * AX1_ROWS;
  const int nr = min(AX1_ROWS, rows - r0);
  for (int i = threadIdx.x; i < nr * 128; i += THREADS) s[i] = tbl[static_cast<size_t>(r0) * 128 + i];
  __syncthreads();
  for (int i = threadIdx.x; i < nr * 128; i += THREADS) {
    const int rl = i >> 7;
    const size_t g = static_cast<size_t>(r0) * 128 + i;
    const int c = min(max(idx[g], 0), 127);
    float acc = 0.0f;
    for (int it = 0; it < reps; ++it) acc += to_f(s[rl * 128 + c + it * zero]);
    out[g] = acc;
  }
}

template <typename T>
int launch(const T* tbl, const int* idx, int rows, int n, int axis, int reps, float* out,
           int* staged, cudaStream_t s) {
  const long long n_el = static_cast<long long>(n) * 128;
  if (axis == 1) {
    *staged = 1;
    gather_ax1_kernel<T><<<(rows + AX1_ROWS - 1) / AX1_ROWS, THREADS, 0, s>>>(tbl, idx, rows, reps,
                                                                              0, out);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, optin = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t bytes = static_cast<size_t>(rows) * 128 * sizeof(T);
  *staged = bytes <= static_cast<size_t>(optin);
  if (*staged) {
    cudaError_t e = cudaFuncSetAttribute(gather_smem_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    const long long want = (n_el + THREADS - 1) / THREADS;
    const int grid = static_cast<int>(want < 2LL * sms ? want : 2LL * sms);
    gather_smem_kernel<T><<<grid, THREADS, bytes, s>>>(tbl, idx, rows, n_el, reps, 0, out);
  } else {
    gather_l2_kernel<T><<<static_cast<unsigned>((n_el + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        tbl, idx, rows, n_el, reps, 0, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_gather_launch(const void* tbl, const int* idx, int rows, int n, int axis,
                                   int reps, int bf16, float* out, int* staged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (bf16) {
    return launch(static_cast<const __nv_bfloat16*>(tbl), idx, rows, n, axis, reps, out, staged, s);
  }
  return launch(static_cast<const float*>(tbl), idx, rows, n, axis, reps, out, staged, s);
}

MK_ERROR_STRING_EXPORT
