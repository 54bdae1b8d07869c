// S: the run-scatter probe, runs of R rows added into a float32 accumulator.
//
// Replaces the Pallas kernels of scripts/probe_hash_primitives.py
// (pl.pallas_call at :192, wave 1 pl_store, R = 8; and :534, wave 4
// probe_rmw, R = 1):
//   out = 0;  for each run j:  out[off_j + k, :] += vals[R j + k, :]  (k < R),
// out (rows, 128) float32, vals (R n_runs, 128) float32 or bf16 (widened to
// float32), offsets int32 in [0, rows - R]; a run whose offset lies outside
// adds nothing. The TPU kernels keep the accumulator in VMEM and add run
// after run in order.
//
// Bound on the card: bytes (the offsets and values read once, the
// accumulator written once). Two passes:
//
// - Sorted offsets (the caller says so; wave 1's are sorted by
//   construction): output-stationary, one launch, no memset and no
//   atomics. Warp r owns output row r (lane q its columns 4q..4q+3): a
//   32-way search in offs (each lane reading one offset a round) finds the
//   first run that can cover it (off >= r - R + 1), a ballot over the next
//   32 offsets the runs that do; it sums their value rows in run order in
//   registers (the TPU kernel's order, so two runs agree bit for bit), and
//   writes the row once, zeros where no run reaches it. Every thread also
//   checks a pair of neighbouring offsets and traps on a descending one, so
//   unsorted offsets given to this pass end the launch with an error
//   instead of a wrong sum (no host sync: the error shows at the next one).
// - Any order (wave 4's, and its all-zero conflict case, whose
//   nondecreasing offsets would put every value row on one warp of the
//   sorted pass): the accumulator zeroed on the stream (cudaMemsetAsync),
//   then each warp walks a span of `span` consecutive value rows in order
//   (kernels/probes.py SCATTER_SPAN), UNROLL rows' offsets and values
//   loaded at once (values with an evict-first hint, so that the
//   accumulator's lines stay in L2 for the atomics), sums consecutive rows
//   with the same target row in registers and adds each such sum with one
//   float4 atomicAdd a lane (sm_90, CUDA 12.1 and later; four float atomics
//   before) into L2. Colliding updates serialise on their L2 lines' atomic
//   units, so summing before the atomic takes the conflict case from one
//   atomic a value row to one a span; the order of the atomics, and so the
//   float32 rounding of a row that takes several, changes from run to run.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

// the value rows are read once: loads that the L2 evicts first
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

__device__ __forceinline__ void acc4(float4& a, float4 v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
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

// warp r: output row r; every thread: the pair (offs[p], offs[p + 1]), p its
// global index (grid-stride)
template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_rows_sorted_kernel(const int* __restrict__ offs, const T* __restrict__ vals, int n_runs,
                           int R, int rows, float* __restrict__ out) {
  const long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long n_thr = static_cast<long long>(gridDim.x) * THREADS;
  for (long long p = g; p + 1 < n_runs; p += n_thr)
    if (__ldg(offs + p + 1) < __ldg(offs + p)) __trap();
  const long long r = g >> 5;
  if (r >= rows) return;
  const int q = threadIdx.x & 31;
  const int row = static_cast<int>(r), key = row - R + 1;
  // the first run with off >= key, a 32-way search: each round the lanes
  // read 32 evenly spaced offsets of [lo, hi) and keep the piece that holds
  // the first one >= key, until 32 offsets are left
  int lo = 0, hi = n_runs;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = min(lo + (q + 1) * step - 1, hi - 1);
    const int below = __popc(__ballot_sync(0xffffffffu, __ldg(offs + p) < key));
    const int nlo = below == 0 ? lo : min(lo + below * step, hi);
    hi = below == 32 ? hi : min(lo + (below + 1) * step - 1, hi - 1) + 1;
    lo = nlo;
  }
  const bool in = lo + q < hi;
  int j = lo + __popc(__ballot_sync(0xffffffffu, in && __ldg(offs + lo + q) < key));
  // the runs from j on that cover the row (off <= row), 32 offsets a window,
  // their value rows added in run order
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (;; j += 32) {
    const int o = j + q < n_runs ? __ldg(offs + j + q) : 0x7fffffff;
    const unsigned cover = __ballot_sync(0xffffffffu, o <= row);  // a prefix: offs is sorted
    for (int l = 0; l < __popc(cover); ++l) {
      const int off = __shfl_sync(0xffffffffu, o, l);
      if (off >= 0 && off <= rows - R)
        acc4(acc, load4(vals + (static_cast<size_t>(j + l) * R + (row - off)) * 128 + 4 * q));
    }
    if (cover != 0xffffffffu) break;
  }
  __stcs(reinterpret_cast<float4*>(out + static_cast<size_t>(row) * 128 + 4 * q), acc);
}

// warp w: value rows [w span, (w + 1) span) in order
template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_rows_atomic_kernel(const int* __restrict__ offs, const T* __restrict__ vals,
                           long long vrows, int R, int rows, int span, float* __restrict__ out) {
  const long long w = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const int q = threadIdx.x & 31;
  const long long v0 = w * span;
  if (v0 >= vrows) return;
  const long long v1 = min(v0 + span, vrows);
  long long j = v0 / R;                    // the run of value row v
  int k = static_cast<int>(v0 - j * R);    // its row in the run
  int cur = -1;                            // the target row being summed (-1: none)
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long v = v0; v < v1; v += UNROLL) {
    int tgt[UNROLL];
    float4 val[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      tgt[u] = -2;  // past the span
      if (v + u < v1) {
        const int off = __ldg(offs + j);
        tgt[u] = (off < 0 || off > rows - R) ? -1 : off + k;  // -1: adds nothing
        val[u] = load4(vals + (v + u) * 128 + 4 * q);
        if (++k == R) {
          k = 0;
          ++j;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (tgt[u] == -2) break;
      if (tgt[u] == cur) {
        acc4(acc, val[u]);
      } else {
        if (cur >= 0) add4(out + static_cast<size_t>(cur) * 128 + 4 * q, acc);
        cur = tgt[u];
        acc = val[u];
      }
    }
  }
  if (cur >= 0) add4(out + static_cast<size_t>(cur) * 128 + 4 * q, acc);
}

template <typename T>
cudaError_t launch(const int* offs, const T* vals, int n_runs, int R, int rows, int sorted,
                   int span, float* out, cudaStream_t s) {
  if (sorted) {
    const unsigned grid = static_cast<unsigned>((static_cast<long long>(rows) * 32 + THREADS - 1) /
                                                THREADS);
    scatter_rows_sorted_kernel<<<grid, THREADS, 0, s>>>(offs, vals, n_runs, R, rows, out);
    return cudaGetLastError();
  }
  cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(rows) * 128 * sizeof(float), s);
  if (e != cudaSuccess) return e;
  const long long vrows = static_cast<long long>(n_runs) * R;
  const long long warps = (vrows + span - 1) / span;
  const unsigned grid = static_cast<unsigned>(max(1LL, (warps * 32 + THREADS - 1) / THREADS));
  scatter_rows_atomic_kernel<<<grid, THREADS, 0, s>>>(offs, vals, vrows, R, rows, span, out);
  return cudaGetLastError();
}

}  // namespace

// sorted: the output-stationary pass (offs nondecreasing, else the launch
// traps); else the atomic pass over spans of `span` value rows.
extern "C" int probe_scatter_rows_launch(const int* offs, const void* vals, int n_runs, int R,
                                         int rows, int bf16, int sorted, int span, float* out,
                                         void* stream) {
  if (span < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch(offs, static_cast<const __nv_bfloat16*>(vals), n_runs, R, rows, sorted, span,
                    out, s)
           : launch(offs, static_cast<const float*>(vals), n_runs, R, rows, sorted, span, out, s);
  return static_cast<int>(e);
}

MK_ERROR_STRING_EXPORT
