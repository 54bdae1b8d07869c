// G: the dynamic-gather probe.
//
// Replaces the Pallas kernels of scripts/probe_hash_primitives.py probe_dg
// (pl.pallas_call at :154, wave 1) and probe (:998, wave 8): with the table
// and the index resident on chip, reps times
//   out[r, c] += tbl[idx[r, c], c]     (axis 0)
//   out[r, c] += tbl[r, idx[r, c]]     (axis 1),
// a float32 sum of the (float32 or bf16) table values in rep order, out
// (n, 128) float32. The TPU kernel keeps the whole table in VMEM and defeats
// the hoisting of the repeated gather with idx + (i - i). Here each rep adds
// `zero * it` to the address (zero is a kernel argument, always 0, that the
// compiler cannot prove 0), so every rep reads again.
//
// Where the table lives. out[r, c] reads only column c of the table along
// axis 0, so a CTA that owns a slice of w columns stages those columns of
// every table row in its shared memory (row-major, w wide) and computes
// every output of its columns there: the whole table sits on chip across
// the SMs, as it sits in VMEM on the TPU, and the slices need no
// co-residency. A one-column slice of a float32 table fits 227 KB up to
// 58,112 rows. Each slice's output rows are split over `blocks` CTAs so
// that the grid covers the SMs. The host (kernels/probes.py gather_plan)
// stages where each table element is read more than once on average
// (reps n >= rows) and a slice fits; w is then the widest power of two of
// at most 32 bytes a row (one sector) that fits. Otherwise the reps read
// through L2 (ld.global.cg: cached in L2, not in L1), which is then the
// right place: P8 (8 reps of 2048 rows of a 32,768-row table) reaches a
// sixteenth of its table. Axis 1 reads within a row, so each CTA stages
// its own AX1_ROWS rows.
//
// Bound on the card: the table, the index and the output once (bytes);
// the probe measures the rate of the reps' reads instead, which is its
// point: at 32 shared-memory reads a clock on each SM the reps take at
// least reps n 128 / (32 SMs clock), and random rows put ~3.5 of a warp's
// 32 reads on one bank. Each thread carries UNROLL outputs through the reps
// at once, so their reads overlap. Indices are clamped into the table, so a
// bad one cannot read outside it.
#include "common.cuh"

namespace {

constexpr int L2_THREADS = 256;
constexpr int SLICE_THREADS = 512;
constexpr int AX1_THREADS = 512;
constexpr int AX1_ROWS = AX1_THREADS / 128;  // rows a CTA stages for axis 1
constexpr int UNROLL = 4;                    // outputs a thread carries through the reps
constexpr int STAGE_BATCH = 8;               // loads in flight a thread while staging
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float load_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_l2(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// axis 0 through L2: one thread per output element
template <typename T>
__global__ void __launch_bounds__(L2_THREADS)
gather_l2_kernel(const T* __restrict__ tbl, const int* __restrict__ idx, int rows, long long n_el,
                 int reps, int zero, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * L2_THREADS + threadIdx.x;
  if (t >= n_el) return;
  const int c = static_cast<int>(t & 127);
  const int r = min(max(idx[t], 0), rows - 1);
  float acc = 0.0f;
  for (int it = 0; it < reps; ++it) {
    acc += load_l2(tbl + static_cast<size_t>(r + it * zero) * 128 + c);
  }
  out[t] = acc;
}

// s[r * units + k] = src[r * row_stride + k], r < rows, k < units: each
// table row's slice, `units` vectors V, STAGE_BATCH loads in flight a thread
template <typename V>
__device__ __forceinline__ void stage_rows(const V* __restrict__ src, int row_stride, int rows,
                                           int units, V* __restrict__ s) {
  const int total = rows * units;
  for (int i0 = threadIdx.x; i0 < total; i0 += SLICE_THREADS * STAGE_BATCH) {
    V v[STAGE_BATCH];
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b) {
      const int i = i0 + b * SLICE_THREADS;
      if (i < total) {
        const int r = i / units;
        v[b] = src[static_cast<size_t>(r) * row_stride + (i - r * units)];
      }
    }
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b) {
      const int i = i0 + b * SLICE_THREADS;
      if (i < total) s[i] = v[b];
    }
  }
}

// the column slice [c0, c0 + ws) of every table row into s, row-major, ws
// wide: by the widest vector that divides the slice's offset and length
template <typename T>
__device__ __forceinline__ void stage_slice(const T* __restrict__ tbl, int rows, int c0, int ws,
                                            T* __restrict__ s) {
  const int off = c0 * static_cast<int>(sizeof(T)), len = ws * static_cast<int>(sizeof(T));
  const int rb = 128 * static_cast<int>(sizeof(T));  // a table row's bytes
  const char* src = reinterpret_cast<const char*>(tbl) + off;
  const int al = off | len | static_cast<int>(reinterpret_cast<uintptr_t>(tbl) & 15);
  if (al % 16 == 0) {
    stage_rows(reinterpret_cast<const int4*>(src), rb / 16, rows, len / 16, reinterpret_cast<int4*>(s));
  } else if (al % 8 == 0) {
    stage_rows(reinterpret_cast<const int2*>(src), rb / 8, rows, len / 8, reinterpret_cast<int2*>(s));
  } else if (al % 4 == 0) {
    stage_rows(reinterpret_cast<const int*>(src), rb / 4, rows, len / 4, reinterpret_cast<int*>(s));
  } else {
    stage_rows(reinterpret_cast<const unsigned short*>(src), rb / 2, rows, len / 2,
               reinterpret_cast<unsigned short*>(s));
  }
}

// axis 0 from shared memory: CTA b of the grid stages the column slice
// b / blocks (w wide, the last one narrower where w does not divide 128)
// of the whole table and computes the outputs of its columns in the
// output rows of its block b % blocks
template <typename T>
__global__ void __launch_bounds__(SLICE_THREADS)
gather_slice_kernel(const T* __restrict__ tbl, const int* __restrict__ idx, int rows, int n, int w,
                    int blocks, int reps, int zero, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int slice = blockIdx.x / blocks, blk = blockIdx.x - slice * blocks;
  const int c0 = slice * w, ws = min(w, 128 - c0);
  const int r0 = static_cast<int>(static_cast<long long>(blk) * n / blocks);
  const int r1 = static_cast<int>(static_cast<long long>(blk + 1) * n / blocks);
  stage_slice(tbl, rows, c0, ws, s);
  __syncthreads();
  const int n_out = (r1 - r0) * ws, step = zero * ws;
  for (int e0 = threadIdx.x; e0 < n_out; e0 += SLICE_THREADS * UNROLL) {
    int a[UNROLL];
    size_t g[UNROLL];
    float acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = min(e0 + u * SLICE_THREADS, n_out - 1);
      const int rl = e / ws, c = e - rl * ws;
      g[u] = static_cast<size_t>(r0 + rl) * 128 + c0 + c;
      a[u] = min(max(idx[g[u]], 0), rows - 1) * ws + c;
      acc[u] = 0.0f;
    }
    for (int it = 0; it < reps; ++it) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc[u] += to_f(s[a[u] + it * step]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (e0 + u * SLICE_THREADS < n_out) out[g[u]] = acc[u];
  }
}

// axis 1: CTA b stages rows [AX1_ROWS b, AX1_ROWS (b + 1)) and gathers
// within them, a thread an output
template <typename T>
__global__ void __launch_bounds__(AX1_THREADS)
gather_ax1_kernel(const T* __restrict__ tbl, const int* __restrict__ idx, int rows, int reps,
                  int zero, float* __restrict__ out) {
  __shared__ T s[AX1_ROWS * 128];
  const int r0 = blockIdx.x * AX1_ROWS;
  const int nr = min(AX1_ROWS, rows - r0);
  const int i = threadIdx.x;
  const size_t g = static_cast<size_t>(r0) * 128 + i;
  if (i < nr * 128) s[i] = tbl[g];
  __syncthreads();
  if (i >= nr * 128) return;
  const int a = (i & ~127) + min(max(idx[g], 0), 127);
  float acc = 0.0f;
  for (int it = 0; it < reps; ++it) acc += to_f(s[a + it * zero]);
  out[g] = acc;
}

template <typename T>
int launch(const T* tbl, const int* idx, int rows, int n, int axis, int reps, int w, int blocks,
           float* out, cudaStream_t s) {
  if (axis == 1) {
    gather_ax1_kernel<T><<<(rows + AX1_ROWS - 1) / AX1_ROWS, AX1_THREADS, 0, s>>>(tbl, idx, rows,
                                                                                 reps, 0, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (w == 0) {
    const long long n_el = static_cast<long long>(n) * 128;
    gather_l2_kernel<T><<<static_cast<unsigned>((n_el + L2_THREADS - 1) / L2_THREADS), L2_THREADS,
                          0, s>>>(tbl, idx, rows, n_el, reps, 0, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (w < 0 || w > 128 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(rows) * w * sizeof(T);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static size_t granted[MAX_DEVICES] = {};  // per instantiation: the shared memory granted, per device
  if (dev >= MAX_DEVICES || bytes > granted[dev]) {
    e = bytes > static_cast<size_t>(0x7fffffff)
            ? cudaErrorInvalidValue
            : cudaFuncSetAttribute(gather_slice_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    if (dev < MAX_DEVICES) granted[dev] = bytes;
  }
  const int slices = (128 + w - 1) / w;
  gather_slice_kernel<T><<<slices * blocks, SLICE_THREADS, bytes, s>>>(tbl, idx, rows, n, w, blocks,
                                                                      reps, 0, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w > 0 (axis 0): stage column slices w wide, `blocks` CTAs a slice;
// w == 0: axis 0 through L2, or axis 1 (its rows staged)
extern "C" int probe_gather_launch(const void* tbl, const int* idx, int rows, int n, int axis,
                                   int reps, int bf16, int w, int blocks, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch(static_cast<const __nv_bfloat16*>(tbl), idx, rows, n, axis, reps, w, blocks, out, s);
  }
  return launch(static_cast<const float*>(tbl), idx, rows, n, axis, reps, w, blocks, out, s);
}

// what gather_plan needs of the current device: sharedMemPerBlockOptin,
// multiProcessorCount, sharedMemPerMultiprocessor, maxThreadsPerMultiProcessor
extern "C" int probe_gather_limits(int* out4) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor, cudaDevAttrMaxThreadsPerMultiProcessor};
  for (int i = 0; i < 4 && e == cudaSuccess; ++i) e = cudaDeviceGetAttribute(&out4[i], attrs[i], dev);
  return static_cast<int>(e);
}

MK_ERROR_STRING_EXPORT
