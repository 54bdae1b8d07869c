// M: the strided-slice and lane-permutation product probe.
//
// Replaces the Pallas kernel of scripts/probe_hash_primitives.py wave 7 (f)
// (sk, pl.pallas_call at :936):
//   out = sum_{beta = 0..8} x[beta::8][:n_out] @ P,
// x (>= 8 n_out + 1, 128) float32, P (128, 128) float32 (the probe's 0/1
// lane permutation), out (n_out, 128) float32, the nine products added in
// beta order in float32, as the TPU kernel's acc +=. The TPU kernel computes
// the products on its matrix unit in its own body; so does this one, on the
// CUDA cores: a block of 128 threads (one per output lane) stages P (64 KB)
// and the 8 MR + 1 rows of x that its MR output rows read, then each thread
// runs its column's dot products over 128 in float32 (fmaf), beta after
// beta. With a 0/1 permutation every dot product has one nonzero term, so
// the result equals the TPU's and the plain version's exactly.
//
// Bound on the card: operations (2 * 9 * n_out * 128 * 128 float32 FLOP
// against the bytes of x, P and out).
#include "common.cuh"

namespace {

constexpr int MR = 8;  // output rows per block
constexpr int XR = 8 * MR + 1;
constexpr size_t SMEM = (128 * 128 + XR * 128) * sizeof(float);

__global__ void __launch_bounds__(128)
strided_permute_kernel(const float* __restrict__ x, const float* __restrict__ P, int n_out,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  float* Ps = sm;
  float* xs = sm + 128 * 128;
  const int r0 = blockIdx.x * MR;
  const int nr = min(MR, n_out - r0);
  const int nx = 8 * (nr - 1) + 9;  // x rows 8 r0 .. 8 (r0 + nr - 1) + 8
  const float4* P4 = reinterpret_cast<const float4*>(P);
  const float4* x4 = reinterpret_cast<const float4*>(x + static_cast<size_t>(8) * r0 * 128);
  for (int i = threadIdx.x; i < 128 * 32; i += 128) reinterpret_cast<float4*>(Ps)[i] = P4[i];
  for (int i = threadIdx.x; i < nx * 32; i += 128) reinterpret_cast<float4*>(xs)[i] = x4[i];
  __syncthreads();
  const int l = threadIdx.x;
  for (int rr = 0; rr < nr; ++rr) {
    float acc = 0.0f;
    for (int beta = 0; beta < 9; ++beta) {
      const float* xr = xs + (8 * rr + beta) * 128;
      float p = 0.0f;
#pragma unroll 8
      for (int k = 0; k < 128; ++k) p = fmaf(xr[k], Ps[k * 128 + l], p);
      acc += p;
    }
    out[static_cast<size_t>(r0 + rr) * 128 + l] = acc;
  }
}

}  // namespace

extern "C" int probe_strided_permute_launch(const float* x, const float* P, int n_out, float* out,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(strided_permute_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  if (n_out == 0) return 0;
  strided_permute_kernel<<<(n_out + MR - 1) / MR, 128, SMEM, s>>>(x, P, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
