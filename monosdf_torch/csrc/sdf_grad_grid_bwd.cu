// K7b: the second-order backward of the hash-grid trunk, with the input
// cotangents.
//
// Replaces monosdf_tpu/ops/pallas_sdf_grad_grid.py _bwd_pallas_a0
// (pl.pallas_call at :351), the VJP of sdf_mlp_with_grad_in. Inputs: the
// layer-0 input a0 (4, N, d0) float32 (primal rows, then the tangents along
// x, y, z), the forward's saved pre-activations Z (z.p[l], (4, N, nout_l) at
// the operand type), and the output cotangents c_sdf (N, 1), c_feat (N, F),
// c_grad (N, 3) at the operand type. Outputs: the parameter gradients in
// the packed-weight layout (csrc/common.cuh MlpDesc), and da0 (4, N, d0)
// float32, the cotangent of a0: its primal rows carry d loss / d[PE |
// features], the path the table gradient takes through the encode's
// transpose (K5), its tangent rows d loss / d(input tangents), the
// eikonal's second-order path into the table.
//
// The structure is K2b's (sdf_grad_bwd.cu): a tile is PTS points, 64 stacked
// rows; per tile, from the last layer down,
//   last layer: CT = [c_sdf | c_feat] on the primal rows, c_grad_k in the
//     SDF column of tangent row k;
//   hidden layer l (s = sigmoid(100 z), u_k the tangent rows of Z[l]):
//     ct_z = ct_h*s + (sum_k ct_t_k*u_k)*100 s(1-s),  ct_u_k = s*ct_t_k;
//   dW_l += A_l^T CT, db_l += sum of CT's primal rows (float32, before CT is
//     rounded to the operand type), ct_A = CT W_l^T;
// and at layer 0 ct_A is da0. No skip, no clamp. The grid is persistent (one
// block per SM); each block adds its tiles' dW into its own float32 partial
// and reduce_partials sums the partials in block order, so two runs give the
// same bits.
//
// Limits: d0 <= 80 (LD0), hidden widths <= 256 (the 2x256 trunk fits; no
// depth limit from shared memory, which holds one layer at a time). Bound on
// the card: operations (about 1.7e11 FLOP at the bench's 104,448 points,
// twice the forward's); this first version runs float32 FMAs on the CUDA
// cores.
#include "common.cuh"

using namespace mk;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
sdf_grad_grid_bwd_kernel(const float* __restrict__ a0, int N, int d0, MlpDesc d,
                         const float* __restrict__ P, const float* __restrict__ PT,
                         const __grid_constant__ ZPtrs z,
                         const void* __restrict__ c_sdf, const void* __restrict__ c_feat,
                         const void* __restrict__ c_grad, float* __restrict__ work, int n_params,
                         float* __restrict__ da0) {
  extern __shared__ __align__(16) float smem[];
  float* X0 = smem;
  float* bufA = X0 + TILE_M * LD0;
  float* bufB = bufA + TILE_M * LDA;
  float* Ws = bufB + TILE_M * LDA;
  const int tid = threadIdx.x;
  const int L = d.n_layers;
  const int n_tiles = (N + PTS - 1) / PTS;
  float* part = work + (size_t)blockIdx.x * n_params;
  zero_partial(part, n_params);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * PTS;
    __syncthreads();  // the previous tile is done with shared memory
    load_a0_tile(a0, N, d0, p0, X0);
    __syncthreads();

    // ---- last layer ---------------------------------------------------
    int l = L - 1;
    int kin = d.kin[l], nout = d.nout[l];
    const int F = nout - 1;
    build_a_in<BF16>(bufA, l, d, z, X0, d0, N, p0);
    const int Kp_last = round_up(nout, KT);
    for (int idx = tid; idx < TILE_M * Kp_last; idx += THREADS) {
      const int r = idx / Kp_last, c = idx - r * Kp_last;
      const int p = r % PTS, k = r / PTS - 1;
      float v = 0.0f;
      if (p0 + p < N) {
        if (r < PTS) {
          if (c == 0) {
            v = load_act<BF16>(c_sdf, p0 + p);
          } else if (c < nout) {
            v = load_act<BF16>(c_feat, (size_t)(p0 + p) * F + (c - 1));
          }
        } else if (c == 0) {
          v = load_act<BF16>(c_grad, (size_t)(p0 + p) * 3 + k);
        }
      }
      bufB[r * LDA + c] = v;
    }
    __syncthreads();
    accum_db(bufB, LDA, PTS, nout, part + d.boff[l]);
    // SDF column over all rows; feature columns over the primal rows (the
    // tangent rows' cotangent is zero there)
    accum_dw_col(bufA, LDA, bufB, LDA, TILE_M, kin, 0, part + d.woff[l], nout);
    accum_dw(bufA, LDA, bufB, LDA, PTS, kin, 1, F, part + d.woff[l], nout);
    propagate<BF16>(bufB, nout, PT + d.woff[l], kin, d.nout[l - 1], false, Ws, bufA);
    float* ct = bufA;
    float* other = bufB;

    // ---- hidden layers ------------------------------------------------
    for (l = L - 2; l >= 0; --l) {
      kin = d.kin[l];
      nout = d.nout[l];
      const int Kp = round_up(nout, KT);
      const void* Zl = z.p[l];
      __syncthreads();  // ct is written
      for (int c = tid; c < Kp; c += THREADS) {
        if (c >= nout) {  // zero pad for the K loop of the next propagate
          for (int r = 0; r < TILE_M; ++r) ct[r * LDA + c] = 0.0f;
          continue;
        }
        float db = 0.0f;
        for (int p = 0; p < PTS; ++p) {
          float zv = 0.0f, u[3] = {0.0f, 0.0f, 0.0f};
          if (p0 + p < N) {
            zv = load_act<BF16>(Zl, (size_t)(p0 + p) * nout + c);
#pragma unroll
            for (int k = 0; k < 3; ++k)
              u[k] = load_act<BF16>(Zl, ((size_t)(k + 1) * N + p0 + p) * nout + c);
          }
          float h, s;
          gate100(zv, h, s);
          const float s2 = 100.0f * s * (1.0f - s);
          float* ch = &ct[p * LDA + c];
          float* t0 = &ct[(PTS + p) * LDA + c];
          float* t1 = &ct[(2 * PTS + p) * LDA + c];
          float* t2 = &ct[(3 * PTS + p) * LDA + c];
          const float ct_sum = *t0 * u[0] + *t1 * u[1] + *t2 * u[2];
          const float ct_z = *ch * s + ct_sum * s2;
          db += ct_z;
          *ch = rnd<BF16>(ct_z);
          *t0 = rnd<BF16>(s * *t0);
          *t1 = rnd<BF16>(s * *t1);
          *t2 = rnd<BF16>(s * *t2);
        }
        part[d.boff[l] + c] += db;
      }
      build_a_in<BF16>(other, l, d, z, X0, d0, N, p0);
      __syncthreads();
      accum_dw(other, LDA, ct, LDA, TILE_M, kin, 0, nout, part + d.woff[l], nout);
      // the cotangent of the layer's input: the previous layer's output, or a0
      propagate<BF16>(ct, nout, PT + d.woff[l], kin, kin, false, Ws, other);
      float* t = ct;
      ct = other;
      other = t;
    }

    // ct holds da0 for the tile's rows: row k*PTS + p is a0[k, p0 + p]
    __syncthreads();
    for (int idx = tid; idx < TILE_M * d0; idx += THREADS) {
      const int r = idx / d0, c = idx - r * d0;
      const int k = r / PTS, p = r - k * PTS;
      if (p0 + p < N) da0[((size_t)k * N + p0 + p) * d0 + c] = ct[r * LDA + c];
    }
  }
}

extern "C" int sdf_grad_grid_bwd_launch(const float* a0, int N, int d0, const int* desc,
                                        const float* P, const float* PT, void* const* z_in,
                                        const void* c_sdf, const void* c_feat,
                                        const void* c_grad, float* work, int grid, int n_params,
                                        float* out, float* da0, int bf16, void* stream) {
  const MlpDesc d = desc_from(desc);
  ZPtrs z;
  for (int l = 0; l < MK_MAX_LAYERS; ++l) z.p[l] = z_in[l];
  const size_t smem = MLP_SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaFuncSetAttribute(sdf_grad_grid_bwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    sdf_grad_grid_bwd_kernel<true><<<grid, THREADS, smem, s>>>(a0, N, d0, d, P, PT, z, c_sdf, c_feat,
                                                               c_grad, work, n_params, da0);
  } else {
    cudaFuncSetAttribute(sdf_grad_grid_bwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    sdf_grad_grid_bwd_kernel<false><<<grid, THREADS, smem, s>>>(a0, N, d0, d, P, PT, z, c_sdf, c_feat,
                                                                c_grad, work, n_params, da0);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<(n_params + THREADS - 1) / THREADS, THREADS, 0, s>>>(work, grid, n_params, out);
  return static_cast<int>(cudaGetLastError());
}

MK_ERROR_STRING_EXPORT
