// The ReLU trunk shared by the radiance kernels: K3 (radiance_norm.cu,
// radiance_norm_bwd.cu, the gradient normalised in-kernel), K8a
// (radiance_split.cu, radiance_split_bwd.cu, the raw gradient as an operand)
// and K8b (radiance_mlp.cu, radiance_mlp_bwd.cu, one concatenated input).
// Its SIMT kernels below run their float32 paths (float32 FMAs on the CUDA
// cores); their bf16 paths run on the tensor cores (radiance_tc.cuh,
// radiance_bwd_tc.cuh) with the same segments (RadIn).
//
// The layer-0 input row is assembled in shared memory from up to four
// column segments (RadIn), each read from device memory once: K3 and K8a
// take [points | view PE] (ds), the normals (3), the features (F) and the
// per-image code (C), in W0's natural row order; K8b takes one segment, the
// whole row. The normals segment of K3 is the normalised gradient, n = g /
// (sqrt(max(|g|^2, 1e-24)) + 1e-6), computed here. The last layer is acc +
// bias.
//
// Shared memory of a block (64 rows): the input row (64 x LDH), one hidden
// layer (64 x LDY), the weight stage, the narrow output and the rows'
// normals. The hidden layers alternate between the hidden buffer and the
// input row's space, which is free once layer 0 has read it.
//
// The SIMT backward runs a persistent grid (one float32 dW partial per
// block, summed by reduce_partials in block order); it recomputes the
// hidden layers, keeps at most two of them, and runs the reverse sweep in
// place over them: the top cotangent co gives db and dW; each lower
// cotangent CT_l = (CT_{l+1} W^T) [y_l > 0] gives db_l and dW_l. At layer 0
// the input row is rebuilt, dW0 = h0^T CT_0, and CT_0 W0^T is written to
// each segment's cotangent output (none for a segment without one); K3's
// normals columns stay in shared memory for the normalise backward.
#pragma once

#include "common.cuh"

namespace mk {

constexpr int LDH = 336;     // input row stride: d0 up to 336 (321 with a 32-wide code)
constexpr int LDY = TILE_N;  // hidden layer row stride: widths up to 256
constexpr int NRM = 8;       // per-row normals scratch: n (3), g (3), |g|^2, q
constexpr int MAX_SEG = 4;
constexpr size_t RAD_SMEM_FLOATS =
    TILE_M * LDY + TILE_M * LDH + KT * TILE_N + TILE_M * 4 + TILE_M * NRM;

// One column segment of the layer-0 input: (N, width) row-major at p.
struct RadSeg {
  const void* p;
  int width;
  int f32;  // 1: float32 in memory; 0: the operand type (the tensor-core
            // kernels' bf16; float32 for these)
};

struct RadIn {
  RadSeg seg[MAX_SEG];
  int nseg;
  int d0;        // the sum of the widths
  int norm_seg;  // the segment normalised in-kernel (a float32 (N, 3) gradient), or -1
};

// The segments' cotangent outputs, (N, width) each (nullptr: none).
struct RadOut {
  void* p[MAX_SEG];
  int f32[MAX_SEG];
};

// Smem layout: Y0 (TILE_M x LDY) | H (TILE_M x LDH) | Ws | Zc (TILE_M x 4) | Nr.
struct RadSmem {
  float *Y0, *H, *Ws, *Zc, *Nr;
  __device__ explicit RadSmem(float* s)
      : Y0(s), H(s + TILE_M * LDY), Ws(H + TILE_M * LDH), Zc(Ws + KT * TILE_N),
        Nr(Zc + TILE_M * 4) {}
};

// Nr <- per row of the tile: n = g / q, g, |g|^2, q from the norm segment.
__device__ __forceinline__ void rad_normals(const RadIn& in, int N, int row0, float* Nr) {
  const int tid = threadIdx.x;
  if (in.norm_seg < 0 || tid >= TILE_M) return;
  const float* g = static_cast<const float*>(in.seg[in.norm_seg].p);
  const int r = row0 + tid;
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  if (r < N) {
    g0 = g[(size_t)r * 3];
    g1 = g[(size_t)r * 3 + 1];
    g2 = g[(size_t)r * 3 + 2];
  }
  const float sq = g0 * g0 + g1 * g1 + g2 * g2;
  const float q = sqrtf(fmaxf(sq, 1e-24f)) + 1e-6f;
  float* nr = Nr + tid * NRM;
  nr[0] = g0 / q;
  nr[1] = g1 / q;
  nr[2] = g2 / q;
  nr[3] = g0;
  nr[4] = g1;
  nr[5] = g2;
  nr[6] = sq;
  nr[7] = q;
}

// H <- the tile's layer-0 input rows, zero past N and in the pad columns up
// to round_up(d0, KT). Nr must be ready.
__device__ void rad_build_h0(float* H, const RadIn& in, const float* Nr, int N, int row0) {
  int c0 = 0;
  for (int s = 0; s < in.nseg; ++s) {
    const RadSeg& sg = in.seg[s];
    const int w = sg.width;
    for (int idx = threadIdx.x; idx < TILE_M * w; idx += THREADS) {
      const int r = idx / w, c = idx - r * w;
      const size_t gr = (size_t)(row0 + r);
      float v = 0.0f;
      if (row0 + r < N) {
        v = s == in.norm_seg ? Nr[r * NRM + c] : static_cast<const float*>(sg.p)[gr * w + c];
      }
      H[r * LDH + c0 + c] = v;
    }
    c0 += w;
  }
  const int pad = round_up(in.d0, KT) - in.d0;
  for (int idx = threadIdx.x; idx < TILE_M * pad; idx += THREADS) {
    const int r = idx / pad;
    H[r * LDH + in.d0 + (idx - r * pad)] = 0.0f;
  }
}

// dst <- relu(A W + b) (TILE_M x nout, ld LDY), pad columns up to
// round_up(nout, KT) zero.
__device__ __forceinline__ void rad_hidden(const float* A, int lda, int K, const float* W,
                                           const float* bias, int nout, float* Ws, float* dst) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[8][8];
  gemm_tile<false>(A, lda, K, W, nout, 0, nout, Ws, acc);
  const int Knext = round_up(nout, KT);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tile_col(tx, j);
    if (c < Knext) {
      const float bc = c < nout ? bias[c] : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float y = c < nout ? acc[i][j] + bc : 0.0f;
        dst[(ty * 8 + i) * LDY + c] = fmaxf(y, 0.0f);
      }
    }
  }
}

// The forward: one 64-row tile per block. out (N, nout) float32 gets the
// last layer's acc + bias; nrm_out (N, 3), when given, K3's normals.
__device__ void rad_forward(const RadIn& in, int N, const MlpDesc& d, const float* P,
                            float* __restrict__ out, float* __restrict__ nrm_out, float* smem) {
  RadSmem sm(smem);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TILE_M;
  rad_normals(in, N, row0, sm.Nr);
  __syncthreads();
  if (nrm_out != nullptr && tid < TILE_M && row0 + tid < N) {
#pragma unroll
    for (int k = 0; k < 3; ++k) nrm_out[(size_t)(row0 + tid) * 3 + k] = sm.Nr[tid * NRM + k];
  }
  rad_build_h0(sm.H, in, sm.Nr, N, row0);
  const int L = d.n_layers;
  const float* cur = sm.H;
  int ldc = LDH;
  for (int l = 0; l < L - 1; ++l) {
    float* dst = (l % 2 == 0) ? sm.Y0 : sm.H;  // the input row is free after layer 0
    rad_hidden(cur, ldc, d.kin[l], P + d.woff[l], P + d.boff[l], d.nout[l], sm.Ws, dst);
    cur = dst;
    ldc = LDY;
  }
  __syncthreads();
  const int nout = d.nout[L - 1];
  const float* bias = P + d.boff[L - 1];
  gemm_narrow<false>(cur, ldc, d.kin[L - 1], P + d.woff[L - 1], nout, 0, nout, TILE_M, sm.Zc);
  __syncthreads();
  for (int idx = tid; idx < TILE_M * nout; idx += THREADS) {
    const int r = idx / nout, j = idx - r * nout;
    if (row0 + r < N) out[(size_t)(row0 + r) * nout + j] = sm.Zc[r * 4 + j] + bias[j];
  }
}

// Over a cotangent (TILE_M x n, ld LDY, ReLU mask applied): db += its
// column sums; the pad columns up to round_up(n, KT) zeroed in place.
__device__ __forceinline__ void rad_finish_ct(float* ct, int n, float* db) {
  const int Kp = round_up(n, KT);
  for (int c = threadIdx.x; c < Kp; c += THREADS) {
    if (c >= n) {
      for (int r = 0; r < TILE_M; ++r) ct[r * LDY + c] = 0.0f;
      continue;
    }
    float s = 0.0f;
    for (int r = 0; r < TILE_M; ++r) s += ct[r * LDY + c];
    db[c] += s;
  }
}

// The backward over a persistent grid. co (N, nout) float32. work: one
// partial of n_params floats per block; the caller sums them
// (reduce_partials). K3 (norm_seg >= 0): cn (N, 3), and dg (N, 3) from the
// normalise backward with both normal cotangents summed: dn = cn + CT_0
// W0_n^T, dg = dn/q - g (<dn, g> / (q^2 r)) [|g|^2 > 1e-24], r =
// sqrt(max(|g|^2, 1e-24)), q = r + 1e-6.
__device__ void rad_backward(const RadIn& in, const RadOut& o, int N, const MlpDesc& d,
                             const float* P, const float* PT, const float* co,
                             const float* cn, float* __restrict__ dg_out, float* work,
                             int n_params, float* smem) {
  RadSmem sm(smem);
  float* Y[2] = {sm.Y0, sm.H};  // the hidden layers' ReLU outputs, then their cotangents
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int L = d.n_layers, H = L - 1;
  const int n_out = d.nout[L - 1];
  const int n0 = d.nout[0];
  const int n_tiles = (N + TILE_M - 1) / TILE_M;
  // the first column with a cotangent output (K3's normals count as one)
  int first_out = in.d0;
  for (int s = in.nseg - 1, c0 = in.d0; s >= 0; --s) {
    c0 -= in.seg[s].width;
    if (o.p[s] != nullptr || s == in.norm_seg) first_out = c0;
  }
  float* part = work + (size_t)blockIdx.x * n_params;
  zero_partial(part, n_params);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE_M;
    __syncthreads();  // the previous tile is done with shared memory
    rad_normals(in, N, row0, sm.Nr);
    __syncthreads();
    rad_build_h0(sm.H, in, sm.Nr, N, row0);

    // ---- forward: the hidden layers' ReLU outputs (layer 1's over h0) ---
    const float* cur = sm.H;
    int ldc = LDH;
    for (int l = 0; l < H; ++l) {
      rad_hidden(cur, ldc, d.kin[l], P + d.woff[l], P + d.boff[l], d.nout[l], sm.Ws, Y[l]);
      cur = Y[l];
      ldc = LDY;
    }

    // ---- output layer: db and dW from co --------------------------------
    for (int idx = tid; idx < TILE_M * n_out; idx += THREADS) {
      const int r = idx / n_out, j = idx - r * n_out;
      sm.Zc[r * 4 + j] = row0 + r < N ? co[(size_t)(row0 + r) * n_out + j] : 0.0f;
    }
    __syncthreads();
    float* top = Y[H - 1];
    {
      const int kin = d.kin[L - 1];
      const float* W = P + d.woff[L - 1];
      for (int j = tid; j < n_out; j += THREADS) {
        float s = 0.0f;
        for (int r = 0; r < TILE_M; ++r) s += sm.Zc[r * 4 + j];
        part[d.boff[L - 1] + j] += s;
      }
      for (int k = tid; k < kin; k += THREADS) {
        for (int j = 0; j < n_out; ++j) {
          float s = 0.0f;
          for (int r = 0; r < TILE_M; ++r) s = fmaf(top[r * LDY + k], sm.Zc[r * 4 + j], s);
          part[d.woff[L - 1] + k * n_out + j] += s;
        }
      }
      __syncthreads();  // every row of the top layer read: overwrite it in place
      for (int idx = tid; idx < TILE_M * kin; idx += THREADS) {
        const int r = idx / kin, c = idx - r * kin;
        float s = 0.0f;
        for (int j = 0; j < n_out; ++j) s = fmaf(sm.Zc[r * 4 + j], W[c * n_out + j], s);
        top[r * LDY + c] = top[r * LDY + c] > 0.0f ? s : 0.0f;
      }
    }
    __syncthreads();
    rad_finish_ct(top, d.kin[L - 1], part + d.boff[H - 1]);

    // ---- hidden layers, top down: CT_{l-1} in place over Y[l-1] --------
    for (int l = H - 1; l >= 1; --l) {
      const int kin = d.kin[l], nout = d.nout[l];
      __syncthreads();
      accum_dw(Y[l - 1], LDY, Y[l], LDY, TILE_M, kin, 0, nout, part + d.woff[l], nout);
      float acc[8][8];
      gemm_tile<false>(Y[l], LDY, nout, PT + d.woff[l], kin, 0, kin, sm.Ws, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(tx, j);
        if (c < kin) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float* p = Y[l - 1] + (ty * 8 + i) * LDY + c;
            *p = *p > 0.0f ? acc[i][j] : 0.0f;
          }
        }
      }
      __syncthreads();
      rad_finish_ct(Y[l - 1], kin, part + d.boff[l - 1]);
    }

    // ---- layer 0: dW0 from the rebuilt input row, the input cotangents --
    __syncthreads();  // CT_0 (in Y0) is final; H is free
    rad_build_h0(sm.H, in, sm.Nr, N, row0);
    __syncthreads();
    accum_dw(sm.H, LDH, sm.Y0, LDY, TILE_M, in.d0, 0, n0, part + d.woff[0], n0);
    const float* WT0 = PT + d.woff[0];  // n0 x d0
    for (int c0 = first_out; c0 < in.d0; c0 += TILE_N) {
      const int ncols = min(TILE_N, in.d0 - c0);
      float acc[8][8];
      gemm_tile<false>(sm.Y0, LDY, n0, WT0, in.d0, c0, ncols, sm.Ws, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cj = tile_col(tx, j);
        if (cj >= ncols) continue;
        int s = 0, cc = c0 + cj;
        while (s < in.nseg - 1 && cc >= in.seg[s].width) cc -= in.seg[s++].width;
        const int w = in.seg[s].width;
        if (s == in.norm_seg) {
#pragma unroll
          for (int i = 0; i < 8; ++i) sm.Zc[(ty * 8 + i) * 4 + cc] = acc[i][j];
        } else if (o.p[s] != nullptr) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = row0 + ty * 8 + i;
            if (r < N) static_cast<float*>(o.p[s])[(size_t)r * w + cc] = acc[i][j];
          }
        }
      }
    }
    if (in.norm_seg < 0) continue;
    __syncthreads();  // dn (Zc) is written
    if (tid < TILE_M && row0 + tid < N) {
      const size_t gr = (size_t)(row0 + tid);
      const float* nr = sm.Nr + tid * NRM;
      const float sq = nr[6], q = nr[7];
      const float r = sqrtf(fmaxf(sq, 1e-24f));
      const float live = sq > 1e-24f ? 1.0f : 0.0f;
      float dn[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) dn[k] = cn[gr * 3 + k] + sm.Zc[tid * 4 + k];
      const float dot_cg = dn[0] * nr[3] + dn[1] * nr[4] + dn[2] * nr[5];
      const float f = dot_cg / (q * q * r);
#pragma unroll
      for (int k = 0; k < 3; ++k) dg_out[gr * 3 + k] = dn[k] / q - nr[3 + k] * f * live;
    }
  }
}

}  // namespace mk
