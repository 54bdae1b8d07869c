// Shared pieces of the hash-grid encode kernels (hash_encode.cu, K6, and
// hash_encode_bwd.cu, K5): the per-level constants and one (point, level)'s
// corner rows, weights and weight derivatives (ops/hashgrid.py
// corner_geometry is the plain version).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HG_MAX_LEVELS 32

namespace hg {

constexpr int THREADS = 256;

// Per-level constants, passed as a __grid_constant__ kernel parameter.
// Corner (x, y, z) of level l lies at table row offset[l] + ((x + y*s1[l] +
// z*s2[l]) mod hms[l]), or with is_xor[l], ((x ^ y*P1 ^ z*P2) mod hms[l]),
// in uint32 arithmetic. Table rows hold 2 channels.
struct HashLevels {
  int n_levels;  // levels of the schedule (output columns / 2)
  int offset[HG_MAX_LEVELS];
  unsigned hms[HG_MAX_LEVELS];
  unsigned s1[HG_MAX_LEVELS];
  unsigned s2[HG_MAX_LEVELS];
  int is_xor[HG_MAX_LEVELS];
  float res[HG_MAX_LEVELS];     // grid coordinates are clipped to [0, res]
  float fscale[HG_MAX_LEVELS];  // x01 -> grid position
  float dscale[HG_MAX_LEVELS];  // d grid position / d x: fscale / (2 size) * tangent scale
};

inline HashLevels levels_from(const int* d, const float* f) {
  HashLevels h;
  h.n_levels = d[0];
  for (int l = 0; l < HG_MAX_LEVELS; ++l) {
    h.offset[l] = d[1 + l];
    h.hms[l] = static_cast<unsigned>(d[1 + HG_MAX_LEVELS + l]);
    h.s1[l] = static_cast<unsigned>(d[1 + 2 * HG_MAX_LEVELS + l]);
    h.s2[l] = static_cast<unsigned>(d[1 + 3 * HG_MAX_LEVELS + l]);
    h.is_xor[l] = d[1 + 4 * HG_MAX_LEVELS + l];
    h.res[l] = f[l];
    h.fscale[l] = f[HG_MAX_LEVELS + l];
    h.dscale[l] = f[2 * HG_MAX_LEVELS + l];
  }
  return h;
}

// One (point, level): returns false for a point outside [0,1]^3 (after
// x01 = (x + size) / (2 size)), which encodes to zero. Otherwise row[c] is
// corner c's table row (corner c has offset bit d = (c >> d) & 1 along axis
// d), W[c] its weight prod_d (w_d or 1 - w_d) with smoothstep w, and
// dW[k][c] the weight's derivative along axis k.
__device__ __forceinline__ bool corners(const HashLevels& h, int l, const float* xp, float size,
                                        unsigned row[8], float W[8], float dW[3][8]) {
  float w[3], omw[3], dw[3];
  unsigned g[3];
  bool inb = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float x01 = (xp[d] + size) / (2.0f * size);
    inb = inb && x01 >= 0.0f && x01 <= 1.0f;
    const float pos = x01 * h.fscale[l];
    const float pg = fminf(fmaxf(floorf(pos), 0.0f), h.res[l]);
    const float v = fminf(fmaxf(pos - pg, 0.0f), 1.0f);
    w[d] = v * v * (3.0f - 2.0f * v);
    omw[d] = 1.0f - w[d];
    dw[d] = 6.0f * v * (1.0f - v) * h.dscale[l];
    g[d] = static_cast<unsigned>(pg);
  }
  if (!inb) return false;
  const unsigned hms = h.hms[l], off = static_cast<unsigned>(h.offset[l]);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned cx = g[0] + (c & 1), cy = g[1] + ((c >> 1) & 1), cz = g[2] + ((c >> 2) & 1);
    const unsigned idx = h.is_xor[l] ? (cx ^ (cy * 2654435761u) ^ (cz * 805459861u))
                                     : (cx + cy * h.s1[l] + cz * h.s2[l]);
    row[c] = off + idx % hms;
    const float f0 = (c & 1) ? w[0] : omw[0];
    const float f1 = ((c >> 1) & 1) ? w[1] : omw[1];
    const float f2 = ((c >> 2) & 1) ? w[2] : omw[2];
    const float d0 = (c & 1) ? dw[0] : -dw[0];
    const float d1 = ((c >> 1) & 1) ? dw[1] : -dw[1];
    const float d2 = ((c >> 2) & 1) ? dw[2] : -dw[2];
    W[c] = f0 * f1 * f2;
    dW[0][c] = d0 * f1 * f2;
    dW[1][c] = f0 * d1 * f2;
    dW[2][c] = f0 * f1 * d2;
  }
  return true;
}

}  // namespace hg
