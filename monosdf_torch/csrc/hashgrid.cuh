// Shared pieces of the hash-grid encode kernels (hash_encode.cu, K6, and
// hash_encode_bwd.cu, K5): the per-level constants, a point's unit-box
// coordinates and one (point, level)'s corner rows, weights and weight
// derivatives (ops/hashgrid.py corner_geometry is the plain version).
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
// in uint32 arithmetic. Table rows hold 2 channels. The modulo is exact
// integer arithmetic without a division: idx & mask[l] where hms[l] is a
// power of two (magic[l] == 0), else idx - q hms[l] with the quotient q by
// a 32-bit multiply-high, t = mulhi(magic, idx), q = ((idx - t) / 2 + t) >>
// shift, magic = floor(2^(33 + shift) / hms) + 1 - 2^32, shift =
// floor(log2 hms) (exact for every 32-bit idx; kernels/hash_encode.py
// level_mod is its host twin).
struct HashLevels {
  int n_levels;  // levels of the schedule (output columns / 2)
  int offset[HG_MAX_LEVELS];
  unsigned hms[HG_MAX_LEVELS];
  unsigned s1[HG_MAX_LEVELS];
  unsigned s2[HG_MAX_LEVELS];
  int is_xor[HG_MAX_LEVELS];
  unsigned mask[HG_MAX_LEVELS];
  unsigned magic[HG_MAX_LEVELS];
  int shift[HG_MAX_LEVELS];
  float res[HG_MAX_LEVELS];     // grid coordinates are clipped to [0, res]
  float fscale[HG_MAX_LEVELS];  // x01 -> grid position
  float dscale[HG_MAX_LEVELS];  // d grid position / d x: fscale / (2 size) * tangent scale
};

// The int descriptor: [L, offset, hms, s1, s2, is_xor, mask, magic, shift]
// (32 entries each after L); the float one: [res, fscale, dscale].
inline HashLevels levels_from(const int* d, const float* f) {
  HashLevels h;
  h.n_levels = d[0];
  for (int l = 0; l < HG_MAX_LEVELS; ++l) {
    h.offset[l] = d[1 + l];
    h.hms[l] = static_cast<unsigned>(d[1 + HG_MAX_LEVELS + l]);
    h.s1[l] = static_cast<unsigned>(d[1 + 2 * HG_MAX_LEVELS + l]);
    h.s2[l] = static_cast<unsigned>(d[1 + 3 * HG_MAX_LEVELS + l]);
    h.is_xor[l] = d[1 + 4 * HG_MAX_LEVELS + l];
    h.mask[l] = static_cast<unsigned>(d[1 + 5 * HG_MAX_LEVELS + l]);
    h.magic[l] = static_cast<unsigned>(d[1 + 6 * HG_MAX_LEVELS + l]);
    h.shift[l] = d[1 + 7 * HG_MAX_LEVELS + l];
    h.res[l] = f[l];
    h.fscale[l] = f[HG_MAX_LEVELS + l];
    h.dscale[l] = f[2 * HG_MAX_LEVELS + l];
  }
  return h;
}

// One level's constants, staged in shared memory by every block: a warp's
// lanes work on different levels, and reading HashLevels' arrays in the
// parameter space at a different index per lane serializes the constant
// cache. 11 words a level, so lanes on different levels hit different banks.
struct Level {
  unsigned off, hms, s1, s2, mask, magic;
  int is_xor, shift;
  float res, fscale, dscale;
};

// sl[l] <- level l's constants, for l < n_levels; the caller syncs after.
__device__ __forceinline__ void stage_levels(const HashLevels& h, Level* sl) {
  for (int l = threadIdx.x; l < h.n_levels; l += blockDim.x) {
    sl[l] = Level{static_cast<unsigned>(h.offset[l]), h.hms[l], h.s1[l], h.s2[l], h.mask[l],
                  h.magic[l], h.is_xor[l], h.shift[l], h.res[l], h.fscale[l], h.dscale[l]};
  }
}

// x01 = (x + size) / (2 size) per axis; false for a point outside [0,1]^3,
// which encodes to zero.
__device__ __forceinline__ bool unit_coords(const float* xp, float size, float x01[3]) {
  bool inb = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x01[d] = (xp[d] + size) / (2.0f * size);
    inb = inb && x01[d] >= 0.0f && x01[d] <= 1.0f;
  }
  return inb;
}

// idx mod hms, exactly (see HashLevels)
__device__ __forceinline__ unsigned level_mod(const Level& lv, unsigned idx) {
  const unsigned t = __umulhi(lv.magic, idx);
  const unsigned q = (((idx - t) >> 1) + t) >> lv.shift;
  return lv.magic == 0u ? idx & lv.mask : idx - q * lv.hms;
}

// One (point, level) of an in-box point at x01: row[c] is corner c's table
// row (corner c has offset bit d = (c >> d) & 1 along axis d), W[c] its
// weight prod_d (w_d or 1 - w_d) with smoothstep w, and dW[k][c] the
// weight's derivative along axis k.
__device__ __forceinline__ void corners(const Level& lv, const float x01[3], unsigned row[8],
                                        float W[8], float dW[3][8]) {
  float w[3], omw[3], dw[3];
  unsigned g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = x01[d] * lv.fscale;
    const float pg = fminf(fmaxf(floorf(pos), 0.0f), lv.res);
    const float v = fminf(fmaxf(pos - pg, 0.0f), 1.0f);
    w[d] = v * v * (3.0f - 2.0f * v);
    omw[d] = 1.0f - w[d];
    dw[d] = 6.0f * v * (1.0f - v) * lv.dscale;
    g[d] = static_cast<unsigned>(pg);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned cx = g[0] + (c & 1), cy = g[1] + ((c >> 1) & 1), cz = g[2] + ((c >> 2) & 1);
    const unsigned idx = lv.is_xor ? (cx ^ (cy * 2654435761u) ^ (cz * 805459861u))
                                   : (cx + cy * lv.s1 + cz * lv.s2);
    row[c] = lv.off + level_mod(lv, idx);
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
}

}  // namespace hg
