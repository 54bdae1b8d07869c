// Native marching-tetrahedra iso-surface extraction.
//
// C++ twin of monosdf_torch/meshing/marching.py (same 6-tet checkerboard
// decomposition, same case table, same zero-crossing interpolation and
// orientation rule), replacing the reference's skimage measure.marching_cubes
// host dependency (reference code/utils/plots.py:196-226). Differences from
// the NumPy path: streaming per-cube evaluation (no 8x grid corner stack in
// memory) and on-the-fly vertex welding via a global edge hash, so the output
// is already deduplicated — O(active cubes) memory instead of O(grid).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// 6-tet decomposition of a unit cube; corner index = ix + 2*iy + 4*iz.
// Mirrored (c -> 7-c) on odd-parity cubes so face diagonals agree between
// neighbours (crack-free surface). Must match marching.py _TETS_BY_PARITY.
const int TETS_BY_PARITY[2][6][4] = {
    {{0, 5, 1, 3}, {0, 5, 3, 7}, {0, 7, 3, 2},
     {0, 7, 2, 6}, {0, 6, 4, 7}, {0, 4, 5, 7}},
    {{7, 2, 6, 4}, {7, 2, 4, 0}, {7, 0, 4, 5},
     {7, 0, 5, 1}, {7, 1, 3, 0}, {7, 3, 2, 0}},
};

// Tet edges (pairs of local tet-corner indices). Must match _TET_EDGES.
const int TET_EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// For each 4-bit inside mask: up to 2 triangles of tet-edge indices (-1 pad).
// Must match marching.py _CASE_TRIS.
const int CASE_TABLE[16][2][3] = {
    /*0000*/ {{-1, -1, -1}, {-1, -1, -1}},
    /*0001*/ {{0, 1, 2}, {-1, -1, -1}},
    /*0010*/ {{0, 3, 4}, {-1, -1, -1}},
    /*0011*/ {{1, 2, 3}, {3, 2, 4}},
    /*0100*/ {{1, 3, 5}, {-1, -1, -1}},
    /*0101*/ {{0, 2, 3}, {3, 2, 5}},
    /*0110*/ {{0, 1, 4}, {4, 1, 5}},
    /*0111*/ {{2, 4, 5}, {-1, -1, -1}},
    /*1000*/ {{2, 4, 5}, {-1, -1, -1}},
    /*1001*/ {{0, 1, 4}, {4, 1, 5}},
    /*1010*/ {{0, 2, 3}, {3, 2, 5}},
    /*1011*/ {{1, 3, 5}, {-1, -1, -1}},
    /*1100*/ {{1, 2, 3}, {3, 2, 4}},
    /*1101*/ {{0, 3, 4}, {-1, -1, -1}},
    /*1110*/ {{0, 1, 2}, {-1, -1, -1}},
    /*1111*/ {{-1, -1, -1}, {-1, -1, -1}},
};

// Cube-corner offsets, corner index = ix + 2*iy + 4*iz.
const int CORNER_OFF[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

struct Extractor {
  const float* sdf;
  int64_t nx, ny, nz;
  const float* origin;
  const float* spacing;
  float level;

  std::vector<float> verts;     // flat (V, 3)
  std::vector<int64_t> faces;   // flat (F, 3)
  // edge (global node a, b) -> welded vertex id
  std::unordered_map<uint64_t, int64_t> edge_vertex;

  inline float val(int64_t i, int64_t j, int64_t k) const {
    return sdf[(i * ny + j) * nz + k] - level;
  }
  inline int64_t node_id(int64_t i, int64_t j, int64_t k) const {
    return (i * ny + j) * nz + k;
  }

  // Vertex at the zero crossing of global edge (na, nb); welds by edge key.
  int64_t edge_vert(int64_t ga[3], float sa, int64_t gb[3], float sb) {
    int64_t na = node_id(ga[0], ga[1], ga[2]);
    int64_t nb = node_id(gb[0], gb[1], gb[2]);
    uint64_t key = na < nb
        ? (uint64_t)na * (uint64_t)(nx * ny * nz) + (uint64_t)nb
        : (uint64_t)nb * (uint64_t)(nx * ny * nz) + (uint64_t)na;
    auto it = edge_vertex.find(key);
    if (it != edge_vertex.end()) return it->second;

    float denom = sa - sb;
    if (std::fabs(denom) < 1e-12f) denom = 1e-12f;
    float t = sa / denom;
    t = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
    int64_t vid = (int64_t)(verts.size() / 3);
    for (int d = 0; d < 3; ++d) {
      float pa = origin[d] + spacing[d] * (float)ga[d];
      float pb = origin[d] + spacing[d] * (float)gb[d];
      verts.push_back(pa + t * (pb - pa));
    }
    edge_vertex.emplace(key, vid);
    return vid;
  }

  void run() {
    int64_t corner_g[8][3];
    float corner_s[8];
    for (int64_t i = 0; i + 1 < nx; ++i) {
      for (int64_t j = 0; j + 1 < ny; ++j) {
        for (int64_t k = 0; k + 1 < nz; ++k) {
          bool any_neg = false, any_pos = false;
          for (int c = 0; c < 8; ++c) {
            int64_t gi = i + CORNER_OFF[c][0];
            int64_t gj = j + CORNER_OFF[c][1];
            int64_t gk = k + CORNER_OFF[c][2];
            corner_g[c][0] = gi; corner_g[c][1] = gj; corner_g[c][2] = gk;
            corner_s[c] = val(gi, gj, gk);
            (corner_s[c] < 0.f ? any_neg : any_pos) = true;
          }
          if (!any_neg || !any_pos) continue;

          const int parity = (int)((i + j + k) & 1);
          for (int t = 0; t < 6; ++t) {
            const int* tet = TETS_BY_PARITY[parity][t];
            int mask = 0;
            for (int c = 0; c < 4; ++c)
              if (corner_s[tet[c]] < 0.f) mask |= 1 << c;
            if (mask == 0 || mask == 15) continue;

            // Orientation data: outward = centroid(out) - centroid(in),
            // same rule as marching.py:137-144.
            float cin[3] = {0, 0, 0}, cout[3] = {0, 0, 0};
            int nin = 0, nout = 0;
            for (int c = 0; c < 4; ++c) {
              const int cc = tet[c];
              float p[3];
              for (int d = 0; d < 3; ++d)
                p[d] = origin[d] + spacing[d] * (float)corner_g[cc][d];
              if (corner_s[cc] < 0.f) {
                for (int d = 0; d < 3; ++d) cin[d] += p[d];
                ++nin;
              } else {
                for (int d = 0; d < 3; ++d) cout[d] += p[d];
                ++nout;
              }
            }
            float outward[3];
            for (int d = 0; d < 3; ++d)
              outward[d] = cout[d] / (float)nout - cin[d] / (float)nin;

            for (int s = 0; s < 2; ++s) {
              const int* tri = CASE_TABLE[mask][s];
              if (tri[0] < 0) break;
              int64_t vid[3];
              float tv[3][3];
              for (int e = 0; e < 3; ++e) {
                const int a = TET_EDGES[tri[e]][0];
                const int b = TET_EDGES[tri[e]][1];
                vid[e] = edge_vert(corner_g[tet[a]], corner_s[tet[a]],
                                   corner_g[tet[b]], corner_s[tet[b]]);
                for (int d = 0; d < 3; ++d) tv[e][d] = verts[vid[e] * 3 + d];
              }
              // skip degenerate (welded corners collapse the triangle)
              if (vid[0] == vid[1] || vid[1] == vid[2] || vid[0] == vid[2])
                continue;
              float e1[3], e2[3], n[3];
              for (int d = 0; d < 3; ++d) {
                e1[d] = tv[1][d] - tv[0][d];
                e2[d] = tv[2][d] - tv[0][d];
              }
              n[0] = e1[1] * e2[2] - e1[2] * e2[1];
              n[1] = e1[2] * e2[0] - e1[0] * e2[2];
              n[2] = e1[0] * e2[1] - e1[1] * e2[0];
              const float dot =
                  n[0] * outward[0] + n[1] * outward[1] + n[2] * outward[2];
              if (dot < 0.f) {
                faces.push_back(vid[2]);
                faces.push_back(vid[1]);
                faces.push_back(vid[0]);
              } else {
                faces.push_back(vid[0]);
                faces.push_back(vid[1]);
                faces.push_back(vid[2]);
              }
            }
          }
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Caller frees outputs with mt_free.
int mt_extract(const float* sdf, int64_t nx, int64_t ny, int64_t nz,
               const float* origin, const float* spacing, float level,
               float** verts_out, int64_t** faces_out,
               int64_t* nv_out, int64_t* nf_out) {
  if (!sdf || nx < 2 || ny < 2 || nz < 2) return 1;
  Extractor ex;
  ex.sdf = sdf; ex.nx = nx; ex.ny = ny; ex.nz = nz;
  ex.origin = origin; ex.spacing = spacing; ex.level = level;
  ex.run();

  *nv_out = (int64_t)(ex.verts.size() / 3);
  *nf_out = (int64_t)(ex.faces.size() / 3);
  *verts_out = (float*)std::malloc(ex.verts.size() * sizeof(float));
  *faces_out = (int64_t*)std::malloc(ex.faces.size() * sizeof(int64_t));
  if ((ex.verts.size() && !*verts_out) || (ex.faces.size() && !*faces_out)) {
    std::free(*verts_out); std::free(*faces_out);
    return 2;
  }
  if (ex.verts.size())
    std::memcpy(*verts_out, ex.verts.data(), ex.verts.size() * sizeof(float));
  if (ex.faces.size())
    std::memcpy(*faces_out, ex.faces.data(), ex.faces.size() * sizeof(int64_t));
  return 0;
}

void mt_free(float* verts, int64_t* faces) {
  std::free(verts);
  std::free(faces);
}

}  // extern "C"
