// Native marching tetrahedra: isosurface extraction from a dense SDF grid.
//
// The C++ counterpart of ops/marching.py (which replaces the reference's
// PyMCubes C++ dependency, lib/networks/renderer/mesh_renderer.py:80).
// Single-pass over cubes, 6 tets per cube, vertices deduplicated on global
// grid-edge ids with an open-addressing hash map. Exposed through a plain C
// ABI for ctypes (no pybind11 in this image).
//
// A copy of relightableavatar_tpu/native/marching.cpp for the PyTorch port.
// Built at first use by relightableavatar_tpu_torch/ops/native.py
// (g++ -O3 -march=native -shared -fPIC -std=c++17, with decimate.cpp).
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

constexpr int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};
constexpr int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// open-addressing hash map: edge key (uint64) -> vertex index (int64)
struct EdgeMap {
  std::vector<uint64_t> keys;
  std::vector<int64_t> vals;
  uint64_t mask;

  explicit EdgeMap(size_t expected) {
    size_t cap = 64;
    while (cap < expected * 2) cap <<= 1;
    keys.assign(cap, UINT64_MAX);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  // returns existing index or -1 after placing key at *slot
  int64_t find_or_reserve(uint64_t key, size_t* slot) {
    uint64_t h = key * 0x9E3779B97F4A7C15ull;
    size_t i = h & mask;
    while (true) {
      if (keys[i] == key) return vals[i];
      if (keys[i] == UINT64_MAX) {
        keys[i] = key;
        *slot = i;
        return -1;
      }
      i = (i + 1) & mask;
    }
  }
};

struct Builder {
  const float* f;
  int64_t X, Y, Z;
  std::vector<float> verts;   // xyz triples
  std::vector<int64_t> faces; // index triples
  EdgeMap map;

  Builder(const float* f_, int64_t X_, int64_t Y_, int64_t Z_)
      : f(f_), X(X_), Y(Y_), Z(Z_), map((size_t)(X_ * Y_ * Z_ / 4 + 1024)) {}

  inline int64_t edge_vertex(int64_t ga, int64_t gb, double fa, double fb) {
    uint64_t lo = (uint64_t)(ga < gb ? ga : gb);
    uint64_t hi = (uint64_t)(ga < gb ? gb : ga);
    uint64_t key = (lo << 32) | hi;
    size_t slot;
    int64_t idx = map.find_or_reserve(key, &slot);
    if (idx >= 0) return idx;
    double t = fa / (fa - fb + 1e-12);
    double ax = (double)(ga / (Y * Z)), ay = (double)((ga / Z) % Y), az = (double)(ga % Z);
    double bx = (double)(gb / (Y * Z)), by = (double)((gb / Z) % Y), bz = (double)(gb % Z);
    idx = (int64_t)(verts.size() / 3);
    verts.push_back((float)(ax + t * (bx - ax)));
    verts.push_back((float)(ay + t * (by - ay)));
    verts.push_back((float)(az + t * (bz - az)));
    map.vals[slot] = idx;
    return idx;
  }

  inline void tri(int64_t a, int64_t b, int64_t c) {
    if (a == b || b == c || a == c) return;
    faces.push_back(a);
    faces.push_back(b);
    faces.push_back(c);
  }

  void tet(const int64_t g[4], const double v[4]) {
    int inside[4], n_in = 0;
    for (int i = 0; i < 4; ++i) inside[i] = v[i] < 0.0;
    // stable sort: inside corners first
    int ord[4];
    for (int i = 0; i < 4; ++i) ord[i] = i;
    // insertion sort by !inside (stable)
    for (int i = 1; i < 4; ++i) {
      int k = ord[i];
      int j = i - 1;
      while (j >= 0 && (!inside[ord[j]]) > (!inside[k])) {
        ord[j + 1] = ord[j];
        --j;
      }
      ord[j + 1] = k;
    }
    for (int i = 0; i < 4; ++i) n_in += inside[i];
    if (n_in == 0 || n_in == 4) return;

    int64_t sg[4];
    double sv[4];
    for (int i = 0; i < 4; ++i) {
      sg[i] = g[ord[i]];
      sv[i] = v[ord[i]];
    }
    if (n_in == 1) {
      int64_t e0 = edge_vertex(sg[0], sg[1], sv[0], sv[1]);
      int64_t e1 = edge_vertex(sg[0], sg[2], sv[0], sv[2]);
      int64_t e2 = edge_vertex(sg[0], sg[3], sv[0], sv[3]);
      tri(e0, e1, e2);
    } else if (n_in == 3) {
      int64_t e0 = edge_vertex(sg[3], sg[0], sv[3], sv[0]);
      int64_t e1 = edge_vertex(sg[3], sg[1], sv[3], sv[1]);
      int64_t e2 = edge_vertex(sg[3], sg[2], sv[3], sv[2]);
      tri(e0, e2, e1);
    } else {  // n_in == 2
      int64_t e0 = edge_vertex(sg[0], sg[2], sv[0], sv[2]);
      int64_t e1 = edge_vertex(sg[0], sg[3], sv[0], sv[3]);
      int64_t e2 = edge_vertex(sg[1], sg[3], sv[1], sv[3]);
      int64_t e3 = edge_vertex(sg[1], sg[2], sv[1], sv[2]);
      tri(e0, e1, e2);
      tri(e0, e2, e3);
    }
  }

  void run(double level) {
    for (int64_t x = 0; x < X - 1; ++x) {
      for (int64_t y = 0; y < Y - 1; ++y) {
        for (int64_t z = 0; z < Z - 1; ++z) {
          int64_t cid[8];
          double cf[8];
          bool all_pos = true, all_neg = true;
          for (int c = 0; c < 8; ++c) {
            int64_t gx = x + CORNERS[c][0], gy = y + CORNERS[c][1], gz = z + CORNERS[c][2];
            cid[c] = gx * (Y * Z) + gy * Z + gz;
            cf[c] = (double)f[cid[c]] - level;
            all_pos &= (cf[c] > 0.0);
            all_neg &= (cf[c] < 0.0);
          }
          if (all_pos || all_neg) continue;
          for (int t = 0; t < 6; ++t) {
            int64_t g[4];
            double v[4];
            for (int i = 0; i < 4; ++i) {
              g[i] = cid[TETS[t][i]];
              v[i] = cf[TETS[t][i]];
            }
            tet(g, v);
          }
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Caller frees out buffers with ra_free.
int ra_marching_tets(const float* sdf, int64_t X, int64_t Y, int64_t Z,
                     float level, const float* origin, const float* spacing,
                     float** out_verts, int64_t* out_n_verts,
                     int64_t** out_faces, int64_t* out_n_faces) {
  if (X < 2 || Y < 2 || Z < 2) {
    *out_verts = nullptr;
    *out_faces = nullptr;
    *out_n_verts = 0;
    *out_n_faces = 0;
    return 0;
  }
  Builder b(sdf, X, Y, Z);
  b.run((double)level);

  int64_t nv = (int64_t)(b.verts.size() / 3);
  int64_t nf = (int64_t)(b.faces.size() / 3);
  float* V = (float*)std::malloc(sizeof(float) * b.verts.size());
  int64_t* F = (int64_t*)std::malloc(sizeof(int64_t) * b.faces.size());
  if ((nv && !V) || (nf && !F)) {
    std::free(V);
    std::free(F);
    return 1;
  }
  for (int64_t i = 0; i < nv; ++i) {
    V[3 * i + 0] = b.verts[3 * i + 0] * spacing[0] + origin[0];
    V[3 * i + 1] = b.verts[3 * i + 1] * spacing[1] + origin[1];
    V[3 * i + 2] = b.verts[3 * i + 2] * spacing[2] + origin[2];
  }
  std::memcpy(F, b.faces.data(), sizeof(int64_t) * b.faces.size());
  *out_verts = V;
  *out_faces = F;
  *out_n_verts = nv;
  *out_n_faces = nf;
  return 0;
}

void ra_free(void* p) { std::free(p); }

}  // extern "C"
