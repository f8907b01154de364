// Quadric-error-metric edge-collapse mesh decimation (Garland–Heckbert).
//
// Native replacement for the reference's trimesh
// `simplify_quadratic_decimation` call (lib/networks/renderer/
// mesh_renderer.py:95-96, gated by cfg.mesh_simp_face) — that call bottoms
// out in C++ (open3d/fast-simplification); this is our own compact
// implementation, exposed through the same ctypes library as marching.cpp
// (relightableavatar_tpu_torch/ops/native.py). A copy of
// relightableavatar_tpu/native/decimate.cpp for the PyTorch port.
//
// Lazy-deletion binary heap over candidate collapses; per-vertex quadrics;
// optimal collapse position via the 3x3 normal system with midpoint
// fallback; triangle-flip guard.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <unordered_set>
#include <algorithm>

namespace {

struct Quadric {
  // symmetric 4x4 stored as 10 coeffs: a11 a12 a13 a14 a22 a23 a24 a33 a34 a44
  double q[10] = {0};
  void add_plane(double a, double b, double c, double d) {
    q[0] += a * a; q[1] += a * b; q[2] += a * c; q[3] += a * d;
    q[4] += b * b; q[5] += b * c; q[6] += b * d;
    q[7] += c * c; q[8] += c * d; q[9] += d * d;
  }
  void add(const Quadric& o) { for (int i = 0; i < 10; i++) q[i] += o.q[i]; }
  double eval(const double v[3]) const {
    double x = v[0], y = v[1], z = v[2];
    return q[0]*x*x + 2*q[1]*x*y + 2*q[2]*x*z + 2*q[3]*x
         + q[4]*y*y + 2*q[5]*y*z + 2*q[6]*y
         + q[7]*z*z + 2*q[8]*z + q[9];
  }
  // solve [A b; 0 1] for minimizer; false if near-singular
  bool minimizer(double out[3]) const {
    double A[9] = {q[0], q[1], q[2], q[1], q[4], q[5], q[2], q[5], q[7]};
    double b[3] = {-q[3], -q[6], -q[8]};
    double det = A[0]*(A[4]*A[8]-A[5]*A[7]) - A[1]*(A[3]*A[8]-A[5]*A[6])
               + A[2]*(A[3]*A[7]-A[4]*A[6]);
    if (std::fabs(det) < 1e-12) return false;
    double inv[9] = {
      (A[4]*A[8]-A[5]*A[7])/det, (A[2]*A[7]-A[1]*A[8])/det, (A[1]*A[5]-A[2]*A[4])/det,
      (A[5]*A[6]-A[3]*A[8])/det, (A[0]*A[8]-A[2]*A[6])/det, (A[2]*A[3]-A[0]*A[5])/det,
      (A[3]*A[7]-A[4]*A[6])/det, (A[1]*A[6]-A[0]*A[7])/det, (A[0]*A[4]-A[1]*A[3])/det};
    for (int i = 0; i < 3; i++)
      out[i] = inv[i*3+0]*b[0] + inv[i*3+1]*b[1] + inv[i*3+2]*b[2];
    return true;
  }
};

struct Cand {
  double cost;
  int64_t u, v;          // u < v
  uint32_t ver;          // sum of vertex versions at push time
  double pos[3];
  bool operator<(const Cand& o) const { return cost > o.cost; }  // min-heap
};

struct EdgeKey {
  size_t operator()(const uint64_t& e) const { return std::hash<uint64_t>()(e); }
};

}  // namespace

extern "C" {

// verts (nv,3) f32, faces (nf,3) i64 -> newly malloc'd out arrays.
// Returns 0 on success.
int ra_decimate(const float* verts, int64_t nv, const int64_t* faces,
                int64_t nf, int64_t target_faces,
                float** out_v, int64_t* out_nv,
                int64_t** out_f, int64_t* out_nf) {
  std::vector<double> V(nv * 3);
  for (int64_t i = 0; i < nv * 3; i++) V[i] = verts[i];
  std::vector<int64_t> F(faces, faces + nf * 3);

  std::vector<Quadric> Q(nv);
  std::vector<std::vector<int64_t>> vfaces(nv);  // incident face ids
  auto fnormal = [&](int64_t f, double n[4]) -> bool {  // n = (a,b,c,d)
    const int64_t* t = &F[f * 3];
    double e1[3], e2[3];
    for (int k = 0; k < 3; k++) {
      e1[k] = V[t[1]*3+k] - V[t[0]*3+k];
      e2[k] = V[t[2]*3+k] - V[t[0]*3+k];
    }
    n[0] = e1[1]*e2[2] - e1[2]*e2[1];
    n[1] = e1[2]*e2[0] - e1[0]*e2[2];
    n[2] = e1[0]*e2[1] - e1[1]*e2[0];
    double len = std::sqrt(n[0]*n[0] + n[1]*n[1] + n[2]*n[2]);
    if (len < 1e-14) return false;
    for (int k = 0; k < 3; k++) n[k] /= len;
    n[3] = -(n[0]*V[t[0]*3] + n[1]*V[t[0]*3+1] + n[2]*V[t[0]*3+2]);
    return true;
  };

  for (int64_t f = 0; f < nf; f++) {
    double n[4];
    // register EVERY face in vfaces (degenerate ones too, so collapses
    // update/kill them); only non-degenerate faces contribute quadrics
    bool ok = fnormal(f, n);
    for (int k = 0; k < 3; k++) {
      if (ok) Q[F[f*3+k]].add_plane(n[0], n[1], n[2], n[3]);
      vfaces[F[f*3+k]].push_back(f);
    }
  }

  std::vector<uint32_t> version(nv, 0);
  std::vector<char> vdead(nv, 0), fdead(nf, 0);
  std::priority_queue<Cand> heap;

  auto push_edge = [&](int64_t a, int64_t b) {
    if (a == b || vdead[a] || vdead[b]) return;
    if (a > b) std::swap(a, b);
    Quadric q = Q[a]; q.add(Q[b]);
    Cand c; c.u = a; c.v = b; c.ver = version[a] + version[b];
    if (!q.minimizer(c.pos)) {
      for (int k = 0; k < 3; k++) c.pos[k] = 0.5 * (V[a*3+k] + V[b*3+k]);
    }
    c.cost = q.eval(c.pos);
    heap.push(c);
  };

  {
    std::unordered_set<uint64_t, EdgeKey> seen;
    for (int64_t f = 0; f < nf; f++)
      for (int k = 0; k < 3; k++) {
        int64_t a = F[f*3+k], b = F[f*3+(k+1)%3];
        if (a > b) std::swap(a, b);
        uint64_t key = (uint64_t)a << 32 | (uint64_t)b;
        if (seen.insert(key).second) push_edge(a, b);
      }
  }

  int64_t live_faces = nf;
  while (live_faces > target_faces && !heap.empty()) {
    Cand c = heap.top(); heap.pop();
    int64_t u = c.u, v = c.v;
    if (vdead[u] || vdead[v] || c.ver != version[u] + version[v]) continue;

    // flip guard: collapsing v into u at pos must not invert u/v's other faces
    bool flip = false;
    double newp[3] = {c.pos[0], c.pos[1], c.pos[2]};
    for (int64_t w : {u, v}) {
      for (int64_t f : vfaces[w]) {
        if (fdead[f]) continue;
        const int64_t* t = &F[f*3];
        bool has_u = t[0]==u||t[1]==u||t[2]==u, has_v = t[0]==v||t[1]==v||t[2]==v;
        if (has_u && has_v) continue;  // face dies in the collapse
        double before[4], p[3][3];
        if (!fnormal(f, before)) continue;
        for (int k = 0; k < 3; k++)
          for (int j = 0; j < 3; j++)
            p[k][j] = (t[k] == u || t[k] == v) ? newp[j] : V[t[k]*3+j];
        double e1[3], e2[3], n2[3];
        for (int j = 0; j < 3; j++) { e1[j] = p[1][j]-p[0][j]; e2[j] = p[2][j]-p[0][j]; }
        n2[0] = e1[1]*e2[2]-e1[2]*e2[1];
        n2[1] = e1[2]*e2[0]-e1[0]*e2[2];
        n2[2] = e1[0]*e2[1]-e1[1]*e2[0];
        if (before[0]*n2[0] + before[1]*n2[1] + before[2]*n2[2] < 0) { flip = true; break; }
      }
      if (flip) break;
    }
    if (flip) continue;

    // collapse v -> u
    for (int k = 0; k < 3; k++) V[u*3+k] = newp[k];
    Q[u].add(Q[v]);
    vdead[v] = 1;
    version[u]++;

    for (int64_t f : vfaces[v]) {
      if (fdead[f]) continue;
      int64_t* t = &F[f*3];
      bool has_u = t[0]==u||t[1]==u||t[2]==u;
      for (int k = 0; k < 3; k++) if (t[k] == v) t[k] = u;
      if (has_u || t[0]==t[1] || t[1]==t[2] || t[0]==t[2]) {
        fdead[f] = 1; live_faces--;
      } else {
        vfaces[u].push_back(f);
      }
    }
    // refresh candidate edges around u
    std::unordered_set<uint64_t, EdgeKey> seen;
    for (int64_t f : vfaces[u]) {
      if (fdead[f]) continue;
      const int64_t* t = &F[f*3];
      for (int k = 0; k < 3; k++) {
        if (t[k] == u) continue;
        int64_t a = u, b = t[k];
        if (a > b) std::swap(a, b);
        uint64_t key = (uint64_t)a << 32 | (uint64_t)b;
        if (seen.insert(key).second) push_edge(a, b);
      }
    }
  }

  // compact output
  std::vector<int64_t> remap(nv, -1);
  std::vector<float> ov;
  std::vector<int64_t> of;
  for (int64_t f = 0; f < nf; f++) {
    if (fdead[f]) continue;
    for (int k = 0; k < 3; k++) {
      int64_t vtx = F[f*3+k];
      if (remap[vtx] < 0) {
        remap[vtx] = (int64_t)(ov.size() / 3);
        for (int j = 0; j < 3; j++) ov.push_back((float)V[vtx*3+j]);
      }
      of.push_back(remap[vtx]);
    }
  }
  *out_nv = (int64_t)(ov.size() / 3);
  *out_nf = (int64_t)(of.size() / 3);
  *out_v = (float*)std::malloc(ov.size() * sizeof(float));
  *out_f = (int64_t*)std::malloc(of.size() * sizeof(int64_t));
  std::memcpy(*out_v, ov.data(), ov.size() * sizeof(float));
  std::memcpy(*out_f, of.data(), of.size() * sizeof(int64_t));
  return 0;
}

}  // extern "C"
