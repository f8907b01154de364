// Exact top-3 nearest neighbours of P query points among N vertices (f32).
//
// Replaces the TPU kernel `_knn_kernel` / `knn_pallas`
// (relightableavatar_tpu/ops/pallas_knn.py:28, pallas_call at :110), which
// the HDQ world SDF runs on every surface-trace iteration and every
// shadow-ray step (N = 6890 posed SMPL-H vertices, P up to 32768 a call).
//
// Contract (the same as the Pallas kernel and as the plain PyTorch version
// knn_top3_reference in ops/knn.py):
//   d2 = ((px-vx)*(px-vx) + (py-vy)*(py-vy)) + (pz-vz)*(pz-vz), each operation
//   rounded on its own (no FMA contraction), so d2 is bit-identical to the
//   plain version; output ascending; exact ties go to the lowest index;
//   idx int32.  Ragged P and N are masked in the kernel: no padding.
//
// Bound on an H100 SXM: per (point, vertex) pair the function needs 3 sub,
// 3 mul, 2 add and 1 compare, 9 FP32 operations, and 36 P + 12 N bytes of
// device memory traffic in all.  At P = 32768, N = 6890 that is 2.0e9
// operations against 1.2 MB, so it is bound by operations: 2.0e9 / 67e12
// (the FP32 rate, 132 SMs x 128 lanes x 2 x 1.98 GHz, counting an FMA as
// two) = 30 us.  The (P, N) distance matrix is never written.
//
// Design against that bound:
//   * A CTA of 8 warps owns 32 points, one per lane.  The vertex cloud
//     (82.7 KB) streams through shared memory in tiles of 2048 vertices
//     (float4, 32 KB, static).  Warp w walks slice w of every tile, so the 8
//     warps of a CTA split each point's vertex range, and P = 8192 already
//     gives 256 CTAs for the 132 SMs.
//   * All 32 lanes of a warp read the same vertex at the same step: one
//     broadcast 16-byte shared load per vertex serves 32 pairs.
//   * Each thread keeps its top 3 in registers by strict-< insertion while it
//     walks its vertices in ascending index order, which keeps the lowest
//     index on ties.  The 8 partial lists of a point are merged at the end
//     through shared memory by lexicographic (d2, idx) order, which keeps the
//     same tie rule across warps.
//   * The insertion branch is taken rarely once the list holds near
//     neighbours, so the inner loop is loads, 8 arithmetic operations and
//     one compare per pair.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 2048;
constexpr int kSlice = kTile / kWarps;

struct Top3 {
  float d0, d1, d2;
  int i0, i1, i2;
};

// Insertion of a candidate whose index exceeds every index already held.
__device__ __forceinline__ void insert_ascending(Top3& t, float d, int i) {
  if (d < t.d2) {
    if (d < t.d1) {
      t.d2 = t.d1; t.i2 = t.i1;
      if (d < t.d0) {
        t.d1 = t.d0; t.i1 = t.i0;
        t.d0 = d; t.i0 = i;
      } else {
        t.d1 = d; t.i1 = i;
      }
    } else {
      t.d2 = d; t.i2 = i;
    }
  }
}

__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Insertion of a candidate in any index order (the cross-warp merge).
__device__ __forceinline__ void insert_lex(Top3& t, float d, int i) {
  if (lex_less(d, i, t.d2, t.i2)) {
    if (lex_less(d, i, t.d1, t.i1)) {
      t.d2 = t.d1; t.i2 = t.i1;
      if (lex_less(d, i, t.d0, t.i0)) {
        t.d1 = t.d0; t.i1 = t.i0;
        t.d0 = d; t.i0 = i;
      } else {
        t.d1 = d; t.i1 = i;
      }
    } else {
      t.d2 = d; t.i2 = i;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
knn_top3_kernel(const float* __restrict__ pts, const float* __restrict__ verts,
                float* __restrict__ d2_out, int* __restrict__ idx_out,
                int P, int N) {
  __shared__ float4 tile[kTile];
  __shared__ float part_d[kWarps][3][32];
  __shared__ int part_i[kWarps][3][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * 32 + lane;
  const bool valid = p < P;

  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    px = pts[3 * p + 0];
    py = pts[3 * p + 1];
    pz = pts[3 * p + 2];
  }
  Top3 t = {INFINITY, INFINITY, INFINITY, INT_MAX, INT_MAX, INT_MAX};

  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* v = verts + 3 * (base + j);
      tile[j] = make_float4(v[0], v[1], v[2], 0.f);
    }
    __syncthreads();
    const int lo = warp * kSlice;
    const int hi = min(lo + kSlice, n);
#pragma unroll 4
    for (int j = lo; j < hi; ++j) {
      const float4 v = tile[j];
      const float dx = __fsub_rn(px, v.x);
      const float dy = __fsub_rn(py, v.y);
      const float dz = __fsub_rn(pz, v.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      insert_ascending(t, d, base + j);
    }
    __syncthreads();
  }

  part_d[warp][0][lane] = t.d0; part_i[warp][0][lane] = t.i0;
  part_d[warp][1][lane] = t.d1; part_i[warp][1][lane] = t.i1;
  part_d[warp][2][lane] = t.d2; part_i[warp][2][lane] = t.i2;
  __syncthreads();

  if (warp == 0 && valid) {
    Top3 r = {INFINITY, INFINITY, INFINITY, INT_MAX, INT_MAX, INT_MAX};
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int k = 0; k < 3; ++k) insert_lex(r, part_d[w][k][lane], part_i[w][k][lane]);
    }
    d2_out[3 * p + 0] = r.d0; idx_out[3 * p + 0] = r.i0;
    d2_out[3 * p + 1] = r.d1; idx_out[3 * p + 1] = r.i1;
    d2_out[3 * p + 2] = r.d2; idx_out[3 * p + 2] = r.i2;
  }
}

}  // namespace

// pts (P, 3), verts (N, 3) float32 row-major on the device; d2 (P, 3) float32
// and idx (P, 3) int32 outputs.  Launches on `stream` and does not
// synchronise.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int knn_top3_f32(const float* pts, const float* verts, float* d2,
                            int* idx, int P, int N, void* stream) {
  if (P <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((P + 31) / 32);
  knn_top3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, verts, d2, idx, P, N);
  return static_cast<int>(cudaGetLastError());
}
