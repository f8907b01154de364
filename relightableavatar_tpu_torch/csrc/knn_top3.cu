// Exact top-3 nearest neighbours of P query points among N vertices (f32).
//
// Replaces the TPU kernel `_knn_kernel` / `knn_pallas`
// (relightableavatar_tpu/ops/pallas_knn.py:28, pallas_call at :110), which
// the HDQ world SDF runs on every surface-trace iteration, band sample and
// shadow-ray step (N = 6890 posed SMPL-H vertices, P = 8192, 24576 or 32768
// points a call).
//
// Contract (the same as the Pallas kernel and as the plain PyTorch version
// knn_top3_reference in ops/knn.py):
//   d2 = ((px-vx)*(px-vx) + (py-vy)*(py-vy)) + (pz-vz)*(pz-vz), each operation
//   rounded on its own (no FMA contraction), so d2 is bit-identical to the
//   plain version; output ascending; exact ties go to the lowest index;
//   idx int32.  Ragged P and N are masked in the kernel: no padding.
//
// Bound on an H100 SXM: the contract's d2 is 3 sub, 3 mul, 2 add a pair
// (9 issue slots with its compare, no FMA: a SIMT ceiling of 61 us at
// P = 32768, N = 6890), but the function needs only the filter below for
// nearly every pair: 3 FMAs (6 operations) and 1 compare, 7 FP32 operations,
// and 36 P + 12 N bytes of device memory traffic in all.  At P = 32768,
// N = 6890 that is 1.6e9 operations against 1.2 MB, so it is bound by
// operations: 1.6e9 / 67e12 (the FP32 rate, 132 SMs x 128 lanes x 2 x
// 1.98 GHz, counting an FMA as two) = 24 us.
//
// Design (its schedule is modelled in numpy, bit for bit, in
// tests/test_torch_knn.py):
//   * Filter first, exact d2 only for candidates.  A warp takes U = 4
//     vertices at a time and computes for each of its points the filter
//     value e = |v|^2 - 2 p.v, three FMAs a pair with |v|^2 kept beside the
//     cloud.  e differs from d2 - |p|^2 by less than the margin that
//     filter_margin proves, so a vertex with e >= T = thr - |p|^2 + margin
//     cannot have d2 < thr.  Each point folds its 4 values into one compare
//     (an fminf tree and a compare), so the fast path is 4 issue slots a
//     pair plus 4 broadcast loads, a vote and the loop a group.
//   * Warp-uniform slow path.  Only when __any_sync says some lane has a
//     vertex under T does the warp leave the fast path; it then takes the
//     group's vertices point by point and vertex by vertex, each level
//     behind its own vote, computes their exact d2 and inserts those under
//     thr in ascending index order by strict <.
//   * Seeded threshold.  Before the walk each point gets thr = the 3rd
//     smallest exact d2 among kWindow consecutive vertices around the
//     nearest of kSeeds strided seed vertices (nudged up one ulp, so the
//     filter is d2 <= that value): three distinct vertices, so every true
//     top-3 member passes, and SMPL's vertex order is spatially coherent, so
//     the window holds the point's near neighbours and the slow path runs
//     rarely from the first group on.  The subgroup's 8 warps split both
//     steps and combine them through shared memory.
//   * Register-tiled points.  Each lane holds R = 1..4 points; the cloud
//     lies in shared memory as structure of arrays (x, y, z, |v|^2), so one
//     broadcast LDS.128 of each gives 4 vertices for the warp's 32 R points.
//     R is chosen per call from P (points_per_lane) so the tasks
//     fill the card's SMs in as few waves as possible.
//   * Resident cloud.  One CTA of 16 warps an SM holds the whole cloud
//     (16 B a vertex, up to kCap = 10240 vertices) in dynamic shared memory,
//     loaded once per CTA by a plain load loop.  (On an H100, timed in
//     turns in one process, cp.async was no faster waited for before the
//     first task, and 13 % slower at P = 32768 run behind the first task's
//     seed steps, which then read device memory; a TMA bulk copy would land
//     the 12-byte rows as they are, and their transpose would need 83 KB
//     beyond what an SM has left.)  The
//     persistent grid walks tasks of 2 x 32 R points, one per 8-warp
//     subgroup.  The subgroup's warps take 32-vertex chunks from a shared
//     counter, in ascending order, so they split every point's vertex range
//     and finish together.  A larger cloud streams through the same buffer
//     in tiles of kCap vertices.
//   * Merge.  The 8 partial lists of a point (each ascending in index within
//     its warp) merge in lexicographic (d2, idx) order, one point a thread,
//     so ties across warps and tiles still go to the lowest index.

#include <cuda_runtime.h>
#include <atomic>
#include <climits>
#include <cmath>

namespace {

constexpr int kSlices = 8;                // warps that split one point's vertices
constexpr int kSub = 2;                   // point subgroups a CTA
constexpr int kWarps = kSlices * kSub;
constexpr int kThreads = kWarps * 32;
constexpr int kU = 4;                     // vertices a group (one LDS.128)
constexpr int kChunk = 8 * kU;            // vertices a warp takes at a time
constexpr int kCap = 10240;               // vertices resident in shared memory
constexpr int kSeeds = 192;               // strided seed vertices
constexpr int kWindow = 64;               // window of consecutive vertices
constexpr int kMaxR = 4;
constexpr float kMarginScale = 0x1p-17f;  // see filter_margin

struct Top3 {
  float d0, d1, d2;
  int i0, i1, i2;
};

__device__ __forceinline__ float dist2(float px, float py, float pz,
                                       float vx, float vy, float vz) {
  const float dx = __fsub_rn(px, vx);
  const float dy = __fsub_rn(py, vy);
  const float dz = __fsub_rn(pz, vz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return fmaf(x, x, fmaf(y, y, z * z));
}

// Margin of the filter e = |v|^2 - 2 p.v (three FMAs) against the exact d2.
// Let S = (|p| + V)^2 with V the largest |v| of the tile: every term and
// partial sum of e, |p|^2, d2 and thr is at most S (1 + 6u) in size, and
// their roundings (u = 2^-24 each: 3 in |v|^2, 3 in the FMA chain, 5 in the
// exact d2, 3 in |p|^2, 2 in off = |p|^2 - margin, 1 in T = thr - off) add
// up to less than 18 u S.  So d2 < thr implies e < T as long as the margin
// exceeds 18 u S; 2^-17 (|p|^2 + V2) = 128 u (|p|^2 + V2) >= 64 u S, with V2
// the largest |v|^2 of the tile, is 3.5x that.
__device__ __forceinline__ float filter_margin(float pp, float v2) {
  return kMarginScale * (pp + v2);
}

// Insertion of a candidate with d < t.d2 whose index exceeds every index
// already held (strict <: an equal distance keeps the earlier index).
__device__ __forceinline__ void insert_ascending(Top3& t, float d, int i) {
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

__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Insertion of a candidate in any index order (the cross-slice merge).
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Vertices [base, base + n) into the shared arrays as structure of arrays
// (x, y, z and |v|^2); entries [n, roundup(n, kChunk)) get x = |v|^2 = +inf,
// so neither the filter nor the exact d2 ever passes them.  Returns this
// thread's largest |v|^2.
__device__ __forceinline__ float stage_cloud(const float* __restrict__ verts,
                                             float* xs, float* ys, float* zs,
                                             float* ws, int base, int n) {
  float v2 = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float* v = verts + 3 * (base + j);
    const float x = __ldg(v + 0), y = __ldg(v + 1), z = __ldg(v + 2);
    const float w = sq3(x, y, z);
    xs[j] = x; ys[j] = y; zs[j] = z; ws[j] = w;
    v2 = fmaxf(v2, w);
  }
  const int padded = (n + kChunk - 1) / kChunk * kChunk;
  for (int j = n + threadIdx.x; j < padded; j += kThreads) {
    xs[j] = INFINITY; ys[j] = 0.f; zs[j] = 0.f; ws[j] = INFINITY;
  }
  return v2;
}

// Vertex j from the resident shared arrays, else from device memory.
__device__ __forceinline__ void load_vertex(bool resident, const float* xs,
                                            const float* ys, const float* zs,
                                            const float* __restrict__ verts, int j,
                                            float& x, float& y, float& z) {
  if (resident) {
    x = xs[j]; y = ys[j]; z = zs[j];
  } else {
    x = __ldg(verts + 3 * j); y = __ldg(verts + 3 * j + 1); z = __ldg(verts + 3 * j + 2);
  }
}

// (a0, a1, a2) <- the 3 smallest of (a0, a1, a2, d), ascending.
__device__ __forceinline__ void keep_smallest3(float& a0, float& a1, float& a2, float d) {
  d = fminf(d, INFINITY);                   // a NaN counts as +inf
  const float h0 = fmaxf(a0, d);
  a0 = fminf(a0, d);
  const float h1 = fmaxf(a1, h0);
  a1 = fminf(a1, h0);
  a2 = fminf(a2, h1);
}

// Next chunk of this warp's subgroup: one shared-memory atomic by lane 0.
__device__ __forceinline__ int grab_chunk(int* counter, int lane) {
  int c = 0;
  if (lane == 0) c = atomicAdd(counter, 1);
  return __shfl_sync(0xffffffffu, c, 0);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
knn_top3_kernel(const float* __restrict__ pts, const float* __restrict__ verts,
                float* __restrict__ d2_out, int* __restrict__ idx_out,
                int P, int N) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ys = xs + kCap;
  float* zs = ys + kCap;
  float* ws = zs + kCap;
  float* part_d = ws + kCap;                                    // [kWarps][3][R][32]
  int* part_i = reinterpret_cast<int*>(part_d + kWarps * 3 * R * 32);
  float* wmax = reinterpret_cast<float*>(part_i + kWarps * 3 * R * 32);   // [kWarps]
  int* counter = reinterpret_cast<int*>(wmax + kWarps);                 // [kSub]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = warp / kSlices;           // point subgroup of this warp
  const int slice = warp % kSlices;
  const int tiles = (N + kCap - 1) / kCap;
  const int tasks = (P + kSub * 32 * R - 1) / (kSub * 32 * R);
  const int seeds = min(kSeeds, N);
  const int stride = N / seeds;
  const bool resident = tiles == 1;

  if (resident) {
    const float v2 = warp_max(stage_cloud(verts, xs, ys, zs, ws, 0, N));
    if (lane == 0) wmax[warp] = v2;
    __syncthreads();
  }

  for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
    const int first = (task * kSub + sub) * 32 * R;   // first point of the subgroup
    float qx[R], qy[R], qz[R], pp[R], thr[R], T[R], off[R];
    Top3 t[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = first + r * 32 + lane;
      float x = 0.f, y = 0.f, z = 0.f;
      if (p < P) {
        x = __ldg(pts + 3 * p + 0);
        y = __ldg(pts + 3 * p + 1);
        z = __ldg(pts + 3 * p + 2);
      }
      qx[r] = -2.f * x; qy[r] = -2.f * y; qz[r] = -2.f * z;   // exact
      pp[r] = sq3(x, y, z);
      t[r] = {INFINITY, INFINITY, INFINITY, INT_MAX, INT_MAX, INT_MAX};
    }

    // ---- seed, step 1: the nearest of the strided seed vertices k * stride
    // (this warp's share k = slice mod 8, then the subgroup's best)
    float be[R];
    int bk[R];
#pragma unroll
    for (int r = 0; r < R; ++r) { be[r] = INFINITY; bk[r] = 0; }
    for (int k = slice; k < seeds; k += kSlices) {
      float vx, vy, vz;
      load_vertex(resident, xs, ys, zs, verts, k * stride, vx, vy, vz);
      const float vw = sq3(vx, vy, vz);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float e = fmaf(qx[r], vx, fmaf(qy[r], vy, fmaf(qz[r], vz, vw)));
        if (e < be[r]) { be[r] = e; bk[r] = k; }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      part_i[(warp * R + r) * 32 + lane] = bk[r];
      part_i[(kWarps + warp) * R * 32 + r * 32 + lane] = __float_as_int(be[r]);
    }
    __syncthreads();
    // ---- seed, step 2: the 3 smallest exact d2 in the window of kWindow
    // consecutive vertices around it (SMPL's vertex order is spatially
    // coherent, so these are near the point's true neighbours); this
    // warp's share is every 8th vertex of the window
    float w0[R], w1[R], w2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float e = INFINITY;
      int k = 0;
      for (int w = sub * kSlices; w < (sub + 1) * kSlices; ++w) {
        const float ew = __int_as_float(part_i[(kWarps + w) * R * 32 + r * 32 + lane]);
        if (ew < e) { e = ew; k = part_i[(w * R + r) * 32 + lane]; }
      }
      const int lo = max(0, min(k * stride - kWindow / 2, N - kWindow));
      w0[r] = w1[r] = w2[r] = INFINITY;
      for (int o = slice; o < min(kWindow, N); o += kSlices) {
        float vx, vy, vz;
        load_vertex(resident, xs, ys, zs, verts, lo + o, vx, vy, vz);
        const float d = dist2(-0.5f * qx[r], -0.5f * qy[r], -0.5f * qz[r], vx, vy, vz);
        keep_smallest3(w0[r], w1[r], w2[r], d);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      part_d[(0 * kWarps + warp) * R * 32 + r * 32 + lane] = w0[r];
      part_d[(1 * kWarps + warp) * R * 32 + r * 32 + lane] = w1[r];
      part_d[(2 * kWarps + warp) * R * 32 + r * 32 + lane] = w2[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a0 = INFINITY, a1 = INFINITY, a2 = INFINITY;
      for (int m = 0; m < 3; ++m)
        for (int w = sub * kSlices; w < (sub + 1) * kSlices; ++w)
          keep_smallest3(a0, a1, a2, part_d[(m * kWarps + w) * R * 32 + r * 32 + lane]);
      // a2 is the d2 of the 3rd-nearest of the window's distinct vertices,
      // so d2 <= a2 holds for every true top-3 member:  d <= a2  <=>
      // d < nextafter(a2); a point past P never passes
      thr[r] = first + r * 32 + lane < P ? nextafterf(a2, INFINITY) : -INFINITY;
    }

    // ---- walk: the subgroup's 8 warps take chunks of every tile in
    // ascending order from a shared counter, 4 vertices a group
    for (int tile = 0; tile < tiles; ++tile) {
      const int base = tile * kCap;
      const int n = min(kCap, N - base);
      if (tiles > 1) {
        __syncthreads();
        const float v2 = warp_max(stage_cloud(verts, xs, ys, zs, ws, base, n));
        if (lane == 0) wmax[warp] = v2;
      }
      if (threadIdx.x < kSub) counter[threadIdx.x] = 0;
      __syncthreads();
      float v2 = 0.f;
      for (int w = 0; w < kWarps; ++w) v2 = fmaxf(v2, wmax[w]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        off[r] = pp[r] - filter_margin(pp[r], v2);
        T[r] = thr[r] - off[r];
      }
      const int chunks = (n + kChunk - 1) / kChunk;
      for (int c = grab_chunk(counter + sub, lane); c < chunks;
           c = grab_chunk(counter + sub, lane)) {
        for (int j = c * kChunk; j < (c + 1) * kChunk; j += kU) {
          const float4 vx = *reinterpret_cast<const float4*>(xs + j);
          const float4 vy = *reinterpret_cast<const float4*>(ys + j);
          const float4 vz = *reinterpret_cast<const float4*>(zs + j);
          const float4 vw = *reinterpret_cast<const float4*>(ws + j);
          float e[R][kU];
          bool hit[R];
          bool any = false;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            e[r][0] = fmaf(qx[r], vx.x, fmaf(qy[r], vy.x, fmaf(qz[r], vz.x, vw.x)));
            e[r][1] = fmaf(qx[r], vx.y, fmaf(qy[r], vy.y, fmaf(qz[r], vz.y, vw.y)));
            e[r][2] = fmaf(qx[r], vx.z, fmaf(qy[r], vy.z, fmaf(qz[r], vz.z, vw.z)));
            e[r][3] = fmaf(qx[r], vx.w, fmaf(qy[r], vy.w, fmaf(qz[r], vz.w, vw.w)));
            hit[r] = fminf(fminf(e[r][0], e[r][1]), fminf(e[r][2], e[r][3])) < T[r];
            any |= hit[r];
          }
          if (__any_sync(0xffffffffu, any)) {
            // slow path: exact d2 of the group's filtered vertices, point by
            // point, inserted in ascending index order; each level skipped
            // when no lane of the warp needs it
            const float gx[kU] = {vx.x, vx.y, vx.z, vx.w};
            const float gy[kU] = {vy.x, vy.y, vy.z, vy.w};
            const float gz[kU] = {vz.x, vz.y, vz.z, vz.w};
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (!__any_sync(0xffffffffu, hit[r])) continue;
#pragma unroll
              for (int u = 0; u < kU; ++u) {
                if (!__any_sync(0xffffffffu, e[r][u] < T[r])) continue;
                const float d = dist2(-0.5f * qx[r], -0.5f * qy[r], -0.5f * qz[r],
                                      gx[u], gy[u], gz[u]);
                if (d < thr[r]) {
                  insert_ascending(t[r], d, base + j + u);
                  thr[r] = fminf(thr[r], t[r].d2);
                  T[r] = thr[r] - off[r];
                }
              }
            }
          }
        }
      }
    }

    // ---- merge the 8 slices' lists of each point, one point a thread
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = (warp * 3 * R + r) * 32 + lane;
      part_d[o] = t[r].d0;              part_i[o] = t[r].i0;
      part_d[o + R * 32] = t[r].d1;     part_i[o + R * 32] = t[r].i1;
      part_d[o + 2 * R * 32] = t[r].d2; part_i[o + 2 * R * 32] = t[r].i2;
    }
    __syncthreads();
    const int k = slice * 32 + lane;          // = r * 32 + lane of the point
    if (k < 32 * R && first + k < P) {
      const int p = first + k;
      const int o = (sub * kSlices * 3 * R) * 32 + k;
      Top3 s = {part_d[o], part_d[o + R * 32], part_d[o + 2 * R * 32],
                part_i[o], part_i[o + R * 32], part_i[o + 2 * R * 32]};
      for (int w = 1; w < kSlices; ++w) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const int q = o + (w * 3 + m) * R * 32;
          insert_lex(s, part_d[q], part_i[q]);
        }
      }
      d2_out[3 * p + 0] = s.d0; idx_out[3 * p + 0] = s.i0;
      d2_out[3 * p + 1] = s.d1; idx_out[3 * p + 1] = s.i1;
      d2_out[3 * p + 2] = s.d2; idx_out[3 * p + 2] = s.i2;
    }
    __syncthreads();            // part_d is the next task's seed scratch
  }
}

constexpr size_t smem_bytes(int R) {
  return sizeof(float) * (4 * kCap + 2 * kWarps * 3 * R * 32 + kWarps + kSub);
}

// Per device: its SM count (0 until read) and, per R, whether the kernel's
// shared-memory limit was raised; set at the first launch on the device, so
// later launches make no attribute calls.
constexpr int kMaxDevices = 64;
std::atomic<int> g_sm_count[kMaxDevices];
std::atomic<bool> g_smem_set[kMaxDevices][kMaxR + 1];

template <int R>
int launch(const float* pts, const float* verts, float* d2, int* idx, int P,
           int N, int dev, int slots, cudaStream_t stream) {
  const int tasks = (P + kSub * 32 * R - 1) / (kSub * 32 * R);
  const unsigned grid = static_cast<unsigned>(tasks < slots ? tasks : slots);
  if (!g_smem_set[dev][R].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_top3_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(R)));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[dev][R].store(true, std::memory_order_release);
  }
  knn_top3_kernel<R><<<grid, kThreads, smem_bytes(R), stream>>>(
      pts, verts, d2, idx, P, N);
  return static_cast<int>(cudaGetLastError());
}

// Points a lane (1..4) for P points on a card with `slots` CTA slots: the R
// that needs the fewest waves of tasks (2 x 32 R points each) times the work
// of one task, which grows as 4 R + 2 issue slots a vertex (the 2 being the
// group's loads, vote and loop, shared by the R points).
int points_per_lane(int P, int slots) {
  int best = 1;
  long best_cost = -1;
  for (int R = 1; R <= kMaxR; ++R) {
    const long tasks = (P + kSub * 32L * R - 1) / (kSub * 32L * R);
    const long waves = (tasks + slots - 1) / slots;
    const long cost = waves * (4L * R + 2);
    if (best_cost < 0 || cost < best_cost) { best = R; best_cost = cost; }
  }
  return best;
}

}  // namespace

// pts (P, 3), verts (N, 3) float32 row-major on the device; d2 (P, 3) float32
// and idx (P, 3) int32 outputs.  Launches on `stream` and does not
// synchronise.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int knn_top3_f32(const float* pts, const float* verts, float* d2,
                            int* idx, int P, int N, void* stream) {
  if (P <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int slots = g_sm_count[dev].load(std::memory_order_relaxed);   // one CTA an SM
  if (slots == 0) {
    err = cudaDeviceGetAttribute(&slots, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sm_count[dev].store(slots, std::memory_order_relaxed);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (points_per_lane(P, slots)) {
    case 1: return launch<1>(pts, verts, d2, idx, P, N, dev, slots, s);
    case 2: return launch<2>(pts, verts, d2, idx, P, N, dev, slots, s);
    case 3: return launch<3>(pts, verts, d2, idx, P, N, dev, slots, s);
    default: return launch<4>(pts, verts, d2, idx, P, N, dev, slots, s);
  }
}
