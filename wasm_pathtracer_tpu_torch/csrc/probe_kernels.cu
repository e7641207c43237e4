// Cluster select (K3, K6) and probe (K4, K5) kernels for Hopper.
//
// Replace the Pallas TPU kernels of wasm_pathtracer_tpu/ops/probe_pallas.py:
//   wpt_select_scan  <- select_scan      (_make_select_scan_kernel)   K3
//   wpt_select       <- select_blocks    (_make_select_kernel)        K6
//   wpt_probe        <- probe_pair_raw   (_make_pair_kernel, 2 rounds) K4
//                    <- probe_blocks_min (_make_min_kernel, 1 round)   K5
//
// Select (K3/K6), one thread per ray.  Every ray runs the slab test
// against all C cluster boxes and keeps, after its lex cursor
// (skip_e, skip_c), the two lexicographically smallest (entry, id) pairs
// and the entry of the third.  What bounds it: FP32 ALU work, ~25
// operations per (ray, box); the boxes are streamed through shared memory
// in tiles that every thread of a block reads at the same address (a
// broadcast), so a box costs no global traffic per ray.  Visiting ids in
// ascending order with strict compares on the entry keeps the lowest id
// among equal entries, which is the TPU kernel's min / where(ent == e)
// reduction.  With DENSE (K3) the thread also scans the small dense
// remainder (<= 64 shapes, staged in shared memory) with the scene
// kernels' family functions and fold (scene_families.cuh), as the TPU
// kernel reuses the megakernel's _t_planes ... _t_squares.
//
// Probe (K4/K5), one warp per ray and round.  Lane j tests slots j, j+32,
// ... of the ray's cluster, then a warp-shuffle reduction keeps the
// lexicographic (t, slot) minimum: the first-minimum slot of the TPU
// kernel's _reduce_min_row.  What bounds it: loads of the cluster table,
// 11 x G floats per (ray, round), 5.6 KB at G = 128, read as coalesced
// 128-byte rows; a 550-cluster table (3.1 MB) or a 2,344-cluster one
// (13 MB) stays in the 50 MB L2.  The per-family tests are the scene
// kernels' (scene_families.cuh): they compute the same expressions as
// probe_pallas._tri_test ... _torus_test (the triangle test with the
// normal's inverse length, without an n.d != 0 mask).  A lane skips a
// torus whose box entry is beyond its best hit so far (exact: a torus hit
// is >= that entry).
//
// Output contract: (t, sid) per round, t = +inf and sid = -1 on a miss.
// The TPU kernels also returned the winner's table row so that shading
// needed no gather on the TPU; here shading gathers the shape's row.
// Cluster ids are clamped into [0, C) on input.  Plain C interface for
// ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "scene_families.cuh"

namespace wpt {

constexpr int SELECT_BLOCK = 128;   // rays per select block
constexpr int BOX_TILE = 256;       // boxes per shared-memory tile
constexpr int PROBE_BLOCK = 128;    // threads per probe block: 4 rays
constexpr int TABLE_ROWS = 11;      // params 0-8, type code, shape id
constexpr unsigned PROBE_MASK = 0xffffffffu;

__device__ __forceinline__ float nz30(float x) {
  return fabsf(x) < 1e-30f ? 1e-30f : x;
}

template <bool DENSE>
__global__ void __launch_bounds__(SELECT_BLOCK)
select_kernel(const float* __restrict__ aabbs, int C,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ skip_e_in,
              const int* __restrict__ skip_c_in, int n_rays,
              float* __restrict__ ent_out, int* __restrict__ cid_out,
              const float* __restrict__ dense, Counts dense_counts,
              const long long* __restrict__ dense_sid,
              float* __restrict__ t_out, int* __restrict__ sid_out) {
  __shared__ float box[6][BOX_TILE];
  extern __shared__ float smem[];
  Tables tb;
  if (DENSE) tb = stage_tables(dense, dense_counts, smem);

  const int ray = blockIdx.x * SELECT_BLOCK + threadIdx.x;
  const bool active = ray < n_rays;
  Ray r = {0.f, 0.f, 0.f, 1.f, 1.f, 1.f};
  float skip_e = 0.f;
  int skip_c = 0;
  if (active) {
    r = load_ray(o, d, ray);
    skip_e = skip_e_in[ray];
    skip_c = skip_c_in[ray];
  }
  const float ix = 1.f / nz30(r.dx), iy = 1.f / nz30(r.dy), iz = 1.f / nz30(r.dz);
  float e1 = INFINITY, e2 = INFINITY, e3 = INFINITY;
  int c1 = 0, c2 = 0;
  for (int base = 0; base < C; base += BOX_TILE) {
    const int n = min(BOX_TILE, C - base);
    __syncthreads();
    for (int k = threadIdx.x; k < 6 * n; k += SELECT_BLOCK)
      box[k / n][k % n] = aabbs[(k / n) * C + base + k % n];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      const float x1 = (box[0][j] - r.ox) * ix, x2 = (box[3][j] - r.ox) * ix;
      const float y1 = (box[1][j] - r.oy) * iy, y2 = (box[4][j] - r.oy) * iy;
      const float z1 = (box[2][j] - r.oz) * iz, z2 = (box[5][j] - r.oz) * iz;
      const float tmin = fmaxf(fmaxf(fminf(x1, x2), fminf(y1, y2)), fminf(z1, z2));
      const float tmax = fminf(fminf(fmaxf(x1, x2), fmaxf(y1, y2)), fmaxf(z1, z2));
      if (!(tmax >= tmin && tmax > 0.f)) continue;
      const float ent = fmaxf(tmin, 0.f);
      const int cid = base + j;
      if (!(ent > skip_e || (ent == skip_e && cid > skip_c))) continue;
      if (ent < e1) {
        e3 = e2; e2 = e1; c2 = c1; e1 = ent; c1 = cid;
      } else if (ent < e2) {
        e3 = e2; e2 = ent; c2 = cid;
      } else if (ent < e3) {
        e3 = ent;
      }
    }
  }
  if (!active) return;
  ent_out[ray] = e1;
  ent_out[n_rays + ray] = e2;
  ent_out[2 * n_rays + ray] = e3;
  cid_out[ray] = c1;
  cid_out[n_rays + ray] = c2;
  if (DENSE) {
    float bt = INFINITY;
    int bc = -1;
    nearest_scan(tb, r, 0, 1, bt, bc);
    int sid = -1;
    if (bc >= 0) {
      const int fam = bc >> SLOT_BITS;
      int off = 0;
      for (int f = 0; f < fam; ++f) off += tb.n[f];
      sid = static_cast<int>(dense_sid[off + (bc & SLOT_MASK)]);
    }
    t_out[ray] = bt;
    sid_out[ray] = sid;
  }
}

// Distance from one ray to one cluster slot, by its type code.
__device__ __forceinline__ float slot_distance(int type, const float* p,
                                               const Ray& r, float best) {
  switch (type) {
    case FAM_SPHERE: return t_sphere(p, r);
    case FAM_TRI: return t_tri(p, r);
    case FAM_TORUS: {
      const Torus s = torus_setup(p, r);
      if (!s.hit_box || s.t_lo() > best) return INFINITY;
      return torus_march(s);
    }
    case FAM_AARECT: return t_aarect(p, r);
    case FAM_SQUARE: return t_square(p, r);
    default: return INFINITY;   // padding (-1); planes are never clustered
  }
}

__global__ void __launch_bounds__(PROBE_BLOCK)
probe_kernel(const float* __restrict__ table, int C, int G,
             const float* __restrict__ o, const float* __restrict__ d,
             const int* __restrict__ cidx, int n_rounds, int n_rays,
             float* __restrict__ t_out, int* __restrict__ sid_out) {
  const int ray = (blockIdx.x * PROBE_BLOCK + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (ray >= n_rays) return;   // uniform across the warp
  const Ray r = load_ray(o, d, ray);
  for (int k = 0; k < n_rounds; ++k) {
    int c = cidx[k * n_rays + ray];
    c = c < 0 ? 0 : (c >= C ? C - 1 : c);
    const float* tab = table + static_cast<size_t>(c) * TABLE_ROWS * G;
    float bt = INFINITY;
    int bs = G;
    for (int s = lane; s < G; s += 32) {
      const int type = static_cast<int>(tab[9 * G + s]);
      float p[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) p[q] = tab[q * G + s];
      const float t = slot_distance(type, p, r, bt);
      if (t < bt) {   // ascending slots: strict < keeps the first minimum
        bt = t;
        bs = s;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(PROBE_MASK, bt, off);
      const int os = __shfl_xor_sync(PROBE_MASK, bs, off);
      if (ot < bt || (ot == bt && os < bs)) {
        bt = ot;
        bs = os;
      }
    }
    if (lane == 0) {
      t_out[k * n_rays + ray] = bt;
      sid_out[k * n_rays + ray] =
          bt < INFINITY ? static_cast<int>(tab[10 * G + bs]) : -1;
    }
  }
}

template <bool DENSE>
int launch_select(const float* aabbs, int C, const float* o, const float* d,
                  const float* skip_e, const int* skip_c, int n_rays,
                  float* ent_out, int* cid_out, const float* dense,
                  const Counts& counts, const long long* dense_sid,
                  float* t_out, int* sid_out, void* stream) {
  cudaGetLastError();   // clear a stale error so the return value is ours
  if (n_rays <= 0) return 0;
  int floats = 0;
  if (DENSE)
    for (int f = 0; f < N_FAMS; ++f) floats += counts.n[f] * fam_width(f);
  const int blocks = (n_rays + SELECT_BLOCK - 1) / SELECT_BLOCK;
  select_kernel<DENSE><<<blocks, SELECT_BLOCK, sizeof(float) * floats,
                         static_cast<cudaStream_t>(stream)>>>(
      aabbs, C, o, d, skip_e, skip_c, n_rays, ent_out, cid_out, dense, counts,
      dense_sid, t_out, sid_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wpt

extern "C" {

// K6.  aabbs (6, C) f32: lo.xyz, hi.xyz rows.  ent_out (3, R) f32: the
// first, second and third unvisited entries; cid_out (2, R) i32: the
// first and second ids (0 where the entry is +inf).
int wpt_select(const float* aabbs, int C, const float* o, const float* d,
               const float* skip_e, const int* skip_c, int n_rays,
               float* ent_out, int* cid_out, void* stream) {
  using namespace wpt;
  const Counts none = {{0, 0, 0, 0, 0, 0}};
  return launch_select<false>(aabbs, C, o, d, skip_e, skip_c, n_rays, ent_out,
                              cid_out, nullptr, none, nullptr, nullptr, nullptr,
                              stream);
}

// K3: K6 plus the nearest hit over the dense family tables (the scene
// kernels' layout, <= 64 shapes); dense_sid (n,) i64 maps a slot in
// family order to its shape id.  t_out (R,) f32, sid_out (R,) i32 (-1 on
// a miss).
int wpt_select_scan(const float* aabbs, int C, const float* o, const float* d,
                    const float* skip_e, const int* skip_c, int n_rays,
                    float* ent_out, int* cid_out, const float* dense,
                    int n_plane, int n_sphere, int n_tri, int n_torus,
                    int n_aarect, int n_square, const long long* dense_sid,
                    float* t_out, int* sid_out, void* stream) {
  using namespace wpt;
  const Counts c = {{n_plane, n_sphere, n_tri, n_torus, n_aarect, n_square}};
  return launch_select<true>(aabbs, C, o, d, skip_e, skip_c, n_rays, ent_out,
                             cid_out, dense, c, dense_sid, t_out, sid_out,
                             stream);
}

// K4 (n_rounds = 2) and K5 (n_rounds = 1).  table (C, 11, G) f32;
// cidx (n_rounds, R) i32; t_out (n_rounds, R) f32; sid_out (n_rounds, R)
// i32.
int wpt_probe(const float* table, int C, int G, const float* o, const float* d,
              const int* cidx, int n_rounds, int n_rays, float* t_out,
              int* sid_out, void* stream) {
  using namespace wpt;
  cudaGetLastError();
  if (n_rays <= 0 || n_rounds <= 0) return 0;
  const long long threads = 32LL * n_rays;
  const int blocks = static_cast<int>((threads + PROBE_BLOCK - 1) / PROBE_BLOCK);
  probe_kernel<<<blocks, PROBE_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      table, C, G, o, d, cidx, n_rounds, n_rays, t_out, sid_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
