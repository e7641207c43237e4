// Cluster select (K3, K6) and probe (K4, K5, K7) kernels for Hopper.
//
// Replace the Pallas TPU kernels of wasm_pathtracer_tpu/ops/probe_pallas.py:
//   wpt_select_scan  <- select_scan      (_make_select_scan_kernel)   K3
//   wpt_select       <- select_blocks    (_make_select_kernel)        K6
//   wpt_probe        <- probe_pair_raw   (_make_pair_kernel, 2 rounds) K4
//                    <- probe_blocks_min (_make_min_kernel, 1 round)   K5
//   wpt_probe_blocks <- probe_blocks     (_make_kernel, unreduced)     K7
//
// Select (K3/K6), SELECT_LANES lanes per ray.  Every ray runs the slab
// test against all C cluster boxes and keeps, after its lex cursor
// (skip_e, skip_c), the two lexicographically smallest (entry, id) pairs
// and the entry of the third.  What bounds it: float32 instruction throughput.
// The bound counts 27 operations per (ray, box) at the card's 67 TFLOP/s,
// which is its fused-multiply-add rate; the slab test has no product to
// fuse (it must stay the plain version's operation for operation, so that
// entries equal it bit for bit), and with the cursor test and the
// insertion a pair takes ~43 instructions of the ~33.5 T/s the card
// executes: a floor near 0.012 ms at 16,384 rays x 550 boxes, where the
// bound reads 0.0036 ms.  The (6, C) box table (13 KB at C = 550, 56 KB at
// C = 2,344) is read by every ray and never leaves L1/L2.
// What the design does:
//  - lane j of a ray's group takes boxes j, j + L, ... and keeps its own
//    sorted three (e1, c1), (e2, c2), e3; the group merges them with xor
//    shuffles in log2 L rounds (merge_top3).  The three smallest of a union
//    lie in the union of the three smallest, so the merge is exact; it
//    compares (entry, id) lexicographically, since ids no longer ascend in
//    visit order, and the third needs no id because only its entry is
//    returned.  Within a lane ids do ascend, and strict compares on the
//    entry keep the lowest id among equal entries: the TPU kernel's
//    min / where(ent == e) reduction.  With 16,384 rays x 8 lanes there are
//    4,096 warps to fill 132 SMs, where one thread per ray (the first
//    version: 128 blocks of 4 warps, one dependent chain per ray) left the
//    card ~3% occupied;
//  - a block stages the boxes once into shared memory, transposed to one
//    float4 of lows and one of highs per box (tiles of SELECT_TILE boxes,
//    one tile at C = 550), so that a box costs two 16-byte loads at
//    immediate offsets where six 4-byte loads from the (6, C) rows cost six
//    64-bit address computations as well;
//  - the loop has no branch: the cursor and hit tests combine into one
//    predicate, a box that fails enters as +inf, and the insertion into the
//    sorted three is five min/max and three selects (insert_top3).  A
//    branch per box diverges in most trips, since some lane of a warp
//    nearly always has a box to insert.
// Timed and dropped (PERF.md): boxes read straight from global memory
// through L1 with a branching insertion (as fast at C = 550, slower at
// C = 2,344); two rays per thread on top of that; 4, 16 and 32 lanes (4 and
// 16 within a few percent of 8, 32 pays for five merge rounds).
// With DENSE (K3) the group also splits the small dense remainder (<= 64
// shapes, staged in shared memory) with the stride nearest_scan takes, as
// K1 does, and folds the lanes' (t, code) minima the same way; the family
// functions are the scene kernels' (scene_families.cuh), as the TPU kernel
// reuses the megakernel's _t_planes ... _t_squares.
//
// Probe (K4/K5/K7): the distance from a ray to each of the G slots of one
// cluster, and for K4/K5 their lexicographic (t, slot) minimum: the
// first-minimum slot of the TPU kernel's _reduce_min_row.  K4 is two
// rounds (clusters c1 and c2 of every ray), K5 one.  What bounds it: the
// loads of the slots, not the operations.  The function needs 42
// operations a (ray, triangle) pair (chip_smoke.py's FLOPS), 0.0013 ms a
// round at 16,384 rays x 128 slots, and its inputs stay in the 50 MB L2
// (the 11-row table is 3.1 MB at C = 550 and 13.2 MB at C = 2,344, the
// staged table beside it 4.5 and 19.2 MB), but each (ray, round) reads its
// own cluster's 8 KB of staged rows: a K5 call moves 134 MB from L2 and L1
// into the SMs, and K4 twice that.  A launch alone takes ~0.0024 ms.
// What the design does:
//  - triangles staged once per scene: ClusterSet.staged holds each
//    triangle slot in K8's form (triangle_stage.cuh: the plane and per
//    edge m_i, k_i), built with the cluster set, so a pair is staged_t's
//    FMA chain and one rcp.approx, then staged_inside's three, where
//    rebuilding the triangle from its vertices (t_tri: edges, normal, IEEE
//    1 / sqrt and division) took ~80 instructions.  Unlike K1, K2 and K8 a
//    probe cannot stage per block, since every lane group probes its own
//    ray's cluster, but the staging does not depend on the ray;
//  - the table is laid out (C, 4, G) float4 with row q of every slot
//    together, so a lane group's load of row q is one contiguous run; K4
//    and K5 read the three edge rows only where the plane hit lies in
//    (0, best) (staged_slot), which is exact;
//  - a set of triangles only (MIXED false: mesh70k, the clouds) reads no
//    type code: a slot that is not a triangle is padding, whose staged
//    rows are zero and never hit (t = 0 fails t > 0).  A mixed set reads
//    the type and tests spheres, tori, aarects and squares with the scene
//    kernels' IEEE family tests (scene_families.cuh) on the 11-row table,
//    loading only the parameters the family reads.  A lane skips a torus
//    whose box entry is beyond its best hit so far (exact: a torus hit is
//    >= that entry);
//  - every (ray, round) has its own group of PROBE_LANES (16) lanes, two
//    rays a warp: K4's two rounds, independent of each other, run side by
//    side instead of one after the other in one warp.  Group g is round
//    g / R of ray g % R, so it reads cidx[g] and writes t_out[g],
//    sid_out[g].  Lane j takes slots j, j + L, ... in ascending order with
//    a strict < (the first minimum), PROBE_UNROLL of them in flight, and
//    the group reduces in log2 L xor-shuffle rounds on (t, slot);
//  - K7 is the same body compiled with STORE_ALL, BLOCKS_LANES (32) lanes
//    a ray: each lane stores every slot's distance into the (R, G) matrix
//    (+inf on a miss or padding; a group's stores are contiguous in the
//    row) and there is no running best, so no torus is skipped and every
//    slot's four rows are read.  K5's skips are exact, so K7's minimum
//    over G equals K5's t bit for bit.
// Timed and dropped (scripts/kernel_ab.py --only probe; PERF.md): the
// rounds one after the other in one group (as fast: the kernel is bound by
// its loads, not by one group's chain); for K4/K5 8 and 32 lanes (+25% and
// +14% for K4 on mesh70k; 8 lanes are 3% faster on the clustered museum),
// all four rows read for every slot (+6% for K4), an unroll of 1 or 2
// (+13%, +6%); for K7 16 lanes (+19%) and the edge rows read only where
// t > 0 (+7%).
// The triangle arithmetic is that of K1, K2 and K8 (triangle_stage.cuh),
// not the TPU kernel's probe_pallas._tri_test: the staged inside test may
// put a hit point within rounding of an edge on the other side.
//
// Output contract: (t, sid) per round, t = +inf and sid = -1 on a miss.
// The TPU kernels also returned the winner's table row so that shading
// needed no gather on the TPU; here shading gathers the shape's row.
// Cluster ids are clamped into [0, C) on input.  Plain C interface for
// ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "triangle_stage.cuh"

namespace wpt {

constexpr int SELECT_LANES = 8;     // lanes per ray (a power of two <= 32)
constexpr int SELECT_TILE = 1024;   // boxes per shared-memory tile
constexpr int SELECT_BLOCK = 256;   // threads per select block
constexpr int SELECT_RAYS = SELECT_BLOCK / SELECT_LANES;   // rays per block
constexpr int PROBE_LANES = 16;     // K4/K5: lanes per (ray, round) (a power of two <= 32)
constexpr int BLOCKS_LANES = 32;    // K7: lanes per ray
constexpr int PROBE_BLOCK = 128;    // threads per probe block
constexpr int PROBE_UNROLL = 4;     // slots a lane has in flight (triangles only)
constexpr int TABLE_ROWS = 11;      // params 0-8, type code, shape id
constexpr int STAGE_ROWS = 4;       // float4 rows of a staged triangle
constexpr unsigned PROBE_MASK = 0xffffffffu;

__device__ __forceinline__ float nz30(float x) {
  return fabsf(x) < 1e-30f ? 1e-30f : x;
}

// A lane's or a group's three smallest unvisited entries, in lexicographic
// (entry, id) order; the third's id is not kept.  +inf where there is none
// (its id reads 0).
struct Top3 {
  float e1, e2, e3;
  int c1, c2;
};

__device__ __forceinline__ bool lex_less(float e, int c, float f, int d) {
  return e < f || (e == f && c < d);
}

// a <- the three smallest of a and b together
__device__ __forceinline__ void merge_top3(Top3& a, Top3 b) {
  if (lex_less(b.e1, b.c1, a.e1, a.c1)) {
    const Top3 s = a;
    a = b;
    b = s;
  }
  // a's first is the smallest; the second is a's second or b's first
  if (lex_less(b.e1, b.c1, a.e2, a.c2)) {
    a.e3 = fminf(a.e2, b.e2);
    a.e2 = b.e1;
    a.c2 = b.c1;
  } else {
    a.e3 = fminf(a.e3, b.e1);
  }
}

// insert (ent, cid) into a sorted three without a branch; ent = +inf is a
// no-op, and a strict < keeps the earlier (lower) id among equal entries
__device__ __forceinline__ void insert_top3(Top3& t, float ent, int cid) {
  const bool lt1 = ent < t.e1, lt2 = ent < t.e2;
  t.c2 = lt1 ? t.c1 : (lt2 ? cid : t.c2);
  t.c1 = lt1 ? cid : t.c1;
  t.e3 = fminf(t.e3, fmaxf(t.e2, ent));
  t.e2 = fminf(t.e2, fmaxf(t.e1, ent));
  t.e1 = fminf(t.e1, ent);
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
  __shared__ float4 box_lo[SELECT_TILE], box_hi[SELECT_TILE];
  extern __shared__ float smem[];
  Tables tb;
  if (DENSE) tb = stage_tables(dense, dense_counts, smem);

  const int ray = blockIdx.x * SELECT_RAYS + threadIdx.x / SELECT_LANES;
  const int lane = threadIdx.x % SELECT_LANES;
  const bool active = ray < n_rays;
  const int src = active ? ray : 0;   // a group past the end copies ray 0
  const Ray r = load_ray(o, d, src);
  const float skip_e = skip_e_in[src];
  const int skip_c = skip_c_in[src];
  const float ix = 1.f / nz30(r.dx), iy = 1.f / nz30(r.dy), iz = 1.f / nz30(r.dz);
  Top3 best = {INFINITY, INFINITY, INFINITY, 0, 0};
  for (int base = 0; base < C; base += SELECT_TILE) {
    const int n = min(SELECT_TILE, C - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += SELECT_BLOCK) {
      const float* b = aabbs + base + k;
      box_lo[k] = make_float4(b[0], b[C], b[2 * C], 0.f);
      box_hi[k] = make_float4(b[3 * C], b[4 * C], b[5 * C], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = lane; j < n; j += SELECT_LANES) {
      const float4 lo = box_lo[j], hi = box_hi[j];
      const float x1 = (lo.x - r.ox) * ix, x2 = (hi.x - r.ox) * ix;
      const float y1 = (lo.y - r.oy) * iy, y2 = (hi.y - r.oy) * iy;
      const float z1 = (lo.z - r.oz) * iz, z2 = (hi.z - r.oz) * iz;
      const float tmin = fmaxf(fmaxf(fminf(x1, x2), fminf(y1, y2)), fminf(z1, z2));
      const float tmax = fminf(fminf(fmaxf(x1, x2), fmaxf(y1, y2)), fmaxf(z1, z2));
      const float ent = fmaxf(tmin, 0.f);
      const int cid = base + j;
      // & and | on purpose: no short-circuit, so no branch in the loop
      const bool take = (tmax >= tmin) & (tmax > 0.f) &
                        ((ent > skip_e) | ((ent == skip_e) & (cid > skip_c)));
      insert_top3(best, take ? ent : INFINITY, cid);
    }
  }
  float bt = INFINITY;
  int bc = -1;
  if (DENSE) nearest_scan(tb, r, lane, SELECT_LANES, bt, bc);
  // fold the group's lanes (every lane of the warp takes part)
#pragma unroll
  for (int off = 1; off < SELECT_LANES; off <<= 1) {
    Top3 other;
    other.e1 = __shfl_xor_sync(PROBE_MASK, best.e1, off);
    other.c1 = __shfl_xor_sync(PROBE_MASK, best.c1, off);
    other.e2 = __shfl_xor_sync(PROBE_MASK, best.e2, off);
    other.c2 = __shfl_xor_sync(PROBE_MASK, best.c2, off);
    other.e3 = __shfl_xor_sync(PROBE_MASK, best.e3, off);
    merge_top3(best, other);
    if (DENSE) {
      const float ot = __shfl_xor_sync(PROBE_MASK, bt, off);
      const int oc = __shfl_xor_sync(PROBE_MASK, bc, off);
      take_min(ot, oc, bt, bc);
    }
  }
  if (!active || lane != 0) return;
  ent_out[ray] = best.e1;
  ent_out[n_rays + ray] = best.e2;
  ent_out[2 * n_rays + ray] = best.e3;
  cid_out[ray] = best.c1;
  cid_out[n_rays + ray] = best.c2;
  if (DENSE) {
    int sid = -1;
    if (bc >= 0) {
      const int fam = bc >> SLOT_BITS;
      int off = 0;
#pragma unroll
      for (int f = 0; f < N_FAMS; ++f) off += f < fam ? tb.n[f] : 0;
      sid = static_cast<int>(dense_sid[off + (bc & SLOT_MASK)]);
    }
    t_out[ray] = bt;
    sid_out[ray] = sid;
  }
}

// Distance from one ray to triangle slot s of a cluster's staged rows st
// (STAGE_ROWS x G float4), +inf unless 0 < t < limit and the hit point is
// inside; zero rows (padding) never hit (t = 0).  With CULL the three edge
// rows are read only where the plane hit can count: exact, since a slot
// with t >= limit never wins (strict <) and one with t <= 0 is a miss.
template <bool CULL>
__device__ __forceinline__ float staged_slot(const float4* __restrict__ st, int G,
                                             int s, const Ray& r, float limit) {
  const float t = staged_t(st[s], r);
  if (CULL && !(t > 0.f && t < limit)) return INFINITY;
  const bool inside = staged_inside(st[G + s], st[2 * G + s], st[3 * G + s], r, t);
  return inside && t > 0.f && t < limit ? t : INFINITY;
}

// the first W parameters of slot s of a cluster's 11-row table
template <int W>
__device__ __forceinline__ void load_params(const float* __restrict__ tab, int G,
                                            int s, float* p) {
#pragma unroll
  for (int q = 0; q < W; ++q) p[q] = tab[q * G + s];
}

// Distance from one ray to a slot that is not a triangle, by its type
// code; a torus whose box entry is beyond best is skipped.
__device__ __forceinline__ float family_distance(int type, const float* __restrict__ tab,
                                                 int G, int s, const Ray& r,
                                                 float best) {
  float p[6];
  switch (type) {
    case FAM_SPHERE: load_params<4>(tab, G, s, p); return t_sphere(p, r);
    case FAM_TORUS: {
      load_params<5>(tab, G, s, p);
      const Torus ts = torus_setup(p, r);
      if (!ts.hit_box || ts.t_lo() > best) return INFINITY;
      return torus_march(ts);
    }
    case FAM_AARECT: load_params<6>(tab, G, s, p); return t_aarect(p, r);
    case FAM_SQUARE: load_params<4>(tab, G, s, p); return t_square(p, r);
    default: return INFINITY;   // padding (-1); planes are never clustered
  }
}

template <bool STORE_ALL, bool MIXED>
__global__ void __launch_bounds__(PROBE_BLOCK)
probe_kernel(const float* __restrict__ table, const float4* __restrict__ staged,
             int C, int G, const float* __restrict__ o, const float* __restrict__ d,
             const int* __restrict__ cidx, int n_groups, int n_rays,
             float* __restrict__ t_out, int* __restrict__ sid_out) {
  constexpr int L = STORE_ALL ? BLOCKS_LANES : PROBE_LANES;
  const int lane = threadIdx.x % L;
  const int group = (blockIdx.x * PROBE_BLOCK + threadIdx.x) / L;
  // a group past the end repeats group 0 and stores nothing: every lane
  // of the warp takes part in the shuffles
  const bool active = group < n_groups;
  const int g = active ? group : 0;
  const int ray = g % n_rays;
  const Ray r = load_ray(o, d, ray);
  int c = cidx[g];
  c = c < 0 ? 0 : (c >= C ? C - 1 : c);
  const float* tab = table + static_cast<size_t>(c) * TABLE_ROWS * G;
  const float4* st = staged + static_cast<size_t>(c) * STAGE_ROWS * G;
  float bt = INFINITY;
  int bs = G;
  // one slot's distance: K7 stores it into the (R, G) matrix t_out;
  // K4/K5 keep the first minimum (ascending slots, strict <)
  auto fold = [&](int s, float t) {
    if constexpr (STORE_ALL) {
      if (active) t_out[static_cast<size_t>(ray) * G + s] = t;
    } else if (t < bt) {
      bt = t;
      bs = s;
    }
  };
  // K7 keeps every distance; K4/K5 need none at or beyond the best so far
  if constexpr (MIXED) {
#pragma unroll 1
    for (int s = lane; s < G; s += L) {
      const int type = static_cast<int>(tab[9 * G + s]);
      const float limit = STORE_ALL ? INFINITY : bt;
      fold(s, type == FAM_TRI ? staged_slot<!STORE_ALL>(st, G, s, r, limit)
                              : family_distance(type, tab, G, s, r, limit));
    }
  } else {   // every slot that is not a triangle is padding
#pragma unroll PROBE_UNROLL
    for (int s = lane; s < G; s += L)
      fold(s, staged_slot<!STORE_ALL>(st, G, s, r, STORE_ALL ? INFINITY : bt));
  }
  if constexpr (!STORE_ALL) {
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(PROBE_MASK, bt, off);
      const int os = __shfl_xor_sync(PROBE_MASK, bs, off);
      if (ot < bt || (ot == bt && os < bs)) {
        bt = ot;
        bs = os;
      }
    }
    if (active && lane == 0) {
      t_out[g] = bt;
      sid_out[g] = bt < INFINITY ? static_cast<int>(tab[10 * G + bs]) : -1;
    }
  }
}

static int probe_blocks_for(int n_groups, int lanes) {
  const long long threads = static_cast<long long>(lanes) * n_groups;
  return static_cast<int>((threads + PROBE_BLOCK - 1) / PROBE_BLOCK);
}

template <bool STORE_ALL>
int launch_probe(const float* table, const void* staged, int C, int G, int mixed,
                 const float* o, const float* d, const int* cidx, int n_rounds,
                 int n_rays, float* t_out, int* sid_out, void* stream) {
  cudaGetLastError();   // clear a stale error so the return value is ours
  if (n_rays <= 0 || n_rounds <= 0) return 0;
  const int n_groups = n_rounds * n_rays;
  const float4* st = static_cast<const float4*>(staged);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = probe_blocks_for(n_groups, STORE_ALL ? BLOCKS_LANES : PROBE_LANES);
  if (mixed)
    probe_kernel<STORE_ALL, true><<<blocks, PROBE_BLOCK, 0, s>>>(
        table, st, C, G, o, d, cidx, n_groups, n_rays, t_out, sid_out);
  else
    probe_kernel<STORE_ALL, false><<<blocks, PROBE_BLOCK, 0, s>>>(
        table, st, C, G, o, d, cidx, n_groups, n_rays, t_out, sid_out);
  return static_cast<int>(cudaGetLastError());
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
  const int blocks = (n_rays + SELECT_RAYS - 1) / SELECT_RAYS;
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
// staged (C, 4, G, 4) f32, 16-byte aligned; mixed: 0 when every clustered
// shape is a triangle; cidx (n_rounds, R) i32; t_out (n_rounds, R) f32;
// sid_out (n_rounds, R) i32.
int wpt_probe(const float* table, const void* staged, int C, int G, int mixed,
              const float* o, const float* d, const int* cidx, int n_rounds,
              int n_rays, float* t_out, int* sid_out, void* stream) {
  return wpt::launch_probe<false>(table, staged, C, G, mixed, o, d, cidx, n_rounds,
                                  n_rays, t_out, sid_out, stream);
}

// K7.  table, staged and mixed as for K4; cidx (R,) i32; dist_out (R, G)
// f32: the distance of every slot of the ray's cluster, +inf on a miss or
// padding.
int wpt_probe_blocks(const float* table, const void* staged, int C, int G, int mixed,
                     const float* o, const float* d, const int* cidx, int n_rays,
                     float* dist_out, void* stream) {
  return wpt::launch_probe<true>(table, staged, C, G, mixed, o, d, cidx, 1, n_rays,
                                 dist_out, nullptr, stream);
}

// The probe's launch shape for R rays and n_rounds rounds, and what the
// compiler gave its four kernels: out[0..4] = K4/K5's grid x, threads per
// block, K4/K5's lanes per (ray, round), K7's grid x for R rays, K7's lanes
// per ray; then for K4/K5 on triangles, K4/K5 on a mixed set, K7 on
// triangles and K7 on a mixed set, three each: registers per thread,
// static shared bytes, local (spill) bytes.
int wpt_probe_launch_shape(int n_rays, int n_rounds, int* out) {
  using namespace wpt;
  cudaGetLastError();
  const void* kernels[4] = {
      reinterpret_cast<const void*>(probe_kernel<false, false>),
      reinterpret_cast<const void*>(probe_kernel<false, true>),
      reinterpret_cast<const void*>(probe_kernel<true, false>),
      reinterpret_cast<const void*>(probe_kernel<true, true>)};
  const bool any = n_rays > 0 && n_rounds > 0;
  out[0] = any ? probe_blocks_for(n_rounds * n_rays, PROBE_LANES) : 0;
  out[1] = PROBE_BLOCK;
  out[2] = PROBE_LANES;
  out[3] = any ? probe_blocks_for(n_rays, BLOCKS_LANES) : 0;
  out[4] = BLOCKS_LANES;
  for (int i = 0; i < 4; ++i) {
    cudaFuncAttributes attr;
    const cudaError_t rc = cudaFuncGetAttributes(&attr, kernels[i]);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    out[5 + 3 * i] = attr.numRegs;
    out[6 + 3 * i] = static_cast<int>(attr.sharedSizeBytes);
    out[7 + 3 * i] = static_cast<int>(attr.localSizeBytes);
  }
  return 0;
}

}  // extern "C"
