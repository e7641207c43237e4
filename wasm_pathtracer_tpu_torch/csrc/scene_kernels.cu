// Whole-scene nearest-hit (K1) and any-hit shadow (K2) kernels for Hopper.
//
// Replaces the Pallas TPU kernels of wasm_pathtracer_tpu/ops/scene_pallas.py:
//   wpt_fused_nearest  <- fused_nearest  (kernel _make_kernel)
//   wpt_fused_occluded <- fused_occluded (kernel _make_occ_kernel)
//
// What bounds them on the card: the latency of the longest dependent
// chain, then float32 instruction issue; not memory.  A museum scene table
// is ~5 KB and each ray reads 24 bytes and writes 12.  Its 108 triangles
// are most of the operations a ray needs.  A torus march (up to 24 SDF
// steps and 4 Newton steps, two square roots an SDF step) is a chain of
// ~700 dependent instructions: on the main path's rays 42% of the rays
// enter a torus box before their best hit, 7.6 a ray on average, and one
// march alone outlasts a lane's share of the triangles.
//
// What the design does about it:
//  - every block stages the scene once into shared memory: the triangles
//    in the form of triangle_stage.cuh (the K8 sweep's test, ~40
//    instructions a pair against ~110 when every pair rebuilds the
//    triangle's edges, normal and 1 / |n|), as four float4 arrays by field
//    so that the lanes' broadcast loads of neighbouring triangles fall in
//    neighbouring banks; the other families' rows as they are;
//  - LANES threads share one ray, each taking every LANES-th primitive of
//    every family, and combine with warp shuffles;
//  - the ray's three direction reciprocals are taken once, not once per
//    aarect and torus box;
//  - K1 takes the ray's best hit over the other families, across its
//    lanes, before the tori, and marches only tori whose box entry lies
//    before it (a torus hit is >= the entry, so this is exact); the
//    marches go to a block-wide queue that every thread takes jobs from
//    (march_queue), so that no lane runs a ray's marches one after the
//    other;
//  - the marches take their square roots by sqrt.approx (one MUFU.SQRT,
//    scene_families.cuh), which shortens the chain; t stays within the
//    tolerances phase k1 of chip_smoke.py holds K1 to;
//  - K2 tests the sampled light's own primitive first (t_exc), then
//    stops a ray's lanes at the first other candidate with
//    t < min(dist, t_exc): that candidate makes the verdict.  A flag in
//    shared memory tells the ray's other lanes; they look at it every
//    K2_CHECK primitives.  Cheap families first, tori last, and a torus
//    whose box entry is not before the limit is not marched.
//
// LANES, block sizes, K2_CHECK, the queue and the approximate square root
// were each timed against their alternatives (scripts/kernel_ab.py
// --variant; PERF.md has the table).
//
// Tie-breaks reproduce the TPU kernel: within a family the first minimum
// slot, across families the earliest family.  That is the lexicographic
// minimum of (t, code) with code = fam << 20 | slot, so the order in which
// threads visit primitives (tori last here) does not change the result.
// K2's verdict is the TPU kernel's t_non < dist && t_non < t_exc, with
// t_non the nearest candidate other than the light's and t_exc the
// light's own (+inf for no light or a miss): that holds exactly when some
// other candidate has t < min(dist, t_exc), so a tie t_non == t_exc stays
// unoccluded.
//
// Ragged ends are masked in-kernel; no padding of tables or rays.
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "triangle_stage.cuh"

namespace wpt {

constexpr int K1_LANES = 8;        // threads per ray (a power of two <= 32)
constexpr int K1_BLOCK = 128;      // threads per block
constexpr int K1_MARCH_JOBS = 512; // torus march jobs a block queues at a time
constexpr int K2_LANES = 8;
constexpr int K2_BLOCK = 256;
constexpr int K2_CHECK = 4;        // primitives a lane tests between two looks at the flag
constexpr bool SCENE_APPROX_SQRT = true;   // the torus march's square roots by sqrt.approx
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int SMEM_DEFAULT_LIMIT = 48 * 1024;

// The scene as a block holds it in shared memory: triangles staged, vector
// k of slot j at tri[k * n[FAM_TRI] + j]; the other families' rows as the
// concatenated table has them (fam[FAM_TRI] is unused).
struct SceneSmem {
  const float4* tri;
  const float* fam[N_FAMS];
  int n[N_FAMS];
};

__host__ __device__ inline int raw_floats(const Counts& c) {
  int total = 0;
  for (int f = 0; f < N_FAMS; ++f)
    if (f != FAM_TRI) total += c.n[f] * fam_width(f);
  return total;
}

inline size_t scene_smem_bytes(const Counts& c) {
  return sizeof(TriStage) * c.n[FAM_TRI] + sizeof(float) * raw_floats(c);
}

__device__ __forceinline__ SceneSmem stage_scene(const float* __restrict__ g,
                                                 const Counts& c, float4* smem) {
  SceneSmem sc;
  const int nt = c.n[FAM_TRI];
  float* raw = reinterpret_cast<float*>(smem + 4 * nt);
  // the other families' rows: the table's floats before the triangles and
  // after them, in one loop
  int before = 0, dst = 0;
  for (int f = 0; f < N_FAMS; ++f) {
    sc.n[f] = c.n[f];
    sc.fam[f] = raw + dst;
    if (f < FAM_TRI) before += c.n[f] * fam_width(f);
    if (f != FAM_TRI) dst += c.n[f] * fam_width(f);
  }
  for (int i = threadIdx.x; i < dst; i += blockDim.x)
    raw[i] = g[i < before ? i : i + 9 * nt];
  for (int j = threadIdx.x; j < nt; j += blockDim.x) {
    const TriStage s = stage_triangle(g + before + 9 * j);
    smem[j] = s.n;
    smem[nt + j] = s.m0;
    smem[2 * nt + j] = s.m1;
    smem[3 * nt + j] = s.m2;
  }
  __syncthreads();
  sc.tri = smem;
  return sc;
}

__device__ __forceinline__ float tri_distance(const SceneSmem& sc, int j, const Ray& r) {
  const int nt = sc.n[FAM_TRI];
  bool inside;
  const float t = staged_hit(sc.tri[j], sc.tri[nt + j], sc.tri[2 * nt + j],
                             sc.tri[3 * nt + j], r, inside);
  return (inside && t > 0.f) ? t : INFINITY;
}

// Distance from the ray to the primitive of one code, +inf for a code of
// no primitive (negative, or past its family's count).  Every family's
// row is read at a constant index of sc, so that sc stays in registers.
__device__ __forceinline__ float prim_distance(const SceneSmem& sc, int code,
                                               const Ray& r, const Recip& inv) {
  if (code < 0) return INFINITY;
  const int j = code & SLOT_MASK;
  switch (code >> SLOT_BITS) {
    case FAM_PLANE:
      return j < sc.n[FAM_PLANE] ? t_plane(sc.fam[FAM_PLANE] + 6 * j, r) : INFINITY;
    case FAM_SPHERE:
      return j < sc.n[FAM_SPHERE] ? t_sphere(sc.fam[FAM_SPHERE] + 4 * j, r) : INFINITY;
    case FAM_TRI:
      return j < sc.n[FAM_TRI] ? tri_distance(sc, j, r) : INFINITY;
    case FAM_TORUS: {
      if (j >= sc.n[FAM_TORUS]) return INFINITY;
      const Torus s = torus_setup(sc.fam[FAM_TORUS] + 5 * j, r, inv);
      return s.hit_box ? torus_march<SCENE_APPROX_SQRT>(s) : INFINITY;
    }
    case FAM_AARECT:
      return j < sc.n[FAM_AARECT] ? t_aarect(sc.fam[FAM_AARECT] + 6 * j, r, inv) : INFINITY;
    case FAM_SQUARE:
      return j < sc.n[FAM_SQUARE] ? t_square(sc.fam[FAM_SQUARE] + 4 * j, r) : INFINITY;
    default:
      return INFINITY;
  }
}

__device__ __forceinline__ int code_of_slot(int fam, int j) { return (fam << SLOT_BITS) | j; }

// keep (t, code) if strictly nearer: the first minimum when codes ascend
__device__ __forceinline__ void keep_nearer(float t, int code, float& bt, int& bc) {
  if (t < bt) {
    bt = t;
    bc = code;
  }
}

// the lexicographic (t, code) minimum over a ray's LANES lanes, in every lane
template <int LANES>
__device__ __forceinline__ void group_min(float& bt, int& bc) {
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) {
    const float ot = __shfl_xor_sync(FULL_MASK, bt, off);
    const int oc = __shfl_xor_sync(FULL_MASK, bc, off);
    take_min(ot, oc, bt, bc);
  }
}

// (t, code) as one key whose unsigned order is the lexicographic order of
// (t, code) for t >= 0; a miss (inf, -1) is above every hit
__device__ __forceinline__ unsigned long long pack_hit(float t, int code) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         static_cast<unsigned int>(code);
}

__device__ __forceinline__ float key_t(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned int>(key >> 32));
}

// The torus stage of K1 with a block-wide queue: every lane tests its
// rays' torus boxes and queues a (ray, torus) march job where the entry is
// not beyond the ray's best; then every thread of the block takes jobs, so
// that a ray's marches spread over the whole block instead of waiting in
// its own lanes, and the results merge by a 64-bit atomicMin on
// pack_hit(t, code) per ray.  Tori go in rounds of MARCH_JOBS / rays per
// block, so a round never queues more jobs than the queue holds.
template <int LANES, int BLOCK>
__device__ __forceinline__ void march_queue(const SceneSmem& sc, const Ray& r,
                                            const Recip& inv, bool active,
                                            const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            float& bt, int& bc) {
  constexpr int RAYS = BLOCK / LANES;
  constexpr int CHUNK = K1_MARCH_JOBS / RAYS;
  __shared__ unsigned long long best[RAYS];
  __shared__ int jobs[K1_MARCH_JOBS];
  __shared__ int n_jobs;
  const int local = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int n = sc.n[FAM_TORUS];
  const float* rows = sc.fam[FAM_TORUS];
  volatile unsigned long long* vbest = best;
  if (lane == 0) best[local] = pack_hit(bt, bc);
  for (int base = 0; base < n; base += CHUNK) {
    if (threadIdx.x == 0) n_jobs = 0;
    __syncthreads();
    const int end = min(n, base + CHUNK);
    if (active) {
      const float cut = key_t(vbest[local]);
      for (int j = base + lane; j < end; j += LANES) {
        const Torus s = torus_setup(rows + 5 * j, r, inv);
        if (s.hit_box && s.t_lo() <= cut)
          jobs[atomicAdd(&n_jobs, 1)] = (local << 16) | (j - base);
      }
    }
    __syncthreads();
    const int queued = n_jobs;
    for (int k = threadIdx.x; k < queued; k += BLOCK) {
      const int l = jobs[k] >> 16, j = base + (jobs[k] & 0xffff);
      const Ray jr = load_ray(o, d, blockIdx.x * RAYS + l);
      const Torus s = torus_setup(rows + 5 * j, jr, recip(jr));
      if (s.t_lo() > key_t(vbest[l])) continue;   // a queued job since beaten
      const float t = torus_march<SCENE_APPROX_SQRT>(s);
      if (t < INFINITY) atomicMin(&best[l], pack_hit(t, code_of_slot(FAM_TORUS, j)));
    }
    __syncthreads();
  }
  const unsigned long long key = best[local];
  bt = key_t(key);
  bc = static_cast<int>(static_cast<unsigned int>(key));
}

template <int LANES, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
fused_nearest_kernel(const float* __restrict__ tables, Counts counts,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const long long* __restrict__ sid_of_slot, int n_rays,
                     float* __restrict__ t_out, long long* __restrict__ sid_out) {
  extern __shared__ float4 smem[];
  const SceneSmem sc = stage_scene(tables, counts, smem);

  const int ray = blockIdx.x * (BLOCK / LANES) + threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const bool active = ray < n_rays;
  const Ray r = load_ray(o, d, active ? ray : 0);
  const Recip inv = recip(r);
  float bt = INFINITY;
  int bc = -1;
  if (active) {
    // codes ascend within a lane here, so a strict < keeps the first minimum
    for (int j = lane; j < sc.n[FAM_PLANE]; j += LANES)
      keep_nearer(t_plane(sc.fam[FAM_PLANE] + 6 * j, r), code_of_slot(FAM_PLANE, j), bt, bc);
    for (int j = lane; j < sc.n[FAM_SPHERE]; j += LANES)
      keep_nearer(t_sphere(sc.fam[FAM_SPHERE] + 4 * j, r), code_of_slot(FAM_SPHERE, j), bt, bc);
    for (int j = lane; j < sc.n[FAM_TRI]; j += LANES)
      keep_nearer(tri_distance(sc, j, r), code_of_slot(FAM_TRI, j), bt, bc);
    for (int j = lane; j < sc.n[FAM_AARECT]; j += LANES)
      keep_nearer(t_aarect(sc.fam[FAM_AARECT] + 6 * j, r, inv), code_of_slot(FAM_AARECT, j),
                  bt, bc);
    for (int j = lane; j < sc.n[FAM_SQUARE]; j += LANES)
      keep_nearer(t_square(sc.fam[FAM_SQUARE] + 4 * j, r), code_of_slot(FAM_SQUARE, j), bt, bc);
  }
  // the ray's best over the cheap families, in every lane: a torus whose
  // box entry lies beyond it cannot win
  group_min<LANES>(bt, bc);
  march_queue<LANES, BLOCK>(sc, r, inv, active, o, d, bt, bc);
  if (!active || lane != 0) return;
  long long sid = -1;
  if (bc >= 0) {
    const int fam = bc >> SLOT_BITS;
    int off = 0;
#pragma unroll
    for (int f = 0; f < N_FAMS; ++f) off += f < fam ? sc.n[f] : 0;
    sid = sid_of_slot[off + (bc & SLOT_MASK)];
  }
  t_out[ray] = bt;
  sid_out[ray] = sid;
}

// Whether some slot j = lane, lane + LANES, ... < n other than `skip` has
// dist(j) < limit.  A lane looks at its ray's flag every CHECK slots, and
// sets it when it finds one, so that the ray's other lanes stop too.
template <int LANES, int CHECK, typename Dist>
__device__ __forceinline__ bool any_below(int n, int lane, int skip, float limit,
                                          volatile int* flag, Dist dist) {
  for (int j0 = lane; j0 < n; j0 += CHECK * LANES) {
    if (*flag) return true;
    bool found = false;
#pragma unroll
    for (int u = 0; u < CHECK; ++u) {
      const int j = j0 + u * LANES;
      if (j < n && j != skip) found |= dist(j) < limit;
    }
    if (found) {
      *flag = 1;
      return true;
    }
  }
  return false;
}

template <int LANES, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
fused_occluded_kernel(const float* __restrict__ tables, Counts counts,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ dist_in,
                      const long long* __restrict__ light_sid,
                      const int* __restrict__ code_of, int n_rays,
                      bool* __restrict__ occ_out) {
  extern __shared__ float4 smem[];
  __shared__ int found[BLOCK / LANES];
  const int local = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  if (lane == 0) found[local] = 0;
  const SceneSmem sc = stage_scene(tables, counts, smem);   // syncs

  const int ray = blockIdx.x * (BLOCK / LANES) + local;
  const bool active = ray < n_rays;
  bool occ = false;
  if (active) {
    const Ray r = load_ray(o, d, ray);
    const Recip inv = recip(r);
    const long long lsid = light_sid[ray];
    const int excl = lsid >= 0 ? code_of[lsid] : -1;
    const float limit = fminf(dist_in[ray], prim_distance(sc, excl, r, inv));
    const int excl_fam = excl >= 0 ? excl >> SLOT_BITS : -1;
    const int excl_slot = excl & SLOT_MASK;
    auto skip = [&](int fam) { return excl_fam == fam ? excl_slot : -1; };
    volatile int* flag = found + local;
    occ = any_below<LANES, K2_CHECK>(
              sc.n[FAM_PLANE], lane, skip(FAM_PLANE), limit, flag,
              [&](int j) { return t_plane(sc.fam[FAM_PLANE] + 6 * j, r); }) ||
          any_below<LANES, K2_CHECK>(
              sc.n[FAM_SQUARE], lane, skip(FAM_SQUARE), limit, flag,
              [&](int j) { return t_square(sc.fam[FAM_SQUARE] + 4 * j, r); }) ||
          any_below<LANES, K2_CHECK>(
              sc.n[FAM_AARECT], lane, skip(FAM_AARECT), limit, flag,
              [&](int j) { return t_aarect(sc.fam[FAM_AARECT] + 6 * j, r, inv); }) ||
          any_below<LANES, K2_CHECK>(
              sc.n[FAM_SPHERE], lane, skip(FAM_SPHERE), limit, flag,
              [&](int j) { return t_sphere(sc.fam[FAM_SPHERE] + 4 * j, r); }) ||
          any_below<LANES, K2_CHECK>(
              sc.n[FAM_TRI], lane, skip(FAM_TRI), limit, flag,
              [&](int j) { return tri_distance(sc, j, r); }) ||
          // a torus hit is >= its box entry: no march unless that is before the limit
          any_below<LANES, 1>(
              sc.n[FAM_TORUS], lane, skip(FAM_TORUS), limit, flag, [&](int j) {
                const Torus s = torus_setup(sc.fam[FAM_TORUS] + 5 * j, r, inv);
                return (s.hit_box && s.t_lo() < limit) ? torus_march<SCENE_APPROX_SQRT>(s)
                                                       : INFINITY;
              });
  }
  int any = occ;
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) any |= __shfl_xor_sync(FULL_MASK, any, off);
  if (active && lane == 0) occ_out[ray] = any != 0;
}

template <typename Kernel>
cudaError_t prepare_launch(Kernel kernel, size_t smem) {
  if (smem > SMEM_DEFAULT_LIMIT)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

}  // namespace wpt

extern "C" {

// K1.  sid_of_slot maps a slot of the concatenated families (family
// order) to its shape id.  t_out (R,) f32 (+inf on a miss), sid_out (R,)
// i64 (-1 on a miss).
int wpt_fused_nearest(const float* tables, int n_plane, int n_sphere, int n_tri,
                      int n_torus, int n_aarect, int n_square, const float* o,
                      const float* d, const long long* sid_of_slot, int n_rays,
                      float* t_out, long long* sid_out, void* stream) {
  using namespace wpt;
  cudaGetLastError();   // clear a stale error so the return value is ours
  if (n_rays <= 0) return 0;
  const Counts c = {{n_plane, n_sphere, n_tri, n_torus, n_aarect, n_square}};
  const size_t smem = scene_smem_bytes(c);
  cudaError_t err = prepare_launch(fused_nearest_kernel<K1_LANES, K1_BLOCK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rays_per_block = K1_BLOCK / K1_LANES;
  const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  fused_nearest_kernel<K1_LANES, K1_BLOCK>
      <<<blocks, K1_BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      tables, c, o, d, sid_of_slot, n_rays, t_out, sid_out);
  return static_cast<int>(cudaGetLastError());
}

// K2.  light_sid (R,) i64 is the sampled light's shape id (-1 for none);
// code_of (N,) i32 maps a shape id to its fam << 20 | slot code (-2 for a
// shape in no family).  occ_out (R,) bool.
int wpt_fused_occluded(const float* tables, int n_plane, int n_sphere, int n_tri,
                       int n_torus, int n_aarect, int n_square, const float* o,
                       const float* d, const float* dist, const long long* light_sid,
                       const int* code_of, int n_rays, bool* occ_out, void* stream) {
  using namespace wpt;
  cudaGetLastError();
  if (n_rays <= 0) return 0;
  const Counts c = {{n_plane, n_sphere, n_tri, n_torus, n_aarect, n_square}};
  const size_t smem = scene_smem_bytes(c);
  cudaError_t err = prepare_launch(fused_occluded_kernel<K2_LANES, K2_BLOCK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rays_per_block = K2_BLOCK / K2_LANES;
  const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  fused_occluded_kernel<K2_LANES, K2_BLOCK>
      <<<blocks, K2_BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      tables, c, o, d, dist, light_sid, code_of, n_rays, occ_out);
  return static_cast<int>(cudaGetLastError());
}

// What K1 and K2 were built with: out[0..3] = K1's lanes per ray,
// threads per block, registers per thread and local (spill) bytes;
// out[4..7] K2's.
int wpt_scene_launch_shape(int* out) {
  using namespace wpt;
  cudaGetLastError();
  cudaFuncAttributes a1, a2;
  cudaError_t rc = cudaFuncGetAttributes(&a1, fused_nearest_kernel<K1_LANES, K1_BLOCK>);
  if (rc == cudaSuccess)
    rc = cudaFuncGetAttributes(&a2, fused_occluded_kernel<K2_LANES, K2_BLOCK>);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int shape[8] = {K1_LANES, K1_BLOCK, a1.numRegs, static_cast<int>(a1.localSizeBytes),
                        K2_LANES, K2_BLOCK, a2.numRegs, static_cast<int>(a2.localSizeBytes)};
  for (int i = 0; i < 8; ++i) out[i] = shape[i];
  return 0;
}

}  // extern "C"
