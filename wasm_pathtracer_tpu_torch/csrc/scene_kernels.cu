// Whole-scene nearest-hit (K1) and any-hit shadow (K2) kernels for Hopper.
//
// Replaces the Pallas TPU kernels of wasm_pathtracer_tpu/ops/scene_pallas.py:
//   wpt_fused_nearest  <- fused_nearest  (kernel _make_kernel)
//   wpt_fused_occluded <- fused_occluded (kernel _make_occ_kernel)
//
// What bounds them on the card: FP32 ALU work, not memory.  A museum
// scene table is ~5 KB and each ray reads 24 bytes and writes 12; the
// torus march (24 SDF steps + 4 Newton steps, two square roots per SDF
// evaluation) is ~80% of the arithmetic of a full-scene test.
//
// What the design does about it:
//  - the family tables are copied once per block into shared memory, so
//    the inner loops read only shared memory and registers;
//  - SPLIT threads share one ray, each taking every SPLIT-th primitive
//    of every family, and combine their results with warp shuffles.  At
//    the main path's 16,384 rays this gives 4x more warps to hide ALU and
//    shared-memory latency than one thread per ray;
//  - the expensive torus march is skipped wherever it provably cannot
//    change the answer: the ray misses the torus' bounding box; the
//    box's entry distance is already beyond the best hit (K1) or the
//    light (K2); or, in K2, cheaper families already prove occlusion and
//    the sampled light is not a torus.  The march itself stops only at an
//    exact fixed point (scene_families.cuh).
//
// Tie-breaks reproduce the TPU kernel: within a family the first minimum
// slot, across families the earliest family.  That is the lexicographic
// minimum of (t, code) with code = fam << 20 | slot, so the order in which
// threads visit primitives (tori last here) does not change the result.
//
// Ragged ends are masked in-kernel; no padding of tables or rays.
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "scene_families.cuh"

namespace wpt {

constexpr int SPLIT = 4;           // threads per ray (a power of two <= 32)
constexpr int BLOCK = 128;         // threads per block
constexpr int RAYS_PER_BLOCK = BLOCK / SPLIT;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int SMEM_DEFAULT_LIMIT = 48 * 1024;

__global__ void __launch_bounds__(BLOCK)
fused_nearest_kernel(const float* __restrict__ tables, Counts counts,
                     const float* __restrict__ o, const float* __restrict__ d,
                     int n_rays, float* __restrict__ t_out,
                     int* __restrict__ fam_out, int* __restrict__ slot_out) {
  extern __shared__ float smem[];
  const Tables tb = stage_tables(tables, counts, smem);

  const int ray = blockIdx.x * RAYS_PER_BLOCK + threadIdx.x / SPLIT;
  const int sub = threadIdx.x % SPLIT;
  float bt = INFINITY;
  int bc = -1;
  if (ray < n_rays) {
    const Ray r = load_ray(o, d, ray);
    nearest_scan(tb, r, sub, SPLIT, bt, bc);
  }
  // combine the SPLIT partial minima of each ray (all lanes take part)
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1) {
    const float ot = __shfl_xor_sync(FULL_MASK, bt, off);
    const int oc = __shfl_xor_sync(FULL_MASK, bc, off);
    take_min(ot, oc, bt, bc);
  }
  if (ray < n_rays && sub == 0) {
    t_out[ray] = bt;
    fam_out[ray] = bc >= 0 ? bc >> SLOT_BITS : -1;
    slot_out[ray] = bc >= 0 ? bc & SLOT_MASK : 0;
  }
}

// Any-hit predicate.  t_non: nearest candidate that is not the sampled
// light; t_exc: the light's own nearest candidate.  Occluded iff
// t_non < dist && t_non < t_exc.
__device__ __forceinline__ void fold_occ(float t, int code, int excl,
                                         float& t_non, float& t_exc) {
  if (code == excl) t_exc = fminf(t_exc, t);
  else t_non = fminf(t_non, t);
}

__device__ __forceinline__ void group_min(float& v) {
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1)
    v = fminf(v, __shfl_xor_sync(FULL_MASK, v, off));
}

__global__ void __launch_bounds__(BLOCK)
fused_occluded_kernel(const float* __restrict__ tables, Counts counts,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ dist_in,
                      const int* __restrict__ excl_in, int n_rays,
                      bool* __restrict__ occ_out) {
  extern __shared__ float smem[];
  const Tables tb = stage_tables(tables, counts, smem);

  const int ray = blockIdx.x * RAYS_PER_BLOCK + threadIdx.x / SPLIT;
  const int sub = threadIdx.x % SPLIT;
  const bool active = ray < n_rays;
  float t_non = INFINITY, t_exc = INFINITY, dist = 0.f;
  int excl = -1;
  Ray r;
  if (active) {
    r = load_ray(o, d, ray);
    dist = dist_in[ray];
    excl = excl_in[ray];
    for (int j = sub; j < tb.n[FAM_PLANE]; j += SPLIT)
      fold_occ(t_plane(tb.fam[FAM_PLANE] + 6 * j, r), (FAM_PLANE << SLOT_BITS) | j, excl, t_non, t_exc);
    for (int j = sub; j < tb.n[FAM_SPHERE]; j += SPLIT)
      fold_occ(t_sphere(tb.fam[FAM_SPHERE] + 4 * j, r), (FAM_SPHERE << SLOT_BITS) | j, excl, t_non, t_exc);
    for (int j = sub; j < tb.n[FAM_TRI]; j += SPLIT)
      fold_occ(t_tri(tb.fam[FAM_TRI] + 9 * j, r), (FAM_TRI << SLOT_BITS) | j, excl, t_non, t_exc);
    for (int j = sub; j < tb.n[FAM_AARECT]; j += SPLIT)
      fold_occ(t_aarect(tb.fam[FAM_AARECT] + 6 * j, r), (FAM_AARECT << SLOT_BITS) | j, excl, t_non, t_exc);
    for (int j = sub; j < tb.n[FAM_SQUARE]; j += SPLIT)
      fold_occ(t_square(tb.fam[FAM_SQUARE] + 4 * j, r), (FAM_SQUARE << SLOT_BITS) | j, excl, t_non, t_exc);
  }
  // every thread of the ray sees the cheap families' verdict
  group_min(t_non);
  group_min(t_exc);

  if (active && tb.n[FAM_TORUS] > 0) {
    // Rays already proven occluded skip the tori, unless the light is
    // itself a torus (its t_exc is still unknown).  A torus whose box
    // entry is at or beyond the light cannot change the verdict: its
    // hit would be >= dist.
    const bool excl_is_torus = (excl >> SLOT_BITS) == FAM_TORUS;
    bool occ = t_non < dist && t_non < t_exc;
    for (int j = sub; j < tb.n[FAM_TORUS] && (excl_is_torus || !occ); j += SPLIT) {
      const Torus s = torus_setup(tb.fam[FAM_TORUS] + 5 * j, r);
      if (!s.hit_box || s.t_lo() >= dist) continue;
      fold_occ(torus_march(s), (FAM_TORUS << SLOT_BITS) | j, excl, t_non, t_exc);
      occ = t_non < dist && t_non < t_exc;
    }
  }
  group_min(t_non);
  group_min(t_exc);
  if (active && sub == 0) occ_out[ray] = t_non < dist && t_non < t_exc;
}

int table_floats(const Counts& c) {
  int total = 0;
  for (int f = 0; f < N_FAMS; ++f) total += c.n[f] * fam_width(f);
  return total;
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

// t_out (R,) f32, fam_out (R,) i32 (-1 on miss), slot_out (R,) i32.
int wpt_fused_nearest(const float* tables, int n_plane, int n_sphere, int n_tri,
                      int n_torus, int n_aarect, int n_square, const float* o,
                      const float* d, int n_rays, float* t_out, int* fam_out,
                      int* slot_out, void* stream) {
  using namespace wpt;
  cudaGetLastError();   // clear a stale error so the return value is ours
  if (n_rays <= 0) return 0;
  const Counts c = {{n_plane, n_sphere, n_tri, n_torus, n_aarect, n_square}};
  const size_t smem = sizeof(float) * table_floats(c);
  cudaError_t err = prepare_launch(fused_nearest_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_rays + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  fused_nearest_kernel<<<blocks, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      tables, c, o, d, n_rays, t_out, fam_out, slot_out);
  return static_cast<int>(cudaGetLastError());
}

// occ_out (R,) bool.  excl (R,) i32 is the sampled light's
// fam << 20 | slot code, -1 for none.
int wpt_fused_occluded(const float* tables, int n_plane, int n_sphere, int n_tri,
                       int n_torus, int n_aarect, int n_square, const float* o,
                       const float* d, const float* dist, const int* excl,
                       int n_rays, bool* occ_out, void* stream) {
  using namespace wpt;
  cudaGetLastError();
  if (n_rays <= 0) return 0;
  const Counts c = {{n_plane, n_sphere, n_tri, n_torus, n_aarect, n_square}};
  const size_t smem = sizeof(float) * table_floats(c);
  cudaError_t err = prepare_launch(fused_occluded_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_rays + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  fused_occluded_kernel<<<blocks, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      tables, c, o, d, dist, excl, n_rays, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
