// Dense ray x triangle nearest-hit sweep (K8) for Hopper.
//
// Replaces the Pallas TPU kernel of wasm_pathtracer_tpu/ops/traverse_pallas.py:
//   wpt_dense_tri_nearest <- dense_tri_nearest (kernel _kernel)
//
// Every ray is tested against every triangle, and the lexicographic
// minimum of (t, slot) is kept: the TPU kernel's argmin within a chunk
// (lowest slot) and strict < across chunks.
//
// What bounds it on the card: FP32 ALU work, not memory.  Per (ray,
// triangle) pair the test is ~75 operations (a plane intersection with
// one division, three half-space tests of a cross and a dot product
// each), against 36 bytes per triangle and 24 per ray that every pair
// shares: at 70k triangles x 16k rays, ~87 GFLOP over ~3 MB.
//
// What the design does about it:
//  - triangles stream through shared memory in tiles.  While staging a
//    tile each thread computes one triangle's plane once (normal,
//    inverse length, plane offset: the TPU kernel's per-chunk rows), so
//    the pair loop reads them as broadcast 16-byte shared loads and
//    spends its instructions on the per-pair arithmetic only;
//  - one thread per ray, slots visited in ascending order, so a strict <
//    keeps the first minimum within a thread;
//  - 16k rays are only 128 blocks of 128 threads, too few warps to hide
//    the division's latency on 132 SMs, so the triangle range is also
//    split over blockIdx.y.  The slices merge with a 64-bit atomicMin on
//    (float bits of t) << 32 | slot: t > 0, so the bits order as the
//    floats do and the minimum key is the lexicographic (t, slot)
//    minimum whatever order the blocks finish in.
//
// The arithmetic is the TPU kernel's, line for line: the normal stays
// unnormalised in the plane test, n.d is clamped to 1e-30 where it
// vanishes instead of rejecting the ray, rsqrt(max(n.n, 1e-30)) scales
// only the edge slack, and a hit needs inside && t > 0.  No padding of
// rays or triangles: ragged ends are masked here.
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "scene_families.cuh"

namespace wpt {

constexpr int SWEEP_BLOCK = 128;     // rays (threads) per block
constexpr int SWEEP_TILE = 256;      // triangles per shared-memory tile
constexpr int SWEEP_TARGET_BLOCKS = 132 * 8;
constexpr unsigned long long SWEEP_MISS = 0x7f800000ffffffffull;  // (+inf, -1)

// One staged triangle: 16 floats, read as four float4.
struct TriPlane {
  float4 a;   // v0.xyz, v1.x
  float4 b;   // v1.yz, v2.xy
  float4 c;   // v2.z, n.xyz
  float4 e;   // inv_len, orig, unused, unused
};

__global__ void sweep_init_kernel(unsigned long long* __restrict__ packed, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) packed[i] = SWEEP_MISS;
}

__global__ void __launch_bounds__(SWEEP_BLOCK)
dense_tri_kernel(const float* __restrict__ tris, int n_tris, int tiles_per_slice,
                 const float* __restrict__ o, const float* __restrict__ d,
                 int n_rays, unsigned long long* __restrict__ packed) {
  __shared__ TriPlane tile[SWEEP_TILE];

  const int ray = blockIdx.x * SWEEP_BLOCK + threadIdx.x;
  const bool active = ray < n_rays;
  Ray r = {0.f, 0.f, 0.f, 1.f, 1.f, 1.f};
  if (active) r = load_ray(o, d, ray);

  const int first = blockIdx.y * tiles_per_slice * SWEEP_TILE;
  const int last = min(n_tris, first + tiles_per_slice * SWEEP_TILE);
  float bt = INFINITY;
  int bs = -1;
  for (int base = first; base < last; base += SWEEP_TILE) {
    const int n = min(SWEEP_TILE, last - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += SWEEP_BLOCK) {
      const float* p = tris + 9 * static_cast<size_t>(base + k);
      const float v0x = p[0], v0y = p[1], v0z = p[2];
      const float v1x = p[3], v1y = p[4], v1z = p[5];
      const float v2x = p[6], v2y = p[7], v2z = p[8];
      const float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
      const float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
      const float nx = e1y * e2z - e1z * e2y;
      const float ny = e1z * e2x - e1x * e2z;
      const float nzz = e1x * e2y - e1y * e2x;
      const float inv_len = rsqrtf(fmaxf(nx * nx + ny * ny + nzz * nzz, 1e-30f));
      const float orig = nx * v0x + ny * v0y + nzz * v0z;
      tile[k].a = make_float4(v0x, v0y, v0z, v1x);
      tile[k].b = make_float4(v1y, v1z, v2x, v2y);
      tile[k].c = make_float4(v2z, nx, ny, nzz);
      tile[k].e = make_float4(inv_len, orig, 0.f, 0.f);
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float4 A = tile[j].a, B = tile[j].b, C = tile[j].c, E = tile[j].e;
      const float v0x = A.x, v0y = A.y, v0z = A.z;
      const float v1x = A.w, v1y = B.x, v1z = B.y;
      const float v2x = B.z, v2y = B.w, v2z = C.x;
      const float nx = C.y, ny = C.z, nzz = C.w;
      const float inv_len = E.x, orig = E.y;
      const float ndd = nz(r.dx * nx + r.dy * ny + r.dz * nzz);
      const float ndo = r.ox * nx + r.oy * ny + r.oz * nzz;
      const float t = (orig - ndo) / ndd;
      const float px = r.ox + r.dx * t, py = r.oy + r.dy * t, pz = r.oz + r.dz * t;
      const bool inside =
          left_of(px, py, pz, v0x, v0y, v0z, v1x - v0x, v1y - v0y, v1z - v0z,
                  nx, ny, nzz, inv_len) &&
          left_of(px, py, pz, v1x, v1y, v1z, v2x - v1x, v2y - v1y, v2z - v1z,
                  nx, ny, nzz, inv_len) &&
          left_of(px, py, pz, v2x, v2y, v2z, v0x - v2x, v0y - v2y, v0z - v2z,
                  nx, ny, nzz, inv_len);
      if (inside && t > 0.f && t < bt) {   // ascending slots: first minimum
        bt = t;
        bs = base + j;
      }
    }
  }
  if (active && bs >= 0) {
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(bt)) << 32) |
        static_cast<unsigned int>(bs);
    atomicMin(packed + ray, key);
  }
}

__global__ void sweep_finish_kernel(const unsigned long long* __restrict__ packed,
                                    int n, float* __restrict__ t_out,
                                    int* __restrict__ slot_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = packed[i];
  const float t = __uint_as_float(static_cast<unsigned int>(key >> 32));
  t_out[i] = t;
  slot_out[i] = t < INFINITY ? static_cast<int>(key & 0xffffffffull) : -1;
}

}  // namespace wpt

extern "C" {

// K8.  tris (T, 9) f32 rows v0 v1 v2; o, d (R, 3) f32; packed (R,) 8-byte
// scratch; t_out (R,) f32 (+inf on a miss), slot_out (R,) i32 (-1 on a
// miss).
int wpt_dense_tri_nearest(const float* tris, int n_tris, const float* o,
                          const float* d, int n_rays, void* packed, float* t_out,
                          int* slot_out, void* stream) {
  using namespace wpt;
  cudaGetLastError();   // clear a stale error so the return value is ours
  if (n_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* keys = static_cast<unsigned long long*>(packed);
  const int flat_blocks = (n_rays + 255) / 256;
  sweep_init_kernel<<<flat_blocks, 256, 0, s>>>(keys, n_rays);
  if (n_tris > 0) {
    const int ray_blocks = (n_rays + SWEEP_BLOCK - 1) / SWEEP_BLOCK;
    const int n_tiles = (n_tris + SWEEP_TILE - 1) / SWEEP_TILE;
    int slices = (SWEEP_TARGET_BLOCKS + ray_blocks - 1) / ray_blocks;
    slices = slices < 1 ? 1 : (slices > n_tiles ? n_tiles : slices);
    const int tiles_per_slice = (n_tiles + slices - 1) / slices;
    slices = (n_tiles + tiles_per_slice - 1) / tiles_per_slice;
    dense_tri_kernel<<<dim3(ray_blocks, slices), SWEEP_BLOCK, 0, s>>>(
        tris, n_tris, tiles_per_slice, o, d, n_rays, keys);
  }
  sweep_finish_kernel<<<flat_blocks, 256, 0, s>>>(keys, n_rays, t_out, slot_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
