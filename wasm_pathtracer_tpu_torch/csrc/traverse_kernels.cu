// Dense ray x triangle nearest-hit sweep (K8) for Hopper.
//
// Replaces the Pallas TPU kernel of wasm_pathtracer_tpu/ops/traverse_pallas.py:
//   wpt_dense_tri_nearest <- dense_tri_nearest (kernel _kernel)
//
// Every ray is tested against every triangle, and the lexicographic
// minimum of (t, slot) is kept: the TPU kernel's argmin within a chunk
// (lowest slot) and strict < across chunks.
//
// What bounds it on the card: float32 instruction throughput, not memory.  The
// function as the TPU kernel writes it is 78 operations per (ray,
// triangle) pair against 36 bytes per triangle and 24 per ray that every
// pair shares: at 70k triangles x 16k rays, 90 GFLOP over 3 MB, 1.34 ms at
// the card's 67 TFLOP/s.  That rate counts a fused multiply-add as two
// operations; what the card executes is 132 SMs x 128 lanes x ~1.98 GHz =
// ~33.5 T float32 instructions/s, so the floor of a kernel is its
// instructions per pair over that rate, and the gain is in needing fewer
// of them per pair.
//
// What the design does about it:
//  - everything that does not depend on the ray is computed once per
//    triangle, by the thread that stages it into shared memory: the plane
//    (n, n.v0) and, by the scalar triple product
//    (e x (p - a)) . n = (p - a) . (n x e), one vector m_i = (n x e_i) / |n|
//    and one offset k_i = slack - a_i . m_i per edge.  The staged triangle
//    is four float4 (n | n.v0, m_i | k_i), each the operands of one chain
//    of fused multiply-adds, and a half-space test is
//    fma(pz, m.z, fma(py, m.y, fma(px, m.x, k))) >= 0: three instructions
//    where the TPU kernel's cross and dot product take seventeen.  The
//    pair loop comes to ~30 instructions;
//  - SWEEP_RAYS (4) rays per thread, in registers: one broadcast 16-byte
//    shared load feeds that many pairs, and their dependent chains
//    (reciprocal -> hit point -> three tests) interleave;
//  - t = (n.v0 - n.o) * rcp(n.d) with the approximate reciprocal
//    (rcp.approx.ftz: one MUFU.RCP, at most 1 ulp off; |n.d| >= 1e-30, so
//    ftz flushes nothing) and a multiply, in place of the IEEE division's
//    ~9 instructions.  t moves by at most 2 ulp: max |dt| against the
//    plain version on the card stayed at 4.3e-6 on mesh70k's and
//    cloud300k's camera rays, as with the IEEE division (chip_smoke.py,
//    phase k8, prints it).  __fdividef is the same reciprocal behind a
//    range check and two conditional rescalings that this denominator
//    never needs (three instructions a pair), and __frcp_rn is the
//    correctly rounded one, as long as the division;
//  - the ray axis alone has too few blocks to fill 132 SMs (16k rays are
//    32 blocks of 128 threads x 4 rays), so the triangle range is split
//    over blockIdx.y into many more slices than there are SMs: blocks are
//    short, and the card's block scheduler evens out the tail.  The slices
//    merge with a 64-bit atomicMin on (float bits of t) << 32 | slot: t > 0,
//    so the bits order as the floats do and the minimum key is the
//    lexicographic (t, slot) minimum whatever order the blocks finish in.
//    Within a thread slots ascend with a strict < per ray.  The scratch is
//    initialised to all ones (one cudaMemsetAsync), which no hit's key
//    reaches, and a last pass unpacks it.
//
// What differs from the TPU kernel's arithmetic: n.d is still clamped to
// 1e-30 where it vanishes, the normal stays unnormalised in the plane test,
// rsqrt(max(n.n, 1e-30)) still scales only the edge terms, and a hit still
// needs inside && t > 0; but the inside test is evaluated in the staged
// form above, so a hit point within rounding of an edge may fall on the
// other side than in the plain version (on a mesh the neighbour across the
// edge then takes the hit at the same t).
//
// Not used, and why: tensor cores (wgmma) - the products are of depth 3,
// and TF32's 10-bit mantissa would move hits; TMA or cp.async double
// buffering - 36 bytes per triangle against ~30 instructions x B rays is
// far from the memory limit, and staging is < 1% of the instructions.
// Skipping the half-space tests where t cannot win is left out: a warp
// skips only when all its rays do, and the work would depend on the data.
// Tried and dropped: one ray per thread (every shared load feeds a single
// pair and the dependent chain has nothing to interleave with) and two;
// the IEEE division, __frcp_rn and __fdividef; the half-space test as
// (p - a_i) . m_i + slack, with the subtraction left in the pair loop (six
// instructions more a pair and a fifth float4 per triangle; it has no
// cancellation in k_i for triangles far from the origin, which the
// tolerances of phase k8 and the tests on translated triangles did not
// need); blocks of 64 and 256 threads, tiles of 128 and 512, shorter
// unrolls and fewer slices.
// Eight rays per thread are 6% faster still, at 127 registers a thread;
// not taken here.  The measurements of each step are in PERF.md.
// As compiled for sm_90a by nvcc 12.8 at -O3 (cuobjdump -sass of the built
// library; the count holds for that compiler and this source) the pair
// loop has 971 instructions for 8 triangles x 4 rays, 30.3 a pair: a
// floor of 1.04 ms at 16,384 x 70,314 and the boost clock, below the
// 1.34 ms that the 78 operations of the TPU kernel's form take at the
// card's peak.
//
// No padding of rays or triangles: ragged ends are masked here.
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "scene_families.cuh"

namespace wpt {

constexpr int SWEEP_RAYS = 4;              // rays per thread
constexpr int SWEEP_BLOCK = 128;           // threads per block
constexpr int SWEEP_TILE = 256;            // triangles per shared-memory tile
constexpr int SWEEP_PAIR_UNROLL = 8;       // triangles per trip of the pair loop
constexpr int SWEEP_SMS = 132;
constexpr int SWEEP_BLOCKS_PER_SM = 48;    // blocks the grid aims at, per SM
constexpr int SWEEP_BLOCK_RAYS = SWEEP_BLOCK * SWEEP_RAYS;
constexpr unsigned long long SWEEP_EMPTY = ~0ull;   // above every hit's key

// One staged triangle, read as broadcast float4.
struct TriStage {
  float4 n;    // n.xyz, n.v0
  float4 m0;   // m_0.xyz, k_0
  float4 m1;   // m_1.xyz, k_1
  float4 m2;   // m_2.xyz, k_2
};

// m = (n x e) * inv_len, and k = slack - a . m in m.w
__device__ __forceinline__ float4 stage_edge(float nx, float ny, float nzz,
                                             float inv_len, float ex, float ey,
                                             float ez, float ax, float ay,
                                             float az) {
  const float mx = (ny * ez - nzz * ey) * inv_len;
  const float my = (nzz * ex - nx * ez) * inv_len;
  const float mz = (nx * ey - ny * ex) * inv_len;
  return make_float4(mx, my, mz, EPS_SLACK - (ax * mx + ay * my + az * mz));
}

__device__ __forceinline__ TriStage stage_triangle(const float* __restrict__ p) {
  const float v0x = p[0], v0y = p[1], v0z = p[2];
  const float v1x = p[3], v1y = p[4], v1z = p[5];
  const float v2x = p[6], v2y = p[7], v2z = p[8];
  const float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
  const float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
  const float nx = e1y * e2z - e1z * e2y;
  const float ny = e1z * e2x - e1x * e2z;
  const float nzz = e1x * e2y - e1y * e2x;
  const float inv_len = rsqrtf(fmaxf(nx * nx + ny * ny + nzz * nzz, 1e-30f));
  TriStage s;
  s.n = make_float4(nx, ny, nzz, nx * v0x + ny * v0y + nzz * v0z);
  s.m0 = stage_edge(nx, ny, nzz, inv_len, e1x, e1y, e1z, v0x, v0y, v0z);
  s.m1 = stage_edge(nx, ny, nzz, inv_len, v2x - v1x, v2y - v1y, v2z - v1z,
                    v1x, v1y, v1z);
  s.m2 = stage_edge(nx, ny, nzz, inv_len, v0x - v2x, v0y - v2y, v0z - v2z,
                    v2x, v2y, v2z);
  return s;
}

// a / b by the approximate reciprocal; |b| >= 1e-30, so ftz flushes nothing
__device__ __forceinline__ float sweep_div(float a, float b) {
  float inv;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(b));
  return a * inv;
}

__global__ void __launch_bounds__(SWEEP_BLOCK)
dense_tri_kernel(const float* __restrict__ tris, int n_tris, int tiles_per_slice,
                 const float* __restrict__ o, const float* __restrict__ d,
                 int n_rays, unsigned long long* __restrict__ packed) {
  __shared__ TriStage tile[SWEEP_TILE];

  // a thread's rays lie SWEEP_BLOCK apart; one past the end never hits
  // (no t is below -inf)
  const int ray0 = blockIdx.x * SWEEP_BLOCK_RAYS + threadIdx.x;
  Ray r[SWEEP_RAYS];
  float bt[SWEEP_RAYS];
  int bs[SWEEP_RAYS];
#pragma unroll
  for (int q = 0; q < SWEEP_RAYS; ++q) {
    const int ray = ray0 + q * SWEEP_BLOCK;
    const bool active = ray < n_rays;
    r[q] = load_ray(o, d, active ? ray : 0);
    bt[q] = active ? INFINITY : -INFINITY;
    bs[q] = -1;
  }

  const int first = blockIdx.y * tiles_per_slice * SWEEP_TILE;
  const int last = min(n_tris, first + tiles_per_slice * SWEEP_TILE);
  for (int base = first; base < last; base += SWEEP_TILE) {
    const int n = min(SWEEP_TILE, last - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += SWEEP_BLOCK)
      tile[k] = stage_triangle(tris + 9 * static_cast<size_t>(base + k));
    __syncthreads();
#pragma unroll SWEEP_PAIR_UNROLL
    for (int j = 0; j < n; ++j) {
      const float4 N = tile[j].n, M0 = tile[j].m0, M1 = tile[j].m1, M2 = tile[j].m2;
      const int slot = base + j;
#pragma unroll
      for (int q = 0; q < SWEEP_RAYS; ++q) {
        const Ray& a = r[q];
        const float ndd = nz(fmaf(a.dz, N.z, fmaf(a.dy, N.y, a.dx * N.x)));
        const float num = fmaf(-a.oz, N.z, fmaf(-a.oy, N.y, fmaf(-a.ox, N.x, N.w)));
        const float t = sweep_div(num, ndd);
        const float px = fmaf(a.dx, t, a.ox), py = fmaf(a.dy, t, a.oy),
                    pz = fmaf(a.dz, t, a.oz);
        const float s0 = fmaf(pz, M0.z, fmaf(py, M0.y, fmaf(px, M0.x, M0.w)));
        const float s1 = fmaf(pz, M1.z, fmaf(py, M1.y, fmaf(px, M1.x, M1.w)));
        const float s2 = fmaf(pz, M2.z, fmaf(py, M2.y, fmaf(px, M2.x, M2.w)));
        // ascending slots and a strict <: the first minimum
        if (s0 >= 0.f && s1 >= 0.f && s2 >= 0.f && t > 0.f && t < bt[q]) {
          bt[q] = t;
          bs[q] = slot;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < SWEEP_RAYS; ++q) {
    if (bs[q] < 0) continue;
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(bt[q])) << 32) |
        static_cast<unsigned int>(bs[q]);
    atomicMin(packed + ray0 + q * SWEEP_BLOCK, key);
  }
}

__global__ void sweep_finish_kernel(const unsigned long long* __restrict__ packed,
                                    int n, float* __restrict__ t_out,
                                    int* __restrict__ slot_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = packed[i];
  const bool hit = key != SWEEP_EMPTY;
  t_out[i] = hit ? __uint_as_float(static_cast<unsigned int>(key >> 32)) : INFINITY;
  slot_out[i] = hit ? static_cast<int>(key & 0xffffffffull) : -1;
}

// grid of the sweep: x over blocks of rays, y over slices of whole tiles
static dim3 sweep_grid(int n_tris, int n_rays, int* tiles_per_slice) {
  const int ray_blocks = (n_rays + SWEEP_BLOCK_RAYS - 1) / SWEEP_BLOCK_RAYS;
  const int n_tiles = (n_tris + SWEEP_TILE - 1) / SWEEP_TILE;
  int slices = (SWEEP_SMS * SWEEP_BLOCKS_PER_SM + ray_blocks - 1) / ray_blocks;
  slices = slices < 1 ? 1 : (slices > n_tiles ? n_tiles : slices);
  *tiles_per_slice = (n_tiles + slices - 1) / slices;
  slices = (n_tiles + *tiles_per_slice - 1) / *tiles_per_slice;
  return dim3(ray_blocks, slices);
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
  cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * n_rays, s);
  if (n_tris > 0) {
    int tiles_per_slice;
    const dim3 grid = sweep_grid(n_tris, n_rays, &tiles_per_slice);
    dense_tri_kernel<<<grid, SWEEP_BLOCK, 0, s>>>(tris, n_tris, tiles_per_slice, o,
                                                  d, n_rays, keys);
  }
  const int flat_blocks = (n_rays + 255) / 256;
  sweep_finish_kernel<<<flat_blocks, 256, 0, s>>>(keys, n_rays, t_out, slot_out);
  return static_cast<int>(cudaGetLastError());
}

// The sweep's launch shape for (T, R) and what the compiler gave its kernel:
// out[0..7] = grid x, grid y, threads per block, rays per thread, triangles
// per tile, registers per thread, static shared bytes, local (spill) bytes.
int wpt_dense_tri_launch_shape(int n_tris, int n_rays, int* out) {
  using namespace wpt;
  cudaGetLastError();
  int tiles_per_slice = 0;
  const dim3 grid = n_tris > 0 && n_rays > 0
                        ? sweep_grid(n_tris, n_rays, &tiles_per_slice)
                        : dim3(0, 0);
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, dense_tri_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = grid.x; out[1] = grid.y; out[2] = SWEEP_BLOCK; out[3] = SWEEP_RAYS;
  out[4] = SWEEP_TILE; out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.sharedSizeBytes);
  out[7] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
