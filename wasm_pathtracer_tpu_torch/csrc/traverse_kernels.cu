// Dense ray x triangle nearest-hit sweep (K8) for Hopper.
//
// Replaces the Pallas TPU kernel of wasm_pathtracer_tpu/ops/traverse_pallas.py:
//   wpt_dense_tri_nearest <- dense_tri_nearest (kernel _kernel)
//
// Every ray is tested against every triangle, and the lexicographic
// minimum of (t, slot) is kept: the TPU kernel's argmin within a chunk
// (lowest slot) and strict < across chunks.
//
// What bounds it on the card: float32 instruction throughput, not memory.
// The function needs 42 operations per (ray, triangle) pair and 88 per
// triangle to set it up (chip_smoke.py's FLOPS, the same for every kernel
// that tests triangles), against 36 bytes per triangle and 24 per ray that
// every pair shares: at 70k triangles x 16k rays, 48 GFLOP over 3 MB, 0.72
// ms at the card's 67 TFLOP/s.  That rate counts a fused multiply-add as
// two operations; what the card executes is 132 SMs x 128 lanes x ~1.98 GHz
// = ~33.5 T float32 instructions/s, so the floor of a kernel is its
// instructions per pair over that rate, and the gain is in needing fewer
// of them per pair.
//
// What the design does about it:
//  - the triangle test of triangle_stage.cuh: everything that does not
//    depend on the ray is staged once per triangle into shared memory, and
//    the pair loop comes to ~30 instructions;
//  - SWEEP_RAYS (4) rays per thread, in registers: one broadcast 16-byte
//    shared load feeds that many pairs, and their dependent chains
//    (reciprocal -> hit point -> three tests) interleave;
//  - the approximate reciprocal for t (triangle_stage.cuh): max |dt|
//    against the plain version on the card stayed at 4.3e-6 on mesh70k's
//    and cloud300k's camera rays, as with the IEEE division (chip_smoke.py,
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
// What differs from the TPU kernel's arithmetic: the staged inside test
// (triangle_stage.cuh); on a mesh, where it moves a hit point across an
// edge, the neighbour across the edge takes the hit at the same t.
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
// floor of 1.04 ms at 16,384 x 70,314 and the boost clock.
//
// No padding of rays or triangles: ragged ends are masked here.
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "triangle_stage.cuh"

namespace wpt {

constexpr int SWEEP_RAYS = 4;              // rays per thread
constexpr int SWEEP_BLOCK = 128;           // threads per block
constexpr int SWEEP_TILE = 256;            // triangles per shared-memory tile
constexpr int SWEEP_PAIR_UNROLL = 8;       // triangles per trip of the pair loop
constexpr int SWEEP_SMS = 132;
constexpr int SWEEP_BLOCKS_PER_SM = 48;    // blocks the grid aims at, per SM
constexpr int SWEEP_BLOCK_RAYS = SWEEP_BLOCK * SWEEP_RAYS;
constexpr unsigned long long SWEEP_EMPTY = ~0ull;   // above every hit's key

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
        bool inside;
        const float t = staged_hit(N, M0, M1, M2, r[q], inside);
        // ascending slots and a strict <: the first minimum
        if (inside && t > 0.f && t < bt[q]) {
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
