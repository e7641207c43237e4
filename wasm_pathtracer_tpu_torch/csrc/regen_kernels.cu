// A queue iteration's regeneration in one kernel: wpt_regen_kernel.
//
// Replaces no TPU kernel.  The JAX package's loop body is one jitted
// program, so XLA fuses regeneration into the iteration; the port's eager
// ops/regen.py::regen launched ~110 small kernels an iteration for it, and
// the queue loops waited on the host to launch them.  This kernel does all
// of regen's work for one lane per thread: it decides which paths end
// (render_queue's route: died this bounce or at the cap; the flat route:
// the bounce's FINALIZE), adds their radiance and count to the frame with
// atomics (a lane that ends nothing adds nothing), counts the lane's
// finished paths, ranks the lanes that may claim in lane order, moves the
// claim cursor, draws each claimed path's jitter (pcg3d.cuh) and builds its
// primary ray, and writes every adopted register in place.
//
// What bounds it on the card: a lane reads and writes ~200 bytes, so
// 16,384 lanes move ~3 MB, ~1 us at 3.35 TB/s; the lane's work is a short
// chain (a hash, a square root, three divisions).  What costs is the one
// thing that crosses lanes: each lane's rank among the claiming lanes
// before it.  One block takes a tile of lanes: it scans its tile with warp
// ballots, publishes its count, and takes the counts before it by
// decoupled look-back (a warp reads 32 predecessors' status words at once
// and stops at the nearest one that holds its inclusive prefix).  Tiles
// are handed out by a ticket in launch order, so a tile waits only on
// tiles that already run, whatever the number of lanes.  A status word
// holds its count, a flag and the launch's epoch (the ticket over the
// number of tiles), so the scratch is never cleared between launches.  One
// block walking every tile in order, with no scratch and no waiting, took
// 4-13x as long at 8,192-16,384 lanes on the H100: one SM did all the
// lanes' work.  The template parameter is the route: render_queue's
// (FLAT = false) or the flat wavefront's, which also sets the next traced
// ray.
//
// Rounding follows the eager PyTorch chain op by op, as in
// shade_kernels.cu: primary_rays (models/camera.py) divides by a host
// scalar as ATen does, a multiply by the scalar's float reciprocal; every
// other add, multiply, divide and square root is one IEEE rounding
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn), never contracted; the
// norm sums its squares in ATen's order on the card, (x0 + x2) + x1.  The
// camera's cosines and sines come in from the wrapper, computed by the same
// torch ops as the eager rotation's.  Claims, ray ids and the jitter's
// pcg3d bits are exact integer work.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "pcg3d.cuh"

namespace wpt {

constexpr uint32_t SLOT_JITTER = 0x7FFF0000u;   // regen.SLOT_JITTER
constexpr unsigned FULL_MASK = 0xffffffffu;

// What the wrapper (ops/regen_kernels.py::fused_regen) hands the kernel;
// the ctypes Structure there mirrors this layout field for field.
struct RegenArgs {
  // the queue, the frame and the camera
  const long long* pixq;      // (S + B,) pixel ids
  float* acc;                 // (HW + 1, 3) colour sums
  int* cnt;                   // (HW + 1,) sample counts
  const float* cam;           // location xyz, cos rx, sin rx, cos ry, sin ry
  // render_queue's route: the lanes alive before the bounce
  const bool* was;
  // the flat route's FINALIZE inputs
  const bool* resolve;
  const bool* shade;
  const bool* pend;
  const bool* cont_prev;
  const bool* cont_shade;
  const float* o_sh;
  const float* d_sh;
  // registers, read and written in place
  float* o;
  float* d;
  float* tp;
  float* col;
  float* absorb;
  bool* alive;
  bool* hdb;
  long long* bounce;
  long long* pid;
  long long* rid;
  long long* k_lane;
  long long* issued;          // the claim cursor, one value
  float* tr_o;                // the flat route's trace registers
  float* tr_d;
  bool* shadow;
  bool* need_scan;
  // look-back scratch: a status word a tile, and the ticket counter
  unsigned long long* tiles;
  unsigned long long* ticket;
  long long S, K, HW, rid_base;
  int n;                      // lanes
  int width;
  int max_bounces;
  int flat;                   // 1: the flat route
  int tile;                   // lanes a tile (threads a block)
  uint32_t seed;
  float inv_w, inv_h;         // the float32 reciprocals of width, height
  float aspect;               // float32(width) / float32(height)
  float screen_z;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.sum(x, dim=-1) of an (R, 3) tensor on the card (shade_kernels.cu)
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return add(add(add(0.0f, x0), add(0.0f, x2)), add(0.0f, x1));
}

__device__ __forceinline__ void store3(float* p, int i, float x, float y, float z) {
  p[3 * i] = x;
  p[3 * i + 1] = y;
  p[3 * i + 2] = z;
}

// primary_rays' direction for pixel pid with the jitter of ray id rid
__device__ void primary_dir(const RegenArgs& a, long long pid, uint32_t rid, float out[3]) {
  const Uniform3 u = uniform3(a.seed, rid, SLOT_JITTER);
  const float px = static_cast<float>(pid % a.width);
  const float py = static_cast<float>(pid / a.width);
  const float fx = mul(sub(mul(add(px, u.a), a.inv_w), 0.5f), a.aspect);
  const float fy = sub(0.5f, mul(add(py, u.b), a.inv_h));
  const float fz = a.screen_z;
  const float len = __fsqrt_rn(sum3(mul(fx, fx), mul(fy, fy), mul(fz, fz)));
  const float x = dvd(fx, len), y = dvd(fy, len), z = dvd(fz, len);
  // vecmath.rot_x, then vecmath.rot_y ((-s) * x is -(s * x))
  const float cx = a.cam[3], sx = a.cam[4], cy = a.cam[5], sy = a.cam[6];
  const float y1 = sub(mul(cx, y), mul(sx, z));
  const float z1 = add(mul(sx, y), mul(cx, z));
  out[0] = add(mul(cy, x), mul(sy, z1));
  out[1] = y1;
  out[2] = add(mul(-sy, x), mul(cy, z1));
}

// What a lane decided before the claim ranks are known.
struct Decided {
  bool end;         // the path ended: it was added to the frame
  bool cont;        // flat route: the path goes on to its next bounce
  bool claimable;   // ended with capacity left
};

// Decide whether lane i's path ends; add an ended path to the frame and
// count it on the lane.
template <bool FLAT>
__device__ Decided decide(const RegenArgs& a, int i) {
  Decided s = {false, false, false};
  if (i >= a.n) return s;
  if (FLAT) {
    const bool done = a.resolve[i] || (a.shade[i] && !a.pend[i]);
    s.cont = done && (a.shadow[i] ? a.cont_prev[i] : a.cont_shade[i]);
    s.end = done && !s.cont;
  } else {
    s.end = a.was[i] && (!a.alive[i] || a.bounce[i] >= a.max_bounces);
  }
  if (s.end) {
    const long long p = a.pid[i];
    if (p >= 0 && p <= a.HW) {
      atomicAdd(a.acc + 3 * p, a.col[3 * i]);
      atomicAdd(a.acc + 3 * p + 1, a.col[3 * i + 1]);
      atomicAdd(a.acc + 3 * p + 2, a.col[3 * i + 2]);
      atomicAdd(a.cnt + p, 1);
    }
    const long long k = a.k_lane[i] + 1;
    a.k_lane[i] = k;
    s.claimable = k < a.K;
  }
  return s;
}

// Lane i, ranked `rank` among the claiming lanes, claims queue entry
// issued0 + rank if it exists, and writes its registers.
template <bool FLAT>
__device__ void adopt(const RegenArgs& a, int i, Decided s, long long issued0, long long rank) {
  if (i >= a.n) return;
  const long long sidx = issued0 + rank;
  const bool can = s.claimable && sidx < a.S;
  float dn[3];
  if (can) {
    const long long pq = a.pixq[sidx];
    const long long pid = pq < a.HW ? pq : a.HW;
    const uint32_t rid = static_cast<uint32_t>(static_cast<unsigned long long>(a.rid_base + sidx));
    primary_dir(a, pid, rid, dn);
    if (FLAT && !a.pend[i]) {
      store3(a.tr_o, i, a.cam[0], a.cam[1], a.cam[2]);
      store3(a.tr_d, i, dn[0], dn[1], dn[2]);
    }
    store3(a.o, i, a.cam[0], a.cam[1], a.cam[2]);
    store3(a.d, i, dn[0], dn[1], dn[2]);
    store3(a.tp, i, 1.0f, 1.0f, 1.0f);
    store3(a.col, i, 0.0f, 0.0f, 0.0f);
    store3(a.absorb, i, 0.0f, 0.0f, 0.0f);
    a.hdb[i] = false;
    a.bounce[i] = 0;
    a.pid[i] = pid;
    a.rid[i] = rid;
  }
  if (FLAT) {
    const bool pend = a.pend[i];
    if (pend) {
      store3(a.tr_o, i, a.o_sh[3 * i], a.o_sh[3 * i + 1], a.o_sh[3 * i + 2]);
      store3(a.tr_d, i, a.d_sh[3 * i], a.d_sh[3 * i + 1], a.d_sh[3 * i + 2]);
    } else if (!can && s.cont) {
      store3(a.tr_o, i, a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2]);
      store3(a.tr_d, i, a.d[3 * i], a.d[3 * i + 1], a.d[3 * i + 2]);
    }
    const bool start = pend || can || s.cont;
    if (start) a.shadow[i] = pend;
    a.need_scan[i] = start;
  }
  a.alive[i] = (a.alive[i] && !s.end) || can;
}

// Exclusive rank of `flag` among the block's threads, and the block's
// count in `total`.  Every thread of the block calls it.
__device__ int block_rank(bool flag, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned m = __ballot_sync(FULL_MASK, flag);
  const int excl = __popc(m & ((1u << lane) - 1u));
  if (lane == 0) warp_sums[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL_MASK, v, off);
      if (lane >= off) v += t;
    }
    if (lane < nw) warp_sums[lane] = v;   // inclusive
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  total = warp_sums[nw - 1];
  __syncthreads();   // warp_sums may be written again
  return before + excl;
}

// A tile's status word: epoch tag (bits 34-63), flag (32-33), count (0-31).
constexpr unsigned long long FLAG_AGG = 1ull, FLAG_PRE = 2ull;
__device__ __forceinline__ unsigned long long epoch_tag(unsigned long long epoch) {
  return (epoch & 0x1FFFFFFFull) + 1ull;   // consecutive launches differ; 0 never
}
__device__ __forceinline__ unsigned long long status(unsigned long long tag,
                                                     unsigned long long flag, unsigned v) {
  return (tag << 34) | (flag << 32) | v;
}

// Exclusive prefix of tile `t`: the counts of the tiles before it, read by
// warp 0 (every lane of it calls this).
__device__ long long look_back(const RegenArgs& a, int t, unsigned long long tag) {
  const int lane = threadIdx.x & 31;
  long long prefix = 0;
  for (int j = t - 1;; j -= 32) {
    const int k = j - lane;
    unsigned long long flag = FLAG_PRE;
    unsigned v = 0;
    if (k >= 0) {
      unsigned long long w;
      do {
        w = *reinterpret_cast<volatile unsigned long long*>(a.tiles + k);
      } while ((w >> 34) != tag);
      flag = (w >> 32) & 3ull;
      v = static_cast<unsigned>(w);
    }
    const unsigned pre = __ballot_sync(FULL_MASK, flag == FLAG_PRE);
    const int stop = pre ? __ffs(pre) - 1 : 31;   // the nearest inclusive prefix
    unsigned sum = lane <= stop ? v : 0u;
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(FULL_MASK, sum, off);
    prefix += __shfl_sync(FULL_MASK, sum, 0);
    if (pre) return prefix;
  }
}

template <bool FLAT>
__global__ void wpt_regen_kernel(RegenArgs a) {
  __shared__ int warp_sums[32];
  __shared__ long long s_issued, s_prefix;
  __shared__ unsigned long long s_ticket;
  if (threadIdx.x == 0) {
    s_issued = *a.issued;
    // every block reads the cursor before it takes a ticket, so the last
    // tile's write of it comes after all the reads
    __threadfence();
    s_ticket = atomicAdd(a.ticket, 1ull);
  }
  __syncthreads();
  const long long issued0 = s_issued;
  const unsigned long long n_tiles = gridDim.x;
  const int t = static_cast<int>(s_ticket % n_tiles);
  const unsigned long long tag = epoch_tag(s_ticket / n_tiles);
  const int i = t * blockDim.x + threadIdx.x;
  const Decided s = decide<FLAT>(a, i);
  int total;
  const int r = block_rank(s.claimable, warp_sums, total);
  if (threadIdx.x < 32) {
    long long prefix = 0;
    if (t == 0) {
      if (threadIdx.x == 0)
        atomicExch(a.tiles, status(tag, FLAG_PRE, static_cast<unsigned>(total)));
    } else {
      if (threadIdx.x == 0)
        atomicExch(a.tiles + t, status(tag, FLAG_AGG, static_cast<unsigned>(total)));
      prefix = look_back(a, t, tag);
      if (threadIdx.x == 0)
        atomicExch(a.tiles + t, status(tag, FLAG_PRE, static_cast<unsigned>(prefix + total)));
    }
    if (threadIdx.x == 0) {
      s_prefix = prefix;
      if (t == static_cast<int>(n_tiles) - 1) *a.issued = min(issued0 + prefix + total, a.S);
    }
  }
  __syncthreads();
  adopt<FLAT>(a, i, s, issued0, s_prefix + r);
}

}  // namespace wpt

extern "C" {

// One launch over args->n lanes on the given stream.
int wpt_regen(const wpt::RegenArgs* args, void* stream) {
  using namespace wpt;
  cudaGetLastError();   // clear a stale error so the return value is ours
  if (args->n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (args->n + args->tile - 1) / args->tile;
  if (args->flat)
    wpt_regen_kernel<true><<<blocks, args->tile, 0, s>>>(*args);
  else
    wpt_regen_kernel<false><<<blocks, args->tile, 0, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
