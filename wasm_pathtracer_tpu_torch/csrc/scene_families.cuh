// Per-family ray-primitive intersection for one (ray, primitive) pair,
// and the whole-table nearest-hit scan built from it.
//
// Scalar transcriptions of the Pallas family helpers in
// wasm_pathtracer_tpu/ops/scene_pallas.py (_t_planes, _t_spheres,
// _t_tris, _torus_setup/_t_tori, _t_aarects, _t_squares), which are in
// turn the componentwise form of ops/intersect.py.  Every test returns
// +inf on a miss.  Constants are written as the float32 values the JAX
// code rounds them to (10 * 1e-4 is 1e-3f, 0.1 * 2e-4 is 2e-5f).
//
// Table rows, one per primitive, float32:
//   plane  (6): location xyz, unit normal xyz
//   sphere (4): centre xyz, radius
//   tri    (9): v0 xyz, v1 xyz, v2 xyz
//   torus  (5): centre xyz, major radius, minor radius
//   aarect (6): min corner xyz, max corner xyz
//   square (4): centre xyz, size
#pragma once

#include <math.h>

namespace wpt {

constexpr int SLOT_BITS = 20;
constexpr int SLOT_MASK = (1 << SLOT_BITS) - 1;

constexpr int FAM_PLANE = 0;
constexpr int FAM_SPHERE = 1;
constexpr int FAM_TRI = 2;
constexpr int FAM_TORUS = 3;
constexpr int FAM_AARECT = 4;
constexpr int FAM_SQUARE = 5;
constexpr int N_FAMS = 6;

// row widths, in family order
__host__ __device__ constexpr int fam_width(int fam) {
  return fam == FAM_PLANE ? 6 : fam == FAM_SPHERE ? 4 : fam == FAM_TRI ? 9
       : fam == FAM_TORUS ? 5 : fam == FAM_AARECT ? 6 : 4;
}

constexpr float EPS_SLACK = 2e-5f;   // 0.1 * EPSILON (triangle.rs:44)
constexpr int TORUS_STEPS = 24;
constexpr int TORUS_NEWTON = 4;
constexpr float TORUS_OMEGA = 1.6f;
constexpr float TORUS_TOL = 1e-4f;
constexpr float TORUS_HIT_TOL = 1e-3f;   // 10 * TORUS_TOL

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// jnp.where(|x| < 1e-30, 1e-30, x)
__device__ __forceinline__ float nz(float x) {
  return fabsf(x) < 1e-30f ? 1e-30f : x;
}

__device__ __forceinline__ float t_plane(const float* p, const Ray& r) {
  const float ndd = p[3] * r.dx + p[4] * r.dy + p[5] * r.dz;
  const float ndo = p[3] * r.ox + p[4] * r.oy + p[5] * r.oz;
  const float odist = p[3] * p[0] + p[4] * p[1] + p[5] * p[2];
  const float t = (odist - ndo) / nz(ndd);
  return (t > 0.f && ndd != 0.f) ? t : INFINITY;
}

__device__ __forceinline__ float t_sphere(const float* p, const Ray& r) {
  const float rad = p[3];
  const float ocx = r.ox - p[0], ocy = r.oy - p[1], ocz = r.oz - p[2];
  const float b = 2.f * (ocx * r.dx + ocy * r.dy + ocz * r.dz);
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = b * b - 4.f * c;
  const float sq = disc > 0.f ? sqrtf(disc) : 0.f;
  const float t0 = (-b + sq) * 0.5f;
  const float t1 = (-b - sq) * 0.5f;
  const float tn = fminf(t0, t1);
  const float tf = fmaxf(t0, t1);
  const float t = tn > 0.f ? tn : tf;
  return (disc >= 0.f && t > 0.f && rad > 0.f) ? t : INFINITY;
}

// half-space test: (e x (p - a)) . n / |n| + slack >= 0
__device__ __forceinline__ bool left_of(float px, float py, float pz,
                                        float ax, float ay, float az,
                                        float ex, float ey, float ez,
                                        float nx, float ny, float nzz,
                                        float inv_len) {
  const float wx = px - ax, wy = py - ay, wz = pz - az;
  const float sx = ey * wz - ez * wy;
  const float sy = ez * wx - ex * wz;
  const float sz = ex * wy - ey * wx;
  const float s = sx * nx + sy * ny + sz * nzz;
  return s * inv_len + EPS_SLACK >= 0.f;
}

__device__ __forceinline__ float t_tri(const float* p, const Ray& r) {
  const float v0x = p[0], v0y = p[1], v0z = p[2];
  const float v1x = p[3], v1y = p[4], v1z = p[5];
  const float v2x = p[6], v2y = p[7], v2z = p[8];
  const float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
  const float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
  const float nx = e1y * e2z - e1z * e2y;
  const float ny = e1z * e2x - e1x * e2z;
  const float nzz = e1x * e2y - e1y * e2x;
  const float inv_len = 1.f / sqrtf(fmaxf(nx * nx + ny * ny + nzz * nzz, 1e-30f));
  const float orig = nx * v0x + ny * v0y + nzz * v0z;
  const float ndd = nz(nx * r.dx + ny * r.dy + nzz * r.dz);
  const float ndo = nx * r.ox + ny * r.oy + nzz * r.oz;
  const float t = (orig - ndo) / ndd;
  const float px = r.ox + r.dx * t, py = r.oy + r.dy * t, pz = r.oz + r.dz * t;
  const bool inside =
      left_of(px, py, pz, v0x, v0y, v0z, e1x, e1y, e1z, nx, ny, nzz, inv_len) &&
      left_of(px, py, pz, v1x, v1y, v1z, v2x - v1x, v2y - v1y, v2z - v1z,
              nx, ny, nzz, inv_len) &&
      left_of(px, py, pz, v2x, v2y, v2z, v0x - v2x, v0y - v2y, v0z - v2z,
              nx, ny, nzz, inv_len);
  return (inside && t > 0.f) ? t : INFINITY;
}

// the ray's direction reciprocals, 1 / nz(d), as the slab tests take them
struct Recip {
  float x, y, z;
};

__device__ __forceinline__ Recip recip(const Ray& r) {
  return {1.f / nz(r.dx), 1.f / nz(r.dy), 1.f / nz(r.dz)};
}

__device__ __forceinline__ float t_aarect(const float* p, const Ray& r,
                                          const Recip& inv) {
  const float ax1 = (p[0] - r.ox) * inv.x, ay1 = (p[1] - r.oy) * inv.y;
  const float az1 = (p[2] - r.oz) * inv.z, ax2 = (p[3] - r.ox) * inv.x;
  const float ay2 = (p[4] - r.oy) * inv.y, az2 = (p[5] - r.oz) * inv.z;
  const float tmin = fmaxf(fmaxf(fminf(ax1, ax2), fminf(ay1, ay2)), fminf(az1, az2));
  const float tmax = fminf(fminf(fmaxf(ax1, ax2), fmaxf(ay1, ay2)), fmaxf(az1, az2));
  const float t = tmin > 0.f ? tmin : tmax;
  return (tmin < tmax && t > 0.f) ? t : INFINITY;
}

__device__ __forceinline__ float t_aarect(const float* p, const Ray& r) {
  return t_aarect(p, r, recip(r));
}

__device__ __forceinline__ float t_square(const float* p, const Ray& r) {
  const float t = (p[1] - r.oy) / nz(r.dy);
  const float pxq = r.ox + r.dx * t;
  const float pzq = r.oz + r.dz * t;
  const bool inside = (2.f * fabsf(pxq - p[0]) < p[3]) && (2.f * fabsf(pzq - p[2]) < p[3]);
  return (inside && t > 0.f && r.dy != 0.f) ? t : INFINITY;
}

// ---------------------------------------------------------------------------
// Torus: bounding slab, then the over-relaxed SDF march (24 steps) and a
// Newton polish (4 steps) in the torus' local frame.
// ---------------------------------------------------------------------------

// sqrtf, or with APPROX one MUFU.SQRT (sqrt.approx: a relative error
// below 2^-22; x >= 1e-24 here, so ftz flushes nothing) in place of the
// correctly rounded square root's refinement and range branch.  With
// APPROX the derivative's two divisions are __fdividef too: it only
// steers the Newton steps, whose fixed point |f| <= 1e-6 sdf decides.
template <bool APPROX>
__device__ __forceinline__ float torus_sqrt(float x) {
  if constexpr (APPROX) {
    float y;
    asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  } else {
    return sqrtf(x);
  }
}

struct Torus {
  float lox, loy, loz;   // ray origin in the torus frame
  float dx, dy, dz;
  float big_r, small_r;
  float t_in, t_out;
  bool hit_box;

  template <bool APPROX = false>
  __device__ __forceinline__ float sdf(float t) const {
    const float px = lox + dx * t, py = loy + dy * t, pz = loz + dz * t;
    const float qx = torus_sqrt<APPROX>(fmaxf(px * px + pz * pz, 1e-24f)) - big_r;
    return torus_sqrt<APPROX>(fmaxf(qx * qx + py * py, 1e-24f)) - small_r;
  }

  template <bool APPROX = false>
  __device__ __forceinline__ float dsdf(float t) const {
    const float px = lox + dx * t, py = loy + dy * t, pz = loz + dz * t;
    const float rho = torus_sqrt<APPROX>(fmaxf(px * px + pz * pz, 1e-24f));
    const float qx = rho - big_r;
    const float ql = torus_sqrt<APPROX>(fmaxf(qx * qx + py * py, 1e-24f));
    if constexpr (APPROX) {
      const float drho = __fdividef(px * dx + pz * dz, rho);
      return __fdividef(qx * drho + py * dy, ql);
    } else {
      const float drho = (px * dx + pz * dz) / rho;
      return (qx * drho + py * dy) / ql;
    }
  }

  // the march's lower bound; every hit distance is >= it
  __device__ __forceinline__ float t_lo() const { return fmaxf(t_in, 1e-4f); }
};

__device__ __forceinline__ Torus torus_setup(const float* p, const Ray& r,
                                             const Recip& inv) {
  Torus s;
  s.lox = r.ox - p[0]; s.loy = r.oy - p[1]; s.loz = r.oz - p[2];
  s.dx = r.dx; s.dy = r.dy; s.dz = r.dz;
  s.big_r = p[3]; s.small_r = p[4];
  const float extx = p[3] + p[4], exty = p[4];
  const float ax1 = (-extx - s.lox) * inv.x, ax2 = (extx - s.lox) * inv.x;
  const float ay1 = (-exty - s.loy) * inv.y, ay2 = (exty - s.loy) * inv.y;
  const float az1 = (-extx - s.loz) * inv.z, az2 = (extx - s.loz) * inv.z;
  s.t_in = fmaxf(fmaxf(fminf(ax1, ax2), fminf(ay1, ay2)), fminf(az1, az2));
  s.t_out = fminf(fminf(fmaxf(ax1, ax2), fmaxf(ay1, ay2)), fmaxf(az1, az2));
  s.hit_box = s.t_in < s.t_out && s.t_out > 0.f;
  return s;
}

__device__ __forceinline__ Torus torus_setup(const float* p, const Ray& r) {
  return torus_setup(p, r, recip(r));
}

// Distance to the torus along the ray, +inf on a miss.  Call only when
// s.hit_box holds (a box miss is a miss).  APPROX takes the square roots
// by torus_sqrt's approximation (the scene kernels K1 and K2).
//
// Two per-thread early exits, both exact:
//  - march: once a step is not taken, t stays put; if the re-evaluated
//    distance equals the carried one, every later step is the same
//    no-op (accept is then true: 2*dist >= omega*dist for dist >= 0,
//    and step <= tol for dist < 0), so t is final;
//  - Newton: once |f| <= 1e-6, t stays put and f is recomputed from the
//    same t, so every later iteration is the same no-op.
template <bool APPROX = false>
__device__ __forceinline__ float torus_march(const Torus& s) {
  const float t_lo = s.t_lo();
  float t = t_lo;
  const float f0 = s.template sdf<APPROX>(t);
  const float sign0 = f0 > 0.f ? 1.f : (f0 < 0.f ? -1.f : (f0 == 0.f ? 1.f : f0));
  float dist = sign0 * s.template sdf<APPROX>(t);
  float relaxed = 1.f;
  for (int i = 0; i < TORUS_STEPS; ++i) {
    const float step = dist * (relaxed > 0.f ? TORUS_OMEGA : 1.f);
    const bool can = (dist > TORUS_TOL) && (t < s.t_out);
    const float t2 = t + (can ? step : 0.f);
    const float d2 = sign0 * s.template sdf<APPROX>(t2);
    if (!can && d2 == dist) break;
    const bool accept = (step <= TORUS_TOL) || (d2 + dist >= step);
    if (accept) {
      t = t2;
      dist = d2;
    }
    relaxed = accept ? 1.f : 0.f;
  }
  for (int i = 0; i < TORUS_NEWTON; ++i) {
    const float f = sign0 * s.template sdf<APPROX>(t);
    if (!(fabsf(f) > 1e-6f)) break;
    float fp = sign0 * s.template dsdf<APPROX>(t);
    if (fabsf(fp) < 1e-6f) fp = fp < 0.f ? -1e-6f : 1e-6f;
    float tn = t - f / fp;
    tn = tn < t_lo ? t_lo : tn;   // clip as jnp.clip: NaN passes through
    tn = tn > s.t_out ? s.t_out : tn;
    t = tn;
  }
  const bool ok = fabsf(s.template sdf<APPROX>(t)) <= TORUS_HIT_TOL && t > 0.f &&
                  t <= s.t_out + TORUS_TOL;
  return ok ? t : INFINITY;
}


// ---------------------------------------------------------------------------
// Family tables in shared memory, ray loads and the (t, code) fold, shared
// by the scene kernels and the select kernel's dense scan.
// ---------------------------------------------------------------------------

struct Counts {
  int n[N_FAMS];
};

struct Tables {
  const float* fam[N_FAMS];
  int n[N_FAMS];
};

// copy the concatenated family tables into shared memory
__device__ __forceinline__ Tables stage_tables(const float* __restrict__ g,
                                               const Counts& c, float* s) {
  Tables tb;
  int total = 0;
  for (int f = 0; f < N_FAMS; ++f) {
    tb.fam[f] = s + total;
    tb.n[f] = c.n[f];
    total += c.n[f] * fam_width(f);
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) s[i] = g[i];
  __syncthreads();
  return tb;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  return r;
}

// lexicographic (t, code) minimum; a miss is (inf, -1) and never wins
__device__ __forceinline__ void take_min(float t, int code, float& bt, int& bc) {
  if (t < bt || (t == bt && code < bc && t < INFINITY)) {
    bt = t;
    bc = code;
  }
}

// Nearest hit of one ray over the slots j = first, first + stride, ...
// of every family, folded into the lexicographic (t, code) minimum
// (bt, bc).  Tori go last: the best hit so far bounds which marches can
// matter (a torus hit is >= t_lo, so t_lo > bt means it cannot win).
__device__ __forceinline__ void nearest_scan(const Tables& tb, const Ray& r,
                                             int first, int stride,
                                             float& bt, int& bc) {
  for (int j = first; j < tb.n[FAM_PLANE]; j += stride)
    take_min(t_plane(tb.fam[FAM_PLANE] + 6 * j, r), (FAM_PLANE << SLOT_BITS) | j, bt, bc);
  for (int j = first; j < tb.n[FAM_SPHERE]; j += stride)
    take_min(t_sphere(tb.fam[FAM_SPHERE] + 4 * j, r), (FAM_SPHERE << SLOT_BITS) | j, bt, bc);
  for (int j = first; j < tb.n[FAM_TRI]; j += stride)
    take_min(t_tri(tb.fam[FAM_TRI] + 9 * j, r), (FAM_TRI << SLOT_BITS) | j, bt, bc);
  for (int j = first; j < tb.n[FAM_AARECT]; j += stride)
    take_min(t_aarect(tb.fam[FAM_AARECT] + 6 * j, r), (FAM_AARECT << SLOT_BITS) | j, bt, bc);
  for (int j = first; j < tb.n[FAM_SQUARE]; j += stride)
    take_min(t_square(tb.fam[FAM_SQUARE] + 4 * j, r), (FAM_SQUARE << SLOT_BITS) | j, bt, bc);
  for (int j = first; j < tb.n[FAM_TORUS]; j += stride) {
    const Torus s = torus_setup(tb.fam[FAM_TORUS] + 5 * j, r);
    if (!s.hit_box || s.t_lo() > bt) continue;
    take_min(torus_march(s), (FAM_TORUS << SLOT_BITS) | j, bt, bc);
  }
}

}  // namespace wpt
