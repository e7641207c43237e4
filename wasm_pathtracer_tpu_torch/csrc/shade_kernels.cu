// A bounce's shading in one kernel: wpt_shade_kernel.
//
// Replaces no TPU kernel.  The JAX package's loop body is one jitted
// program, so XLA fuses the shading of a bounce into a few device
// kernels; the port's eager integrator._shade_core launched ~650 small
// kernels for it, and the queue loops waited on the host to launch them.
// This kernel does all of _shade_core's forward work for one lane per
// thread: the hit row and its normal (all six primitive types, the texture
// lookup included), Beer-Lambert absorption, the background and emissive
// adds, the cosine / mirror / Fresnel branches and the medium, the NEE
// light pick (uniform or from the photon grid's cached tables), the light
// point and its solid-angle weight, and Russian roulette.  It writes the
// new carry and the pending shadow query in one pass.
//
// What bounds it on the card: the latency of one lane's dependent chain
// (three transcendental calls, a dozen divisions and square roots, the
// PNEE CDF count), not memory: a lane reads ~200 bytes (ray, carry, one
// 96-byte hit row, one light row) and writes ~110.  A session's queue
// runs 8,192 lanes, 128 blocks of 64 threads, one block an SM; so the
// design keeps the chain short and does nothing clever with the blocks.
//
// Rounding follows the eager PyTorch chain op by op, so that paths branch
// the same way on the card with and without the kernel:
//  - every float add, subtract, multiply, divide and square root goes
//    through __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn / __fsqrt_rn,
//    which the compiler never contracts into an FMA (each eager op is its
//    own kernel and rounds once); expf, cosf, sinf, powf, atan2f, asinf are
//    the CUDA math library's, as ATen's kernels call them;
//  - a division by a host scalar is ATen's multiply by the scalar's float
//    reciprocal (div_true_kernel_cuda); 1.0 / x is reciprocal(x);
//  - torch.sum over a trailing axis of 3 is ATen's reduction order on the
//    card, (x0 + x2) + x1 (sum3); torch.linalg.cross is its kernel's
//    contraction, fma(x1, y2, -(x2 * y1)) (cross1); torch.linalg.norm
//    sums the rounded squares in sum3's order (length).  Each was read off
//    ATen on the H100 (torch 2.11, CUDA 12.8) against the alternatives;
//  - clamp, minimum, maximum and amax pass a NaN on, as ATen's do.
// The pcg3d draws are pcg3d.cuh's, bit for bit the int64 host form's.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pcg3d.cuh"

namespace wpt {

constexpr int SHADE_BLOCK = 64;     // threads per block, one lane a thread
constexpr int ROW = 24;             // floats of a packed hit row (trace.pack_hit_rows)
constexpr int LIGHT_ROW = 16;       // floats of a light row (integrator._light_table)
// RNG slots of a bounce (integrator._SLOT_*); photon.sample draws at
// SLOT_PNEE and SLOT_PNEE + 2
constexpr uint32_t SLOT_HEMI = 0, SLOT_RR = 1, SLOT_LIGHT_PICK = 2, SLOT_LIGHT_POINT = 3,
                   SLOT_PNEE = 4, SLOT_MAT = 5;
// MatKind and PrimType values
constexpr int MAT_EMISSIVE = 1, MAT_REFLECT = 2, MAT_REFRACT = 3;
constexpr int PRIM_SPHERE = 1, PRIM_TRIANGLE = 2, PRIM_TORUS = 3, PRIM_AARECT = 4,
              PRIM_SQUARE = 5;
constexpr float PI_F = 3.14159274101257324f;        // float(math.pi)
constexpr float TWO_PI_F = 6.28318548202514648f;    // float(2.0 * math.pi)

// What the wrapper (ops/shade_kernels.py::fused_shade) hands the kernel;
// the ctypes Structure there mirrors this layout field for field.
struct ShadeArgs {
  // scene
  const float* rows;        // (N, 24) packed hit rows
  const float* atlas;       // (K, tex_h, tex_w, 3) textures
  const float* background;  // (3,)
  const float* lights;      // (L, 16) light table
  // photon grid (nee == 2)
  const float* cdf;         // (cells, grid_l) cumulative histograms
  const float* norm;        // (cells * grid_l,) bins over their cell's sum
  const float* grid_lo;     // (3,)
  const float* grid_hi;     // (3,)
  // lanes in
  const float* o;
  const float* d;
  const float* tp;
  const float* col;
  const float* absorb;
  const float* t;
  const bool* alive;
  const bool* hdb;
  const bool* hit;
  const long long* sid;
  const long long* ray_id;
  const long long* slot0;   // per lane, or null: slot_base on every lane
  // lanes out
  float* o_out;
  float* d_out;
  float* tp_out;
  float* col_out;
  float* absorb_out;
  float* p_from;            // the shadow query (null without one)
  float* p_to;
  float* contrib;
  bool* alive_out;
  bool* hdb_out;
  bool* need;
  long long* light_sid;
  long long slot_base;
  int n;                    // lanes
  int n_tex, tex_h, tex_w;
  int n_lights;             // the uniform pick's range, max(num_lights, 1)
  int grid_res, grid_l;
  int nee;                  // 0 none, 1 uniform pick, 2 photon-guided pick
  int debug_photons;        // NEE adds the picked light's unshadowed intensity
  int emis_once;            // emissive hits add only before the first diffuse bounce
  uint32_t seed;
  float eps, rr_min, rr_max;
  float inv_light_chance;   // the uniform pick's 1 / light chance, as ATen divides
};

// ---- arithmetic: one IEEE rounding an op, never contracted -----------------

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }

// torch.clamp / clamp(min=) / minimum / maximum on the card: NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

struct V {
  float x, y, z;
};

__device__ __forceinline__ V load3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, int i, V v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V vadd(V a, V b) { return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)}; }
__device__ __forceinline__ V vsub(V a, V b) { return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)}; }
__device__ __forceinline__ V vmul(V a, V b) { return {mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z)}; }
__device__ __forceinline__ V vscale(V a, float s) { return {mul(a.x, s), mul(a.y, s), mul(a.z, s)}; }
__device__ __forceinline__ V vdiv(V a, float s) { return {dvd(a.x, s), dvd(a.y, s), dvd(a.z, s)}; }
__device__ __forceinline__ V vneg(V a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V pick(bool c, V a, V b) { return c ? a : b; }

// torch.sum(x, dim=-1) of a (R, 3) tensor on the card: two threads take
// elements {0, 2} and {1}, each partial sum starting at 0 (so -0 reads +0)
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return add(add(add(0.0f, x0), add(0.0f, x2)), add(0.0f, x1));
}
__device__ __forceinline__ float dot(V u, V v) {
  return sum3(mul(u.x, v.x), mul(u.y, v.y), mul(u.z, v.z));
}
// vecmath.length, and torch.linalg.norm over a trailing axis of 3
__device__ __forceinline__ float length(V v) { return root(dot(v, v)); }
// vecmath.normalize without eps: v / |v|
__device__ __forceinline__ V normalize(V v) { return vdiv(v, length(v)); }

// torch.linalg.cross: ATen's kernel computes x1 * y2 - x2 * y1 in one
// expression, contracted to an FMA
__device__ __forceinline__ float cross1(float x1, float y2, float x2, float y1) {
  return __fmaf_rn(x1, y2, -mul(x2, y1));
}
__device__ __forceinline__ V cross(V u, V v) {
  return {cross1(u.y, v.z, u.z, v.y), cross1(u.z, v.x, u.x, v.z), cross1(u.x, v.y, u.y, v.x)};
}

// intersect._nonzero
__device__ __forceinline__ float nonzero(float x) { return fabsf(x) < 1e-30f ? 1e-30f : x; }

// torch.isclose(t, c, rtol=1e-6, atol=1e-7)
__device__ __forceinline__ bool isclose(float t, float c) {
  const float act = fabsf(sub(t, c));
  const float allowed = add(fabsf(mul(c, 1e-6f)), 1e-7f);
  return t == c || (isfinite(act) && act <= allowed);
}

// Python's remainder for a positive divisor
__device__ __forceinline__ int wrap(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ long long clampll(long long x, long long lo, long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct HitInfo {
  V n;
  bool ent;
};

// trace.hit_info_from_row's normal and entering flag for the row's type
__device__ HitInfo hit_normal(const float* pr, int pt, V o, V d, float t) {
  const V r0 = {pr[0], pr[1], pr[2]};
  const V r1 = {pr[3], pr[4], pr[5]};
  const V r2 = {pr[6], pr[7], pr[8]};
  if (pt == PRIM_SPHERE) {
    const V p = vadd(o, vscale(d, t));
    const float rad = pr[3];
    const V n = vdiv(vsub(p, r0), nonzero(rad));
    const V oc = vsub(o, r0);
    const bool inside = dot(oc, oc) < mul(rad, rad);
    return {pick(inside, vneg(n), n), !inside};
  }
  if (pt == PRIM_TRIANGLE) {
    const V n = normalize(cross(vsub(r1, r0), vsub(r2, r0)));
    const bool back = dot(n, d) > 0.0f;
    return {pick(back, vneg(n), n), !back};
  }
  if (pt == PRIM_TORUS) {
    const float big_r = pr[3], small_r = pr[4];
    const V p = vsub(vadd(o, vscale(d, t)), r0);
    const float alpha =
        sub(1.0f, dvd(big_r, root(clamp_min(add(mul(p.x, p.x), mul(p.z, p.z)), 1e-24f))));
    const V n = normalize({mul(alpha, p.x), p.y, mul(alpha, p.z)});
    // intersect._torus_sdf(o - center) < 0
    const V l = vsub(o, r0);
    const float qx = sub(root(clamp_min(add(mul(l.x, l.x), mul(l.z, l.z)), 1e-24f)), big_r);
    const float sdf = sub(root(clamp_min(add(mul(qx, qx), mul(l.y, l.y)), 1e-24f)), small_r);
    const bool inside = sdf < 0.0f;
    return {pick(inside, vneg(n), n), !inside};
  }
  if (pt == PRIM_AARECT) {
    const V inv = {dvd(1.0f, nonzero(d.x)), dvd(1.0f, nonzero(d.y)), dvd(1.0f, nonzero(d.z))};
    const V t1 = vmul(vsub(r0, o), inv);
    const V t2 = vmul(vsub(r1, o), inv);
    const float tmin =
        nan_max(nan_max(nan_min(t1.x, t2.x), nan_min(t1.y, t2.y)), nan_min(t1.z, t2.z));
    const bool inside = !(tmin > 0.0f);
    // the first face whose slab distance is close to t, in the order
    // tx1, tx2, ty1, ty2, tz1, tz2; the first when none is
    const float cands[6] = {t1.x, t2.x, t1.y, t2.y, t1.z, t2.z};
    int idx = 0;
    for (int k = 5; k >= 0; --k)
      if (isclose(t, cands[k])) idx = k;
    V n = {0.0f, 0.0f, 0.0f};
    const float s = (idx & 1) ? 1.0f : -1.0f;
    if (idx < 2) n.x = s;
    else if (idx < 4) n.y = s;
    else n.z = s;
    return {pick(inside, vneg(n), n), !inside};
  }
  if (pt == PRIM_SQUARE) return {{0.0f, d.y <= 0.0f ? 1.0f : -1.0f, 0.0f}, true};
  // a plane, and the default of an unknown type
  const bool flip = dot(d, r1) > 0.0f;
  return {pick(flip, vneg(r1), r1), true};
}

// trace._hit_uv and _texture_lookup: the albedo of a textured hit
__device__ V texture_albedo(const ShadeArgs& a, const float* pr, int pt, int tex, V p, V n) {
  float u = 0.0f, v = 0.0f;
  if (pt == PRIM_SQUARE) {
    const float size = clamp_min(pr[3], 1e-12f);
    u = add(dvd(sub(p.x, pr[0]), size), 0.5f);
    v = add(dvd(sub(p.z, pr[2]), size), 0.5f);
  } else if (pt == PRIM_SPHERE) {
    u = add(0.5f, mul(atan2f(n.z, n.x), dvd(1.0f, TWO_PI_F)));
    v = sub(0.5f, mul(asinf(clamp2(n.y, -1.0f, 1.0f)), dvd(1.0f, PI_F)));
  }
  const int k = tex < 0 ? 0 : (tex > a.n_tex - 1 ? a.n_tex - 1 : tex);
  const int x = wrap(static_cast<int>(mul(u, static_cast<float>(a.tex_w))), a.tex_w);
  const int y = wrap(static_cast<int>(mul(v, static_cast<float>(a.tex_h))), a.tex_h);
  const float* px = a.atlas + 3 * ((static_cast<long long>(k) * a.tex_h + y) * a.tex_w + x);
  return {px[0], px[1], px[2]};
}

__device__ __forceinline__ long long cell_of(const ShadeArgs& a, long long x, long long y,
                                             long long z) {
  return (x * a.grid_res + y) * a.grid_res + z;
}

// photon.sample: the light id and its exact probability at hit point p
__device__ void photon_pick(const ShadeArgs& a, V p, uint32_t rid, uint32_t slot, int& lid,
                            float& pdf) {
  const int L = a.grid_l;
  const long long hi_cell = a.grid_res - 1;
  const float res = static_cast<float>(a.grid_res);
  const float pc[3] = {p.x, p.y, p.z};
  float w_own[3];
  long long c[3], off[3];
  bool outside = false;
  for (int k = 0; k < 3; ++k) {
    const float lo = a.grid_lo[k], hi = a.grid_hi[k];
    const float u = mul(dvd(sub(pc[k], lo), sub(hi, lo)), res);
    c[k] = clampll(static_cast<long long>(floorf(u)), 0, hi_cell);
    const float frac = sub(u, static_cast<float>(c[k]));
    w_own[k] = sub(1.0f, fabsf(sub(frac, 0.5f)));
    off[k] = frac > 0.5f ? 1 : -1;
    outside = outside || pc[k] < lo || pc[k] > hi;
  }
  const Uniform3 q = uniform3(a.seed, rid, slot);
  const float u4 = uniform3(a.seed, rid, slot + 2).a;
  const float qu[3] = {q.a, q.b, q.c};
  long long cs[3];
  for (int k = 0; k < 3; ++k) cs[k] = clampll(c[k] + (qu[k] <= w_own[k] ? 0 : off[k]), 0, hi_cell);
  // sum(cdf < r): a count, not a search, so that a CDF whose parallel
  // cumulative sum is not monotone still gives the eager lid
  const float* cdf = a.cdf + cell_of(a, cs[0], cs[1], cs[2]) * L;
  const float r = mul(u4, cdf[L - 1]);
  int below = 0;
  for (int j = 0; j < L; ++j) below += cdf[j] < r;
  int id = below < L - 1 ? below : L - 1;
  // the exact pdf: the 8 neighbours in (x, y, z)-major order, summed in turn
  float sum = 0.0f;
  for (int k = 0; k < 8; ++k) {
    const long long cx = clampll(c[0] + off[0] * ((k >> 2) & 1), 0, hi_cell);
    const long long cy = clampll(c[1] + off[1] * ((k >> 1) & 1), 0, hi_cell);
    const long long cz = clampll(c[2] + off[2] * (k & 1), 0, hi_cell);
    const float prob = a.norm[cell_of(a, cx, cy, cz) * L + id];
    const float wx = ((k >> 2) & 1) ? sub(1.0f, w_own[0]) : w_own[0];
    const float wy = ((k >> 1) & 1) ? sub(1.0f, w_own[1]) : w_own[1];
    const float wz = (k & 1) ? sub(1.0f, w_own[2]) : w_own[2];
    const float pw = mul(prob, mul(mul(wx, wy), wz));
    sum = k ? add(sum, pw) : pw;
  }
  if (outside) {
    const long long uni = static_cast<long long>(mul(u4, static_cast<float>(L)));
    id = static_cast<int>(uni < L - 1 ? uni : L - 1);
    sum = static_cast<float>(1.0 / static_cast<double>(L));
  }
  lid = id;
  pdf = sum;
}

__global__ void __launch_bounds__(SHADE_BLOCK) wpt_shade_kernel(const ShadeArgs a) {
  const int i = blockIdx.x * SHADE_BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const V o = load3(a.o, i), d = load3(a.d, i), absorb = load3(a.absorb, i);
  V tp = load3(a.tp, i), col = load3(a.col, i);
  const bool alive = a.alive[i], hdb = a.hdb[i], hit = a.hit[i];
  const float t = a.t[i];
  const long long sid = a.sid[i];
  const uint32_t rid = static_cast<uint32_t>(a.ray_id[i]);
  const uint32_t slot0 = static_cast<uint32_t>(a.slot0 ? a.slot0[i] : a.slot_base);
  const uint32_t seed = a.seed;

  // ---- hit info of the winning shape (t sanitized on a miss)
  const float t_safe = hit ? t : 1.0f;
  const float* pr = a.rows + (sid > 0 ? sid : 0) * ROW;
  const int pt = static_cast<int>(pr[20]);
  const int kind = static_cast<int>(pr[21]);
  const HitInfo hi = hit_normal(pr, pt, o, d, t_safe);
  const V n = hi.n;
  V albedo = {pr[9], pr[10], pr[11]};
  const int tex = static_cast<int>(pr[22]);
  if (a.n_tex > 0 && tex >= 0)
    albedo = texture_albedo(a, pr, pt, tex, vadd(o, vscale(d, t_safe)), n);
  const V emission = {pr[12], pr[13], pr[14]};
  const float reflectivity = pr[15], ior = pr[16];
  const V absorb_in = {pr[17], pr[18], pr[19]};

  // ---- Beer-Lambert absorption through the current medium
  const float seg = hit ? t : 0.0f;
  tp = {mul(tp.x, expf(mul(-absorb.x, seg))), mul(tp.y, expf(mul(-absorb.y, seg))),
        mul(tp.z, expf(mul(-absorb.z, seg)))};
  const V hp = vadd(o, vscale(d, t_safe));

  const bool is_emissive = kind == MAT_EMISSIVE;
  const bool is_refract = kind == MAT_REFRACT;
  const bool is_reflect = kind == MAT_REFLECT;

  // ---- miss: background; emissive hit
  const bool miss = alive && !hit;
  const V bg = {a.background[0], a.background[1], a.background[2]};
  col = vadd(col, pick(miss, vmul(tp, bg), V{0.0f, 0.0f, 0.0f}));
  const bool emis_hit = alive && hit && is_emissive;
  const bool add_emis = a.emis_once ? emis_hit && !hdb : emis_hit;
  col = vadd(col, pick(add_emis, vmul(tp, emission), V{0.0f, 0.0f, 0.0f}));

  // ---- scatter
  const bool scat = alive && hit && !is_emissive;
  const V wo = vneg(d);
  const Uniform3 uh = uniform3(seed, rid, slot0 + SLOT_HEMI);
  const Uniform3 umat = uniform3(seed, rid, slot0 + SLOT_MAT);

  // diffuse: cosine-weighted hemisphere around n (vecmath.tangent_frame)
  V tan;
  {
    auto safe = [](float v) { return fabsf(v) > 1e-12f ? v : 1.0f; };
    V c;
    if (fabsf(n.z) > 0.1f) c = {1.0f, 1.0f, dvd(-add(n.x, n.y), safe(n.z))};
    else if (fabsf(n.x) > 0.1f) c = {dvd(-add(n.y, n.z), safe(n.x)), 1.0f, 1.0f};
    else c = {1.0f, dvd(-add(n.x, n.z), safe(n.y)), 1.0f};
    tan = normalize(c);
  }
  const V bit = cross(n, tan);
  const float two_pi_r1 = mul(uh.a, TWO_PI_F);
  const float s = root(clamp_min(sub(1.0f, uh.b), 0.0f));
  const float hx = mul(cosf(two_pi_r1), s);
  const float hy = root(uh.b);
  const float hz = mul(sinf(two_pi_r1), s);
  const V wi_d = normalize(vadd(vadd(vscale(tan, hx), vscale(n, hy)), vscale(bit, hz)));
  const float inv_pi = dvd(1.0f, PI_F);
  const float pdf_d = mul(dot(wi_d, n), inv_pi);
  const float cos_d = dot(wi_d, n);
  const V contrib_d = vscale(vscale(albedo, inv_pi), dvd(cos_d, clamp_min(pdf_d, 1e-12f)));

  // mirror
  const V wi_m = vsub(vscale(n, mul(2.0f, dot(wo, n))), wo);

  // refract: Fresnel-weighted reflect / transmit
  const bool ent = hi.ent;
  const float n1 = ent ? 1.0f : ior;
  const float n2 = ent ? ior : 1.0f;
  const float eta = dvd(n1, clamp_min(n2, 1e-12f));
  const float ci = -dot(d, n);
  const float cos_i = clamp2(ci, 0.0f, 1.0f);
  const float sin2_t = mul(mul(eta, eta), clamp_min(sub(1.0f, mul(ci, ci)), 0.0f));
  const bool tir = sin2_t > 1.0f;
  float cos_t = root(sin2_t < 1.0f ? sub(1.0f, sin2_t) : 1.0f);
  cos_t = tir ? 0.0f : cos_t;
  const V refr = vadd(vscale(d, eta), vscale(n, sub(mul(eta, ci), cos_t)));
  const V wi_t = vscale(refr, dvd(1.0f, clamp_min(length(refr), 1e-12f)));
  const float q = dvd(sub(n1, n2), add(n1, n2));
  const float r0 = mul(q, q);
  const float schlick = add(r0, mul(sub(1.0f, r0), powf(sub(1.0f, cos_i), 5.0f)));
  const float fres = tir ? 1.0f : schlick;
  const bool take_refl_r = umat.b < fres;

  // the branch of the material kind
  const bool mirror_now = is_reflect && umat.a < reflectivity;
  const bool specular = mirror_now || is_refract;
  const V wi = is_refract ? pick(take_refl_r, wi_m, wi_t) : pick(mirror_now, wi_m, wi_d);
  const V contrib = is_refract ? V{1.0f, 1.0f, 1.0f} : pick(mirror_now, albedo, contrib_d);
  V new_tp = vmul(tp, contrib);
  const bool entering = is_refract && !take_refl_r && ent;
  const bool exiting = is_refract && !take_refl_r && !ent;
  const V new_absorb = entering ? absorb_in : (exiting ? V{0.0f, 0.0f, 0.0f} : absorb);
  const bool diffuse_now = scat && !specular;
  const bool new_hdb = hdb || diffuse_now;

  // ---- NEE from diffuse scatters
  if (a.nee) {
    int lid;
    float chance = 0.0f;
    if (a.nee == 2) {
      photon_pick(a, hp, rid, slot0 + SLOT_PNEE, lid, chance);
      chance = clamp_min(chance, 1e-12f);
    } else {
      const float u = uniform3(seed, rid, slot0 + SLOT_LIGHT_PICK).a;
      lid = static_cast<int>(mul(u, static_cast<float>(a.n_lights)));
      lid = lid < a.n_lights - 1 ? lid : a.n_lights - 1;
    }
    const float* lr = a.lights + static_cast<long long>(lid) * LIGHT_ROW;
    const V l0 = {lr[0], lr[1], lr[2]}, l1 = {lr[3], lr[4], lr[5]}, l2 = {lr[6], lr[7], lr[8]};
    const V intensity = {lr[9], lr[10], lr[11]};
    const Uniform3 ul = uniform3(seed, rid, slot0 + SLOT_LIGHT_POINT);
    // intersect.triangle_pick_random
    const float r1s = root(ul.a);
    const V p_l = vadd(vadd(vscale(l0, sub(1.0f, r1s)), vscale(l1, mul(r1s, sub(1.0f, ul.b)))),
                       vscale(l2, mul(ul.b, r1s)));
    const V e_cross = cross(vsub(l1, l0), vsub(l2, l0));
    V n_l = normalize(e_cross);
    n_l = pick(ul.c > 0.5f, vneg(n_l), n_l);

    V to_l = vsub(p_l, hp);
    const float dis_sq = clamp_min(dot(to_l, to_l), 1e-12f);
    to_l = vdiv(to_l, root(dis_sq));
    const float cos_i_l = dot(to_l, n);
    const float cos_o_l = dot(vneg(to_l), n_l);
    const bool nee_mask = diffuse_now && cos_i_l > 0.0f && cos_o_l > 0.0f;
    if (a.debug_photons) {
      col = vadd(col, pick(nee_mask, vmul(new_tp, intensity), V{0.0f, 0.0f, 0.0f}));
    } else {
      const float area = mul(0.5f, length(e_cross));
      const float solid_angle = dvd(mul(area, cos_o_l), dis_sq);
      float w = a.nee == 2 ? dvd(mul(solid_angle, cos_i_l), chance)
                           : mul(mul(solid_angle, cos_i_l), a.inv_light_chance);
      w = nee_mask ? w : 0.0f;
      a.need[i] = nee_mask;
      store3(a.p_from, i, hp);
      store3(a.p_to, i, p_l);
      a.light_sid[i] = static_cast<long long>(lr[12]);
      store3(a.contrib, i, vscale(vmul(new_tp, intensity), w));
    }
  }

  // ---- Russian roulette
  const float u_rr = uniform3(seed, rid, slot0 + SLOT_RR).a;
  const float keep = clamp2(nan_max(nan_max(new_tp.x, new_tp.y), new_tp.z), a.rr_min, a.rr_max);
  const bool survive = u_rr < keep;
  new_tp = vdiv(new_tp, keep);

  store3(a.o_out, i, pick(scat, vadd(hp, vscale(wi, a.eps)), o));
  store3(a.d_out, i, pick(scat, wi, d));
  store3(a.tp_out, i, pick(scat, new_tp, tp));
  store3(a.col_out, i, col);
  store3(a.absorb_out, i, pick(scat, new_absorb, absorb));
  a.alive_out[i] = scat && survive;
  a.hdb_out[i] = scat ? new_hdb : hdb;
}

}  // namespace wpt

extern "C" {

// One launch over args->n lanes on the given stream.
int wpt_shade(const wpt::ShadeArgs* args, void* stream) {
  using namespace wpt;
  cudaGetLastError();   // clear a stale error so the return value is ours
  if (args->n <= 0) return 0;
  const int blocks = (args->n + SHADE_BLOCK - 1) / SHADE_BLOCK;
  wpt_shade_kernel<<<blocks, SHADE_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
