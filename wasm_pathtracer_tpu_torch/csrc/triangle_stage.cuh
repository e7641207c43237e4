// One ray-triangle test for every kernel that stages its triangles: the
// dense sweep (K8, traverse_kernels.cu), the whole-scene kernels (K1, K2,
// scene_kernels.cu) and the cluster probes (K4, K5, K7, probe_kernels.cu,
// which read a table staged once per scene: ClusterSet.staged).
//
// Everything that does not depend on the ray is computed once per
// triangle, by the thread that stages it into shared memory: the plane
// (n, n.v0) and, by the scalar triple product
// (e x (p - a)) . n = (p - a) . (n x e), one vector m_i = (n x e_i) / |n|
// and one offset k_i = slack - a_i . m_i per edge.  The staged triangle is
// four float4 (n | n.v0, m_i | k_i), each the operands of one chain of
// fused multiply-adds, and a half-space test is
// fma(pz, m.z, fma(py, m.y, fma(px, m.x, k))) >= 0: three instructions
// where the TPU kernel's cross and dot product take seventeen.
//
// t = (n.v0 - n.o) * rcp(n.d) with the approximate reciprocal
// (rcp.approx.ftz: one MUFU.RCP, at most 1 ulp off; |n.d| >= 1e-30, so ftz
// flushes nothing) and a multiply, in place of the IEEE division's ~9
// instructions: t moves by at most 2 ulp.
//
// What differs from the TPU kernel's arithmetic (ops/scene_pallas.py
// _t_tris, ops/traverse_pallas.py): n.d is still clamped to 1e-30 where it
// vanishes, the normal stays unnormalised in the plane test,
// rsqrt(max(n.n, 1e-30)) still scales only the edge terms, and a hit still
// needs inside && t > 0; but the inside test is evaluated in the staged
// form above, so a hit point within rounding of an edge may fall on the
// other side than in the plain version.
#pragma once

#include "scene_families.cuh"

namespace wpt {

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

// p: one (9,) row v0 v1 v2
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
__device__ __forceinline__ float rcp_div(float a, float b) {
  float inv;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(b));
  return a * inv;
}

// t of the plane hit (the first half of staged_hit)
__device__ __forceinline__ float staged_t(const float4& N, const Ray& a) {
  const float ndd = nz(fmaf(a.dz, N.z, fmaf(a.dy, N.y, a.dx * N.x)));
  const float num = fmaf(-a.oz, N.z, fmaf(-a.oy, N.y, fmaf(-a.ox, N.x, N.w)));
  return rcp_div(num, ndd);
}

// whether the plane hit at t lies inside the three edges (the second half)
__device__ __forceinline__ bool staged_inside(const float4& M0, const float4& M1,
                                              const float4& M2, const Ray& a,
                                              float t) {
  const float px = fmaf(a.dx, t, a.ox), py = fmaf(a.dy, t, a.oy),
              pz = fmaf(a.dz, t, a.oz);
  const float s0 = fmaf(pz, M0.z, fmaf(py, M0.y, fmaf(px, M0.x, M0.w)));
  const float s1 = fmaf(pz, M1.z, fmaf(py, M1.y, fmaf(px, M1.x, M1.w)));
  const float s2 = fmaf(pz, M2.z, fmaf(py, M2.y, fmaf(px, M2.x, M2.w)));
  return s0 >= 0.f && s1 >= 0.f && s2 >= 0.f;
}

// The pair test: t of the plane hit, and whether the hit point lies inside
// the three edges (t > 0 is left to the caller).
__device__ __forceinline__ float staged_hit(const float4& N, const float4& M0,
                                            const float4& M1, const float4& M2,
                                            const Ray& a, bool& inside) {
  const float t = staged_t(N, a);
  inside = staged_inside(M0, M1, M2, a, t);
  return t;
}

}  // namespace wpt
