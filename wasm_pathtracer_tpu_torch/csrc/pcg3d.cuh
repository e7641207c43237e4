// pcg3d counter-based random numbers in native uint32, for the kernels.
//
// The device form of utils/rng.py: every draw is a pure function of
// (seed, ray_id, slot), and uniform3 gives the bits of rng.uniform3 (its
// int64 ops masked to 32 bits are exactly this uint32 arithmetic, wrap
// included).  Each unit in [0, 1) is the top 24 bits times 2^-24, exact
// in float32.
#pragma once

#include <stdint.h>

namespace wpt {

__device__ __forceinline__ void pcg3d(uint32_t& x, uint32_t& y, uint32_t& z) {
  constexpr uint32_t M = 1664525u;
  constexpr uint32_t A = 1013904223u;
  x = x * M + A;
  y = y * M + A;
  z = z * M + A;
  x += y * z;
  y += z * x;
  z += x * y;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  x += y * z;
  y += z * x;
  z += x * y;
}

struct Uniform3 {
  float a, b, c;
};

// rng.uniform3(seed, ray_id, slot): the hash runs on (ray_id, slot, seed).
__device__ __forceinline__ Uniform3 uniform3(uint32_t seed, uint32_t ray_id, uint32_t slot) {
  uint32_t x = ray_id, y = slot, z = seed;
  pcg3d(x, y, z);
  constexpr float INV_2_24 = 1.0f / 16777216.0f;
  return {static_cast<float>(x >> 8) * INV_2_24, static_cast<float>(y >> 8) * INV_2_24,
          static_cast<float>(z >> 8) * INV_2_24};
}

}  // namespace wpt
