// Counter-based thermostat noise: Philox4x32-10 (Salmon et al. 2011) keyed
// on the 64-bit launch seed, counter = (atom, replica, step). A draw depends
// on nothing else, so the stream is the same however a campaign is cut into
// launches and whatever the launch geometry. ops/fused_step.py carries the
// same function in PyTorch (philox_normals).
#pragma once
#include <cstdint>

__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// 23 random bits to a uniform strictly inside (0, 1): (b + 0.5) / 2^23 is
// exact in float32, so log() never sees 0.
__device__ __forceinline__ float philox_uniform(uint32_t bits) {
  return (static_cast<float>(bits >> 9) + 0.5f) * (1.0f / 8388608.0f);
}

// Three standard normals for (seed, replica, step, atom) by Box-Muller.
__device__ __forceinline__ void thermostat_normals(uint64_t seed, int replica,
                                                   int64_t step, int atom,
                                                   float& g0, float& g1,
                                                   float& g2) {
  uint32_t o[4];
  philox4x32_10(static_cast<uint32_t>(atom), static_cast<uint32_t>(replica),
                static_cast<uint32_t>(static_cast<uint64_t>(step)),
                static_cast<uint32_t>(static_cast<uint64_t>(step) >> 32),
                static_cast<uint32_t>(seed),
                static_cast<uint32_t>(seed >> 32), o);
  const float two_pi = 6.283185307179586f;
  const float r1 = sqrtf(-2.f * logf(philox_uniform(o[0])));
  const float r2 = sqrtf(-2.f * logf(philox_uniform(o[2])));
  float s, c;
  sincosf(two_pi * philox_uniform(o[1]), &s, &c);
  g0 = r1 * c;
  g1 = r1 * s;
  g2 = r2 * cosf(two_pi * philox_uniform(o[3]));
}
