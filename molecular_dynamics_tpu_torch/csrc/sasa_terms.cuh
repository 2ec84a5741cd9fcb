// LCPO nonpolar solvation force of one replica whose coordinates sit in
// shared memory, on the compact heavy-atom set (atoms with a nonzero SASA
// radius). The physics lives here once: the standalone SASA kernel and the
// campaign kernel both go through sasa_forces_add().
//
// Table layout (ops/sasa.py): idx[p] = atom index of compact atom p;
// atom[5 * p + c], c = 0 probe-inflated radius r_p, 1 a0 = P1 4 pi r^2,
// 2 P2, 3 P3, 4 P4.
//
// Passes, a barrier after each:
//   A  per ordered pair: d from exact coordinate differences (IEEE 1/sqrtf),
//      overlap o_pq = |r_p - r_q| < d < r_p + r_q into row p's bit mask,
//      buried area a_pq = 2 pi r_p (r_p - d/2 - (r_p^2 - r_q^2) / 2d)
//   B  per overlapping pair: B_pq = sum_{k in N(p)} a_qk
//   C  per atom: area A_p = a0 + sum_{q in N(p)} [P2 a_pq + (P3 + P4 a_pq)
//      B_pq], gate g_p = gamma where A_p > 0 else 0 (the relu of
//      sum max(A, 0); the cotangent below is valid only with it)
//   D  per overlapping pair: W_pq = dE/da_pq = g_p P2_p + sum_{i in N(p)}
//      g_i (P3_i + P4_i a_ip) o_iq + g_p P4_p B_pq, and c_pq = W_pq da/dd / d
//      written over B_pq
//   E  per atom: F_p = -sum_{q in N(p)} (c_pq + c_qp) (r_p - r_q), added to
//      the caller's force at idx[p]
// N(p), the overlapping neighbours of p, are the set bits of row p. The TPU
// kernel this replaces forms the same sums as dense (lc, lc) x (lc, lc)
// products; overlaps are sparse, and the loops over set bits need two
// (nc, nc) matrices instead of four. No atomics: every sum is a gather in a
// fixed order, so a launch gives the same bits every run.
#pragma once

struct SasaShared {
  float* a;        // nc * nc: a_pq, 0 where p and q do not overlap
  float* b;        // nc * nc: B_pq, then c_pq in place
  unsigned* bits;  // nc * words: overlap masks
  float *cx, *cy, *cz;  // compact coordinates
  float *g, *g3, *g4;   // g_p, g_p P3_p, g_p P4_p
};

enum SasaColumn { kSasaRadius, kSasaA0, kSasaP2, kSasaP3, kSasaP4, kSasaColumns };

__host__ __device__ inline int sasa_words(int nc) { return (nc + 31) / 32; }

// 32-bit words of shared memory the pass needs (ops/sasa.py
// sasa_shared_bytes says the same).
__host__ __device__ inline size_t sasa_shared_words(int nc) {
  return 2 * static_cast<size_t>(nc) * nc +
         static_cast<size_t>(nc) * sasa_words(nc) + 6 * static_cast<size_t>(nc);
}

__device__ __forceinline__ SasaShared sasa_carve(float* p, int nc) {
  SasaShared w;
  w.a = p; p += nc * nc;
  w.b = p; p += nc * nc;
  w.bits = reinterpret_cast<unsigned*>(p); p += nc * sasa_words(nc);
  w.cx = p; p += nc; w.cy = p; p += nc; w.cz = p; p += nc;
  w.g = p; p += nc; w.g3 = p; p += nc; w.g4 = p;
  return w;
}

__device__ __forceinline__ bool sasa_bit(const SasaShared& w, int words, int p,
                                         int q) {
  return (w.bits[p * words + (q >> 5)] >> (q & 31)) & 1u;
}

// The LCPO force of the replica whose coordinates are (sx, sy, sz), added to
// (tx, ty, tz). Returns this thread's share of the energy gamma * sum
// max(A_p, 0) when kEnergy. Expects a barrier before (coordinates complete)
// and leaves one behind.
template <int kThreads, bool kEnergy>
__device__ __forceinline__ float sasa_forces_add(
    int nc, const int* __restrict__ idx, const float* __restrict__ atom,
    float gamma, const float* sx, const float* sy, const float* sz,
    const SasaShared& w, float* tx, float* ty, float* tz) {
  constexpr float kPi = 3.14159265358979323846f;
  const int tid = threadIdx.x;
  const int words = sasa_words(nc);
  float e_thread = 0.f;

  for (int p = tid; p < nc; p += kThreads) {
    const int i = __ldg(&idx[p]);
    w.cx[p] = sx[i];
    w.cy[p] = sy[i];
    w.cz[p] = sz[i];
  }
  __syncthreads();

  // A: one thread per (p, word of 32 partners)
  for (int task = tid; task < nc * words; task += kThreads) {
    const int p = task / words, q0 = 32 * (task % words);
    const float rp = __ldg(&atom[kSasaColumns * p + kSasaRadius]);
    const float xp = w.cx[p], yp = w.cy[p], zp = w.cz[p];
    const float k1 = 2.0f * kPi * rp * rp, k2 = kPi * rp;
    unsigned mask = 0u;
    const int q1 = min(nc, q0 + 32);
    for (int q = q0; q < q1; ++q) {
      const float rq = __ldg(&atom[kSasaColumns * q + kSasaRadius]);
      const float dx = xp - w.cx[q], dy = yp - w.cy[q], dz = zp - w.cz[q];
      const float d2 = dx * dx + dy * dy + dz * dz;
      float a = 0.f;
      if (q != p && d2 > 0.f) {
        const float dinv = 1.0f / sqrtf(d2);
        const float d = d2 * dinv;
        if (d < rp + rq && d > fabsf(rp - rq)) {
          mask |= 1u << (q - q0);
          a = k1 - k2 * d - kPi * rp * (rp * rp - rq * rq) * dinv;
        }
      }
      w.a[p * nc + q] = a;
    }
    w.bits[task] = mask;
  }
  __syncthreads();

  // B: B_pq = sum_{k in N(p)} a_qk
  for (int pq = tid; pq < nc * nc; pq += kThreads) {
    const int p = pq / nc, q = pq - p * nc;
    if (!sasa_bit(w, words, p, q)) continue;
    float sum = 0.f;
    for (int wd = 0; wd < words; ++wd) {
      unsigned m = w.bits[p * words + wd];
      while (m) {
        const int k = 32 * wd + __ffs(m) - 1;
        m &= m - 1;
        sum += w.a[q * nc + k];
      }
    }
    w.b[pq] = sum;
  }
  __syncthreads();

  // C: areas and gates
  for (int p = tid; p < nc; p += kThreads) {
    const float p2 = __ldg(&atom[kSasaColumns * p + kSasaP2]);
    const float p3 = __ldg(&atom[kSasaColumns * p + kSasaP3]);
    const float p4 = __ldg(&atom[kSasaColumns * p + kSasaP4]);
    float area = __ldg(&atom[kSasaColumns * p + kSasaA0]);
    for (int wd = 0; wd < words; ++wd) {
      unsigned m = w.bits[p * words + wd];
      while (m) {
        const int q = 32 * wd + __ffs(m) - 1;
        m &= m - 1;
        const float a = w.a[p * nc + q];
        area += p2 * a + (p3 + p4 * a) * w.b[p * nc + q];
      }
    }
    const float g = area > 0.f ? gamma : 0.f;
    w.g[p] = g;
    w.g3[p] = g * p3;
    w.g4[p] = g * p4;
    if (kEnergy) e_thread += g * area;
  }
  __syncthreads();

  // D: cotangent W_pq and the pair's force factor c_pq over B_pq
  for (int pq = tid; pq < nc * nc; pq += kThreads) {
    const int p = pq / nc, q = pq - p * nc;
    if (!sasa_bit(w, words, p, q)) continue;
    float gsum = 0.f;
    for (int wd = 0; wd < words; ++wd) {
      unsigned m = w.bits[p * words + wd];  // o is symmetric: i in N(p)
      while (m) {
        const int i = 32 * wd + __ffs(m) - 1;
        m &= m - 1;
        if (sasa_bit(w, words, i, q)) gsum += w.g3[i] + w.g4[i] * w.a[i * nc + p];
      }
    }
    const float rp = __ldg(&atom[kSasaColumns * p + kSasaRadius]);
    const float rq = __ldg(&atom[kSasaColumns * q + kSasaRadius]);
    const float gp = w.g[p];
    const float wpq = gp * __ldg(&atom[kSasaColumns * p + kSasaP2]) + gsum +
                      w.g4[p] * w.b[pq];
    const float dx = w.cx[p] - w.cx[q], dy = w.cy[p] - w.cy[q],
                dz = w.cz[p] - w.cz[q];
    const float dinv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
    // da/dd = k3 / d^2 - k2, and one more 1/d turns it into a factor of
    // the coordinate difference
    const float k3d = kPi * rp * (rp * rp - rq * rq) * dinv;
    w.b[pq] = wpq * (k3d * dinv - kPi * rp) * dinv;
  }
  __syncthreads();

  // E: forces back on the full atom index
  for (int p = tid; p < nc; p += kThreads) {
    const float xp = w.cx[p], yp = w.cy[p], zp = w.cz[p];
    float fx = 0.f, fy = 0.f, fz = 0.f;
    for (int wd = 0; wd < words; ++wd) {
      unsigned m = w.bits[p * words + wd];
      while (m) {
        const int q = 32 * wd + __ffs(m) - 1;
        m &= m - 1;
        const float c = w.b[p * nc + q] + w.b[q * nc + p];
        fx -= c * (xp - w.cx[q]);
        fy -= c * (yp - w.cy[q]);
        fz -= c * (zp - w.cz[q]);
      }
    }
    const int i = __ldg(&idx[p]);
    tx[i] += fx;
    ty[i] += fy;
    tz[i] += fz;
  }
  __syncthreads();
  return e_thread;
}
