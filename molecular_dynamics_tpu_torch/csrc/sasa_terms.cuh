// LCPO nonpolar solvation force of one replica whose coordinates sit in
// shared memory, on the compact heavy-atom set (atoms with a nonzero SASA
// radius). The physics lives here once: the standalone SASA kernel and the
// campaign kernel both go through sasa_forces_add().
//
// Table layout (ops/sasa.py): idx[p] = atom index of compact atom p;
// atom[5 * p + c], c = 0 probe-inflated radius r_p, 1 a0 = P1 4 pi r^2,
// 2 P2, 3 P3, 4 P4.
//
// N(p), the overlapping neighbours of p (|r_p - r_q| < d < r_p + r_q), is
// kept twice: as row p's bit mask, and as row p's neighbour list, q in
// ascending order, at most sasa_capacity(nc) entries, each with the buried
// areas a_pq = 2 pi r_p (r_p - d/2 - (r_p^2 - r_q^2) / 2d) and a_qp. Passes,
// a barrier after each:
//   A  a warp per row: the overlap test of 32 candidates at once, the mask
//      word from a ballot, each hit's list slot from a prefix count of the
//      ballot (ascending q). A row with more neighbours than the capacity
//      sets the overflow flag, and the pass stops there: the caller's force
//      is left as it was and the wrapper raises.
//   S  row offsets of the lists (an exclusive scan), so that B and D run over
//      the listed pairs only, one lane a pair
//   B  B_pq = sum_{k in N(p) and N(q)} a_qk: the AND of the two rows' mask
//      words, walked bit by bit; a_qk's slot in q's list is a prefix count
//   C  per atom: area A_p = a0 + sum_{q in N(p)} [P2 a_pq + (P3 + P4 a_pq)
//      B_pq], gate g_p = gamma where A_p > 0 else 0 (the relu of
//      sum max(A, 0); the cotangent below is valid only with it)
//   D  W_pq = dE/da_pq = g_p P2_p + sum_{i in N(p) and N(q)} g_i (P3_i +
//      P4_i a_ip) + g_p P4_p B_pq over the same AND, and c_pq = W_pq da/dd /
//      d written over B_pq
//   E  per atom: F_p = -sum_{q in N(p)} (c_pq + c_qp) (r_p - r_q), added to
//      the caller's force at idx[p]
// C and E give each row kSasaLanes lanes. No atomics: every sum is a gather
// in a fixed order, so a launch gives the same bits every run.
#pragma once

#include <cstddef>

#include "lane_groups.cuh"

// The most neighbours a list holds. At most nc - 1 exist, so below 65 heavy
// atoms a list cannot overflow; above, an atom with more overlapping heavy
// atoms raises (ops/sasa.py SASA_MAX_NEIGHBOURS says the same).
constexpr int kSasaMaxNeighbours = 64;
// Lanes that share one row's list in passes C and E.
constexpr int kSasaLanes = 8;

struct SasaShared {
  float* a;   // per list entry: a_pq
  float* at;  // a_qp
  float* b;   // B_pq, then c_pq in place
  float *cx, *cy, *cz;   // compact coordinates
  float *g, *g3, *g4;    // g_p, g_p P3_p, g_p P4_p
  unsigned* bits;        // nc * words: overlap masks
  int* wbase;            // nc * words: list slots in a row's earlier words
  int* cnt;              // nc: neighbours of each row
  int* rowptr;           // nc + 1: the rows' offsets among the listed pairs
  int* overflow;         // 1: a row has more neighbours than the capacity
  unsigned short* nbr;   // per list entry: q
};

enum SasaColumn { kSasaRadius, kSasaA0, kSasaP2, kSasaP3, kSasaP4, kSasaColumns };

__host__ __device__ inline int sasa_words(int nc) { return (nc + 31) / 32; }

__host__ __device__ inline int sasa_capacity(int nc) {
  return nc < 1 ? 0 : (nc - 1 < kSasaMaxNeighbours ? nc - 1 : kSasaMaxNeighbours);
}

// 32-bit words of shared memory the pass needs (ops/sasa.py
// sasa_shared_bytes says the same).
__host__ __device__ inline size_t sasa_shared_words(int nc) {
  const size_t n = nc, cap = sasa_capacity(nc), words = sasa_words(nc);
  return 3 * n * cap + 6 * n + 2 * n * words + 2 * n + 2 + (n * cap + 1) / 2;
}

__device__ __forceinline__ SasaShared sasa_carve(float* p, int nc) {
  const int cap = sasa_capacity(nc), words = sasa_words(nc);
  SasaShared w;
  w.a = p; p += nc * cap;
  w.at = p; p += nc * cap;
  w.b = p; p += nc * cap;
  w.cx = p; p += nc; w.cy = p; p += nc; w.cz = p; p += nc;
  w.g = p; p += nc; w.g3 = p; p += nc; w.g4 = p; p += nc;
  w.bits = reinterpret_cast<unsigned*>(p); p += nc * words;
  w.wbase = reinterpret_cast<int*>(p); p += nc * words;
  w.cnt = reinterpret_cast<int*>(p); p += nc;
  w.rowptr = reinterpret_cast<int*>(p); p += nc + 1;
  w.overflow = reinterpret_cast<int*>(p); p += 1;
  w.nbr = reinterpret_cast<unsigned short*>(p);
  return w;
}

__device__ __forceinline__ unsigned below(int bit) {
  return (1u << bit) - 1u;
}

// The row p and list entry of listed pair e (rowptr[p] <= e < rowptr[p+1]).
__device__ __forceinline__ int sasa_row_of(const SasaShared& w, int nc, int e) {
  int lo = 0, hi = nc;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (w.rowptr[mid] <= e) lo = mid; else hi = mid;
  }
  return lo;
}

// The LCPO force of the replica whose coordinates are (sx, sy, sz), added to
// (tx, ty, tz). Returns this thread's share of the energy gamma * sum
// max(A_p, 0) when kEnergy. Expects a barrier before (coordinates complete)
// and leaves one behind. On a list overflow sets *overflow_out to 1 and adds
// nothing.
template <int kThreads, bool kEnergy>
__device__ __forceinline__ float sasa_forces_add(
    int nc, const int* __restrict__ idx, const float* __restrict__ atom,
    float gamma, const float* sx, const float* sy, const float* sz,
    const SasaShared& w, float* tx, float* ty, float* tz, int* overflow_out) {
  constexpr float kPi = 3.14159265358979323846f;
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int words = sasa_words(nc), cap = sasa_capacity(nc);
  float e_thread = 0.f;

  for (int p = tid; p < nc; p += kThreads) {
    const int i = __ldg(&idx[p]);
    w.cx[p] = sx[i];
    w.cy[p] = sy[i];
    w.cz[p] = sz[i];
  }
  if (tid == 0) *w.overflow = 0;
  __syncthreads();

  // A: a warp per row, 32 candidates a ballot
  for (int p = warp; p < nc; p += kWarps) {
    const float rp = __ldg(&atom[kSasaColumns * p + kSasaRadius]);
    const float xp = w.cx[p], yp = w.cy[p], zp = w.cz[p];
    const float k1 = 2.0f * kPi * rp * rp, k2 = kPi * rp;
    int count = 0;
    for (int wd = 0; wd < words; ++wd) {
      const int q = 32 * wd + lane;
      bool hit = false;
      float a = 0.f, at = 0.f;
      if (q < nc && q != p) {
        const float rq = __ldg(&atom[kSasaColumns * q + kSasaRadius]);
        const float dx = xp - w.cx[q], dy = yp - w.cy[q], dz = zp - w.cz[q];
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 > 0.f) {
          const float dinv = 1.0f / sqrtf(d2);
          const float d = d2 * dinv;
          if (d < rp + rq && d > fabsf(rp - rq)) {
            hit = true;
            a = k1 - k2 * d - kPi * rp * (rp * rp - rq * rq) * dinv;
            // as row q's own pass would compute it
            at = 2.0f * kPi * rq * rq - kPi * rq * d -
                 kPi * rq * (rq * rq - rp * rp) * dinv;
          }
        }
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) {
        w.bits[p * words + wd] = mask;
        w.wbase[p * words + wd] = count;
      }
      const int slot = count + __popc(mask & below(lane));
      if (hit && slot < cap) {
        const int e = p * cap + slot;
        w.nbr[e] = static_cast<unsigned short>(q);
        w.a[e] = a;
        w.at[e] = at;
      }
      count += __popc(mask);
    }
    if (lane == 0) {
      w.cnt[p] = count;
      if (count > cap) *w.overflow = 1;
    }
  }
  __syncthreads();
  if (*w.overflow) {  // the same for every thread: no list is whole
    if (tid == 0) *overflow_out = 1;
    __syncthreads();
    return 0.f;
  }

  // S: row offsets, one warp
  if (warp == 0) {
    int carry = 0;
    for (int p0 = 0; p0 < nc; p0 += 32) {
      const int p = p0 + lane;
      int v = p < nc ? w.cnt[p] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      if (p < nc) w.rowptr[p + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) w.rowptr[0] = 0;
  }
  __syncthreads();
  const int total = w.rowptr[nc];

  // B: B_pq = sum_{k in N(p) and N(q)} a_qk, one lane a listed pair
  for (int e = tid; e < total; e += kThreads) {
    const int p = sasa_row_of(w, nc, e);
    const int ent = p * cap + e - w.rowptr[p];
    const int q = w.nbr[ent];
    float sum = 0.f;
    for (int wd = 0; wd < words; ++wd) {
      const unsigned mq = w.bits[q * words + wd];
      unsigned m = w.bits[p * words + wd] & mq;
      const float* aq = w.a + q * cap + w.wbase[q * words + wd];
      while (m) {
        const int bit = __ffs(m) - 1;
        m &= m - 1;
        sum += aq[__popc(mq & below(bit))];
      }
    }
    w.b[ent] = sum;
  }
  __syncthreads();

  // C: areas and gates, kSasaLanes lanes a row
  for (int base = 0; base < nc * kSasaLanes; base += kThreads) {
    const int k = base + tid;
    const int p = k / kSasaLanes, g = k % kSasaLanes;
    float sum = 0.f;
    if (p < nc) {
      const float p2 = __ldg(&atom[kSasaColumns * p + kSasaP2]);
      const float p3 = __ldg(&atom[kSasaColumns * p + kSasaP3]);
      const float p4 = __ldg(&atom[kSasaColumns * p + kSasaP4]);
      for (int slot = g; slot < w.cnt[p]; slot += kSasaLanes) {
        const int ent = p * cap + slot;
        const float a = w.a[ent];
        sum += p2 * a + (p3 + p4 * a) * w.b[ent];
      }
    }
    sum = group_sum<kSasaLanes>(sum);
    if (p < nc && g == 0) {
      const float area = __ldg(&atom[kSasaColumns * p + kSasaA0]) + sum;
      const float gate = area > 0.f ? gamma : 0.f;
      w.g[p] = gate;
      w.g3[p] = gate * __ldg(&atom[kSasaColumns * p + kSasaP3]);
      w.g4[p] = gate * __ldg(&atom[kSasaColumns * p + kSasaP4]);
      if (kEnergy) e_thread += gate * area;
    }
  }
  __syncthreads();

  // D: cotangent W_pq and the pair's force factor c_pq over B_pq
  for (int e = tid; e < total; e += kThreads) {
    const int p = sasa_row_of(w, nc, e);
    const int ent = p * cap + e - w.rowptr[p];
    const int q = w.nbr[ent];
    float gsum = 0.f;
    for (int wd = 0; wd < words; ++wd) {
      const unsigned mp = w.bits[p * words + wd];
      unsigned m = mp & w.bits[q * words + wd];  // o is symmetric: i in N(p)
      const float* atp = w.at + p * cap + w.wbase[p * words + wd];
      while (m) {
        const int bit = __ffs(m) - 1;
        m &= m - 1;
        const int i = 32 * wd + bit;
        gsum += w.g3[i] + w.g4[i] * atp[__popc(mp & below(bit))];  // a_ip
      }
    }
    const float rp = __ldg(&atom[kSasaColumns * p + kSasaRadius]);
    const float rq = __ldg(&atom[kSasaColumns * q + kSasaRadius]);
    const float wpq = w.g[p] * __ldg(&atom[kSasaColumns * p + kSasaP2]) +
                      gsum + w.g4[p] * w.b[ent];
    const float dx = w.cx[p] - w.cx[q], dy = w.cy[p] - w.cy[q],
                dz = w.cz[p] - w.cz[q];
    const float dinv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
    // da/dd = k3 / d^2 - k2, and one more 1/d turns it into a factor of
    // the coordinate difference
    const float k3d = kPi * rp * (rp * rp - rq * rq) * dinv;
    w.b[ent] = wpq * (k3d * dinv - kPi * rp) * dinv;
  }
  __syncthreads();

  // E: forces back on the full atom index, kSasaLanes lanes a row
  for (int base = 0; base < nc * kSasaLanes; base += kThreads) {
    const int k = base + tid;
    const int p = k / kSasaLanes, g = k % kSasaLanes;
    float fx = 0.f, fy = 0.f, fz = 0.f;
    if (p < nc) {
      const float xp = w.cx[p], yp = w.cy[p], zp = w.cz[p];
      const int wd = p >> 5;
      for (int slot = g; slot < w.cnt[p]; slot += kSasaLanes) {
        const int ent = p * cap + slot;
        const int q = w.nbr[ent];
        // c_qp: row q's entry for p
        const int back = w.wbase[q * words + wd] +
                         __popc(w.bits[q * words + wd] & below(p & 31));
        const float cs = w.b[ent] + w.b[q * cap + back];
        fx -= cs * (xp - w.cx[q]);
        fy -= cs * (yp - w.cy[q]);
        fz -= cs * (zp - w.cz[q]);
      }
    }
    fx = group_sum<kSasaLanes>(fx);
    fy = group_sum<kSasaLanes>(fy);
    fz = group_sum<kSasaLanes>(fz);
    if (p < nc && g == 0) {
      const int i = __ldg(&idx[p]);
      tx[i] += fx;
      ty[i] += fy;
      tz[i] += fz;
    }
  }
  __syncthreads();
  return e_thread;
}
