// GB-OBC II polar solvation force of one replica whose coordinates sit in
// shared memory: HCT descreening -> psi -> OBC Born radii and dR/dpsi; the
// Still pair force and per-atom dE/dR; the Born self terms; the descreening
// chain rule. The physics lives here once: the standalone GB kernel and the
// campaign kernel both go through gb_forces_add(). No cutoff and no
// exclusions: all N(N-1)/2 pairs count.
//
// Table layout (ops/gb.py GB_ATOM_COLUMNS), atom[5 * i + c]:
//   c = 0 rho = radius - offset, 1 1/rho, 2 s = screen * rho, 3 1/radius,
//   4 sqrt(k_e) q
//
// Passes, a barrier after each (no atomics: every sum is taken in a fixed
// order, so a launch gives the same bits every run):
//   Born   every ordered pair once: the HCT integral I_ij and its derivative
//          in one evaluation; psi_i from the integrals, and dI_ij/dd / d
//          kept in a shared cache of N(N-1) floats for the chain pass.
//   Still  every ordered pair: the Still force on i and dE/dR_i, each pair
//          seen from both ends, then the Born self term and the chain
//          cotangent of i. (Once per unordered pair, on a ring whose
//          partner halves cross through shared memory, it took the same
//          time: chip_smoke.py's levers.)
//   chain  every ordered pair from the cache: a multiply-add per direction.
// In every pass kGbLanes lanes share atom i's partners and meet in a
// butterfly.
// IEEE 1/sqrtf, accurate expf/logf/tanhf: far pairs cancel to a small
// remainder in the HCT integral (GB has no cutoff, pairs at 30 A count), so
// the grouping of hct_pair() is that of the plain version and must not be
// rearranged. Its two reciprocals 1/(d + s_j) and 1/lo are the SFU's (about
// 1 ulp; __fdividef): that moved K3 from 1.5e-5 to 2.0e-5 kcal/mol/A of the
// plain float32 forces, against a tolerance of 5e-4, and saves about 4 % of
// K3 and 1 % of a GBIS campaign launch on an H100 (chip_smoke.py's levers).
#pragma once

#include <cstddef>

#include "lane_groups.cuh"

struct GbConsts {
  float inv_eps_s;  // 1 / solvent dielectric
  float kappa;      // Debye screening (1/A), 0 = no salt
  float obc_a, obc_b, obc_g;
};

enum GbColumn { kGbRho, kGbRhoInv, kGbS, kGbRadInv, kGbQ, kGbColumns };

// Lanes that share one atom's partners: at N = 104, 16 of them keep 1,664
// lanes busy, 6.5 rounds of 256 threads.
constexpr int kGbLanes = 16;

// Row stride of the dI cache: odd, so that a column read (atom j's entry
// for i, j over the lanes) hits distinct banks.
__host__ __device__ inline int gb_cache_stride(int n) { return (n - 1) | 1; }

// Floats of shared memory the GB passes need beside the coordinates and
// forces (ops/gb.py gb_shared_bytes says the same).
__host__ __device__ inline size_t gb_shared_floats(int n) {
  return 3 * static_cast<size_t>(n) +
         static_cast<size_t>(n) * gb_cache_stride(n);
}

struct GbShared {
  float* born;   // R_i
  float* binv;   // 1 / R_i
  float* ce;     // dR_i/dpsi_i, then the chain cotangent
  float* cache;  // dI_ij/dd / d: row i, column j (j > i one to the left)
};

__device__ __forceinline__ GbShared gb_carve(float* p, int n) {
  GbShared w;
  w.born = p; p += n;
  w.binv = p; p += n;
  w.ce = p; p += n;
  w.cache = p;
  return w;
}

// HCT integral I(d) of atom i (rho_i) descreened by j's scaled sphere s_j,
// and its exact piecewise derivative dI/dd.
__device__ __forceinline__ void hct_pair(float d, float dinv, float rho_i,
                                         float rho_inv_i, float s_j,
                                         float& integral, float& deriv) {
  integral = 0.f;
  deriv = 0.f;
  const float up = d + s_j;
  if (!(rho_i < up)) return;  // the sphere does not reach past rho_i
  const float dm = d - s_j;
  const float ad = fabsf(dm);
  const bool use_rho = ad < rho_i;
  const float lo = use_rho ? rho_i : ad;
  const float ui = __fdividef(1.0f, up);
  const float li = __fdividef(1.0f, lo);
  const float s2d = s_j * s_j * dinv;
  const float half_ln_dinv = 0.5f * logf(lo * ui) * dinv;
  const bool inside = dm < -rho_i;  // i wholly inside j's sphere
  const float ui2 = ui * ui;
  const float li2 = li * li;
  const float dsum = ui2 - li2;
  const float dd = d - s2d;
  integral = li - ui + 0.25f * dd * dsum + half_ln_dinv;
  if (inside) integral += 2.0f * (rho_inv_i - li);
  const float lop = use_rho ? 0.f : (dm > 0.f ? 1.f : -1.f);  // dlo/dd
  const float w = lop * li;
  const float wli = w * li;
  deriv = ui2 - wli + 0.25f * (1.0f + s2d * dinv) * dsum +
          0.5f * dd * (wli * li - ui2 * ui) +
          (0.5f * (w - ui) - half_ln_dinv) * dinv;
  if (inside) deriv += 2.0f * wli;
}

// u(f) = (1 - exp(-kappa f) / eps_s) / f and du/df.
__device__ __forceinline__ void still_u(float f, float finv,
                                        const GbConsts& c, float& u,
                                        float& du) {
  if (c.kappa > 0.f) {
    const float es = c.inv_eps_s * expf(-c.kappa * f);
    u = (1.0f - es) * finv;
    du = (es * (1.0f + c.kappa * f) - 1.0f) * finv * finv;
  } else {
    u = (1.0f - c.inv_eps_s) * finv;
    du = (c.inv_eps_s - 1.0f) * finv * finv;
  }
}

__device__ __forceinline__ int gb_cache_index(int i, int j, int stride) {
  return i * stride + j - (j > i);
}

// Born pass: R_i, 1/R_i, dR_i/dpsi_i, and the dI cache.
template <int kThreads>
__device__ __forceinline__ void gb_born_pass(int n, const float* sx,
                                             const float* sy, const float* sz,
                                             const float* __restrict__ atom,
                                             const GbConsts& c,
                                             const GbShared& w) {
  const int stride = gb_cache_stride(n);
  for (int base = 0; base < n * kGbLanes; base += kThreads) {
    const int k = base + static_cast<int>(threadIdx.x);
    const int i = k / kGbLanes, g = k % kGbLanes;
    float sum = 0.f;
    if (i < n) {
      const float xi = sx[i], yi = sy[i], zi = sz[i];
      const float rho_i = __ldg(&atom[kGbColumns * i + kGbRho]);
      const float rho_inv_i = __ldg(&atom[kGbColumns * i + kGbRhoInv]);
      for (int j = g; j < n; j += kGbLanes) {
        if (j == i) continue;
        const float dx = xi - sx[j], dy = yi - sy[j], dz = zi - sz[j];
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float dinv = 1.0f / sqrtf(d2);
        float integral, deriv;
        hct_pair(d2 * dinv, dinv, rho_i, rho_inv_i,
                 __ldg(&atom[kGbColumns * j + kGbS]), integral, deriv);
        sum += integral;
        w.cache[gb_cache_index(i, j, stride)] = deriv * dinv;
      }
    }
    sum = group_sum<kGbLanes>(sum);
    if (i < n && g == 0) {
      const float rho_i = __ldg(&atom[kGbColumns * i + kGbRho]);
      const float rho_inv_i = __ldg(&atom[kGbColumns * i + kGbRhoInv]);
      const float rad_inv_i = __ldg(&atom[kGbColumns * i + kGbRadInv]);
      const float psi = 0.5f * rho_i * sum;
      const float th =
          tanhf(psi * (c.obc_a + psi * (-c.obc_b + c.obc_g * psi)));
      const float born_inv = rho_inv_i - th * rad_inv_i;
      const float born = 1.0f / born_inv;
      const float hp = c.obc_a + psi * (-2.0f * c.obc_b + 3.0f * c.obc_g * psi);
      w.born[i] = born;
      w.binv[i] = born_inv;
      w.ce[i] = born * born * (1.0f - th * th) * hp * rad_inv_i;
    }
  }
}

// Still pass: the Still pair force added to (tx, ty, tz), and the chain
// cotangent dE/dR_i * dR_i/dpsi_i * rho_i / 2 left in w.ce. With kEnergy
// returns this thread's share of the pair and self energies.
template <int kThreads, bool kEnergy>
__device__ __forceinline__ float gb_still_pass(
    int n, const float* sx, const float* sy, const float* sz,
    const float* __restrict__ atom, const GbConsts& c, const GbShared& w,
    float* tx, float* ty, float* tz) {
  float e_thread = 0.f;
  for (int base = 0; base < n * kGbLanes; base += kThreads) {
    const int k = base + static_cast<int>(threadIdx.x);
    const int i = k / kGbLanes, g = k % kGbLanes;
    float fx = 0.f, fy = 0.f, fz = 0.f, der = 0.f;
    if (i < n) {
      const float xi = sx[i], yi = sy[i], zi = sz[i];
      const float bi = w.born[i], bi_inv = w.binv[i];
      const float qi = __ldg(&atom[kGbColumns * i + kGbQ]);
      for (int j = g; j < n; j += kGbLanes) {
        if (j == i) continue;
        const float dx = xi - sx[j], dy = yi - sy[j], dz = zi - sz[j];
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float bj = w.born[j];
        const float qs = 0.25f * d2;
        const float ex = expf(-qs * (bi_inv * w.binv[j]));
        const float f2 = d2 + bi * bj * ex;
        const float finv = 1.0f / sqrtf(f2);
        float u, du;
        still_u(f2 * finv, finv, c, u, du);
        const float gqq = qi * __ldg(&atom[kGbColumns * j + kGbQ]);
        const float nqu = -gqq * du;
        const float coeff = nqu * (1.0f - 0.25f * ex) * finv;
        fx -= coeff * dx;
        fy -= coeff * dy;
        fz -= coeff * dz;
        der += nqu * (bj + qs * bi_inv) * (0.5f * ex * finv);
        if (kEnergy) e_thread -= 0.5f * gqq * u;  // each pair is seen twice
      }
    }
    fx = group_sum<kGbLanes>(fx);
    fy = group_sum<kGbLanes>(fy);
    fz = group_sum<kGbLanes>(fz);
    der = group_sum<kGbLanes>(der);
    if (i < n && g == 0) {
      tx[i] += fx;
      ty[i] += fy;
      tz[i] += fz;
      // the Born self term, then the chain cotangent
      const float qi = __ldg(&atom[kGbColumns * i + kGbQ]);
      float u, du;
      still_u(w.born[i], w.binv[i], c, u, du);
      der -= 0.5f * qi * qi * du;
      w.ce[i] = der * w.ce[i] * (0.5f * __ldg(&atom[kGbColumns * i + kGbRho]));
      if (kEnergy) e_thread -= 0.5f * qi * qi * u;
    }
  }
  return e_thread;
}

// Chain pass: the descreening chain-rule force of every ordered pair from
// the cache, added to (tx, ty, tz).
template <int kThreads>
__device__ __forceinline__ void gb_chain_pass(int n, const float* sx,
                                              const float* sy, const float* sz,
                                              const GbShared& w, float* tx,
                                              float* ty, float* tz) {
  const int stride = gb_cache_stride(n);
  for (int base = 0; base < n * kGbLanes; base += kThreads) {
    const int k = base + static_cast<int>(threadIdx.x);
    const int i = k / kGbLanes, g = k % kGbLanes;
    float fx = 0.f, fy = 0.f, fz = 0.f;
    if (i < n) {
      const float xi = sx[i], yi = sy[i], zi = sz[i];
      const float ce_i = w.ce[i];
      for (int j = g; j < n; j += kGbLanes) {
        if (j == i) continue;
        const float coeff = ce_i * w.cache[gb_cache_index(i, j, stride)] +
                            w.ce[j] * w.cache[gb_cache_index(j, i, stride)];
        fx -= coeff * (xi - sx[j]);
        fy -= coeff * (yi - sy[j]);
        fz -= coeff * (zi - sz[j]);
      }
    }
    fx = group_sum<kGbLanes>(fx);
    fy = group_sum<kGbLanes>(fy);
    fz = group_sum<kGbLanes>(fz);
    if (i < n && g == 0) {
      tx[i] += fx;
      ty[i] += fy;
      tz[i] += fz;
    }
  }
}

// The whole GB force of the replica in shared memory, added to (tx, ty, tz);
// w is gb_shared_floats(n) floats of scratch (gb_carve). Expects a barrier
// before (coordinates complete) and leaves one behind. With kEnergy returns
// this thread's share of the GB energy.
template <int kThreads, bool kEnergy>
__device__ __forceinline__ float gb_forces_add(
    int n, const float* sx, const float* sy, const float* sz,
    const float* __restrict__ atom, const GbConsts& c, const GbShared& w,
    float* tx, float* ty, float* tz) {
  gb_born_pass<kThreads>(n, sx, sy, sz, atom, c, w);
  __syncthreads();
  const float e =
      gb_still_pass<kThreads, kEnergy>(n, sx, sy, sz, atom, c, w, tx, ty, tz);
  __syncthreads();
  gb_chain_pass<kThreads>(n, sx, sy, sz, w, tx, ty, tz);
  __syncthreads();
  return e;
}
