// GB-OBC II polar solvation force of one replica whose coordinates sit in
// shared memory: HCT descreening -> psi -> OBC Born radii and dR/dpsi; the
// Still pair force and per-atom dE/dR; the Born self terms; the descreening
// chain rule. The physics lives here once: the standalone GB kernel and the
// campaign kernel both go through gb_born_pass / gb_still_pass /
// gb_chain_pass. No cutoff and no exclusions: all N(N-1)/2 pairs count.
//
// Table layout (ops/gb.py GB_ATOM_COLUMNS), atom[5 * i + c]:
//   c = 0 rho = radius - offset, 1 1/rho, 2 s = screen * rho, 3 1/radius,
//   4 sqrt(k_e) q
// Every thread of a warp reads the same atom[j] while it walks j, so the
// loads are broadcasts out of L1.
//
// Each pass: thread i sums over all j != i in a fixed order (no atomics, the
// same bits every run); a pass ends where the next needs every atom's value,
// and the caller puts the barrier there.
// IEEE 1/sqrtf and divisions, accurate expf/logf/tanhf: far pairs cancel to
// a small remainder in the HCT integral (GB has no cutoff, pairs at 30 A
// count), so the grouping of hct_pair() is that of the plain version and
// must not be rearranged.
#pragma once

struct GbConsts {
  float inv_eps_s;  // 1 / solvent dielectric
  float kappa;      // Debye screening (1/A), 0 = no salt
  float obc_a, obc_b, obc_g;
};

enum GbColumn { kGbRho, kGbRhoInv, kGbS, kGbRadInv, kGbQ, kGbColumns };

// HCT integral I(d) of atom i (rho_i) descreened by j's scaled sphere s_j,
// and with kDeriv its exact piecewise derivative dI/dd.
template <bool kDeriv>
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
  const float ui = 1.0f / up;
  const float li = 1.0f / lo;
  const float s2d = s_j * s_j * dinv;
  const float half_ln_dinv = 0.5f * logf(lo * ui) * dinv;
  const bool inside = dm < -rho_i;  // i wholly inside j's sphere
  const float ui2 = ui * ui;
  const float li2 = li * li;
  const float dsum = ui2 - li2;
  const float dd = d - s2d;
  integral = li - ui + 0.25f * dd * dsum + half_ln_dinv;
  if (inside) integral += 2.0f * (rho_inv_i - li);
  if (kDeriv) {
    const float lop = use_rho ? 0.f : (dm > 0.f ? 1.f : -1.f);  // dlo/dd
    const float w = lop * li;
    const float wli = w * li;
    deriv = ui2 - wli + 0.25f * (1.0f + s2d * dinv) * dsum +
            0.5f * dd * (wli * li - ui2 * ui) +
            (0.5f * (w - ui) - half_ln_dinv) * dinv;
    if (inside) deriv += 2.0f * wli;
  }
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

// Pass 1, atom i: Born radius and dR/dpsi.
__device__ __forceinline__ void gb_born_pass(int i, int n, const float* sx,
                                             const float* sy, const float* sz,
                                             const float* __restrict__ atom,
                                             const GbConsts& c, float& born,
                                             float& dborn_dpsi) {
  const float xi = sx[i], yi = sy[i], zi = sz[i];
  const float rho_i = __ldg(&atom[kGbColumns * i + kGbRho]);
  const float rho_inv_i = __ldg(&atom[kGbColumns * i + kGbRhoInv]);
  const float rad_inv_i = __ldg(&atom[kGbColumns * i + kGbRadInv]);
  float sum = 0.f;
  for (int j = 0; j < n; ++j) {
    if (j == i) continue;
    const float dx = xi - sx[j], dy = yi - sy[j], dz = zi - sz[j];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float dinv = 1.0f / sqrtf(d2);
    float integral, unused;
    hct_pair<false>(d2 * dinv, dinv, rho_i, rho_inv_i,
                    __ldg(&atom[kGbColumns * j + kGbS]), integral, unused);
    sum += integral;
  }
  const float psi = 0.5f * rho_i * sum;
  const float th = tanhf(psi * (c.obc_a + psi * (-c.obc_b + c.obc_g * psi)));
  const float born_inv = rho_inv_i - th * rad_inv_i;
  born = 1.0f / born_inv;
  const float hp = c.obc_a + psi * (-2.0f * c.obc_b + 3.0f * c.obc_g * psi);
  dborn_dpsi = born * born * (1.0f - th * th) * hp * rad_inv_i;
}

// Passes 2 and 3, atom i: the Still pair force on i, and dE/dR_i with the
// Born self term. With kEnergy, e = i's pair energies (each pair counted in
// full: the caller halves the total) + its self energy.
template <bool kEnergy>
__device__ __forceinline__ void gb_still_pass(
    int i, int n, const float* sx, const float* sy, const float* sz,
    const float* sborn, const float* __restrict__ atom, const GbConsts& c,
    float& fx, float& fy, float& fz, float& der, float& e_pair,
    float& e_self) {
  const float xi = sx[i], yi = sy[i], zi = sz[i];
  const float bi = sborn[i];
  const float bi_inv = 1.0f / bi;
  const float qi = __ldg(&atom[kGbColumns * i + kGbQ]);
  fx = fy = fz = 0.f;
  der = 0.f;
  e_pair = 0.f;
  for (int j = 0; j < n; ++j) {
    if (j == i) continue;
    const float dx = xi - sx[j], dy = yi - sy[j], dz = zi - sz[j];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float bj = sborn[j];
    const float qs = 0.25f * d2;
    const float bb = bi * bj;
    const float ex = expf(-qs / bb);
    const float f2 = d2 + bb * ex;
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
    if (kEnergy) e_pair -= gqq * u;
  }
  float u, du;
  still_u(bi, bi_inv, c, u, du);
  der -= 0.5f * qi * qi * du;
  e_self = kEnergy ? -0.5f * qi * qi * u : 0.f;
}

// Pass 4, atom i: the descreening chain-rule force. sce[j] holds
// dE/dR_j * dR_j/dpsi_j * rho_j / 2 of every atom. dI/dd is evaluated here
// again for both directions of the pair rather than cached per pair.
__device__ __forceinline__ void gb_chain_pass(
    int i, int n, const float* sx, const float* sy, const float* sz,
    const float* sce, const float* __restrict__ atom, float& fx, float& fy,
    float& fz) {
  const float xi = sx[i], yi = sy[i], zi = sz[i];
  const float rho_i = __ldg(&atom[kGbColumns * i + kGbRho]);
  const float rho_inv_i = __ldg(&atom[kGbColumns * i + kGbRhoInv]);
  const float s_i = __ldg(&atom[kGbColumns * i + kGbS]);
  const float ce_i = sce[i];
  fx = fy = fz = 0.f;
  for (int j = 0; j < n; ++j) {
    if (j == i) continue;
    const float dx = xi - sx[j], dy = yi - sy[j], dz = zi - sz[j];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float dinv = 1.0f / sqrtf(d2);
    const float d = d2 * dinv;
    float unused, di_f, di_r;
    hct_pair<true>(d, dinv, rho_i, rho_inv_i,
                   __ldg(&atom[kGbColumns * j + kGbS]), unused, di_f);
    hct_pair<true>(d, dinv, __ldg(&atom[kGbColumns * j + kGbRho]),
                   __ldg(&atom[kGbColumns * j + kGbRhoInv]), s_i, unused,
                   di_r);
    const float coeff = (ce_i * di_f + sce[j] * di_r) * dinv;
    fx -= coeff * dx;
    fy -= coeff * dy;
    fz -= coeff * dz;
  }
}

// The whole GB force of the replica in shared memory, added to (tx, ty, tz).
// sborn and sce are n floats of scratch each. Expects a barrier before
// (coordinates complete) and leaves one behind.
template <int kThreads>
__device__ __forceinline__ void gb_forces_add(
    int n, const float* sx, const float* sy, const float* sz, float* sborn,
    float* sce, const float* __restrict__ atom, const GbConsts& c, float* tx,
    float* ty, float* tz) {
  const int tid = threadIdx.x;
  for (int i = tid; i < n; i += kThreads) {
    float born, dbdpsi;
    gb_born_pass(i, n, sx, sy, sz, atom, c, born, dbdpsi);
    sborn[i] = born;
    sce[i] = dbdpsi;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    float fx, fy, fz, der, e_pair, e_self;
    gb_still_pass<false>(i, n, sx, sy, sz, sborn, atom, c, fx, fy, fz, der,
                         e_pair, e_self);
    tx[i] += fx;
    ty[i] += fy;
    tz[i] += fz;
    // no other thread reads sce before the barrier below
    sce[i] = der * sce[i] * (0.5f * __ldg(&atom[kGbColumns * i + kGbRho]));
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    float fx, fy, fz;
    gb_chain_pass(i, n, sx, sy, sz, sce, atom, fx, fy, fz);
    tx[i] += fx;
    ty[i] += fy;
    tz[i] += fz;
  }
  __syncthreads();
}
