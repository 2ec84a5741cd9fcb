// Every 2-body term of the force field, for one pair: reaction-field Coulomb
// and cubic-switched LJ 12-6 under the cutoff mask, harmonic bond /
// Urey-Bradley springs k (d - d0)^2, and pre-scaled 1-4 LJ + plain Coulomb.
// The physics lives here once: every pair kernel (campaign, pair-forces,
// pair-tile and dense-row) calls pair_term() from the loops of pair_loop.cuh,
// with parameters from the per-atom layout built by ops/nonbonded.py
// pair_layout.
#pragma once

struct PairConsts {
  float cutoff2;          // cutoff^2 (1e30 = none)
  float krf, crf;         // reaction field (0, 0 = plain Coulomb)
  float switch_dist;      // LJ switch-on distance (1e15 = none)
  float inv_switch_span;  // 1 / (cutoff - switch_dist)
};

// One pair at squared distance d2: F_i = -coeff * (r_i - r_j), and pot is
// the pair's full energy. kSpecial = false skips the bond and 1-4 lines for
// a plain pair (kb = a14 = b14 = qq14 = 0): they add exact zeros there, which
// the compiler may not drop (0 * x is not 0 for an infinite x).
template <bool kEnergy, bool kSpecial = true>
__device__ __forceinline__ void pair_term(
    float d2, float qq, float aa, float bb, float msym, float kb, float d0,
    float a14, float b14, float qq14, const PairConsts& c, float& coeff,
    float& pot) {
  const bool mb = kb > 0.f;
  const float m = (d2 <= c.cutoff2) ? msym : 0.f;
  // a masked pair never divides by zero: its distance is replaced by 1
  const bool live = (m > 0.f) || mb || (qq14 != 0.f) || (a14 != 0.f);
  const float safe = live ? d2 : 1.f;
  // IEEE division and square root, not the 2-ulp rsqrtf: stiff bonds and
  // r^-13 turn a relative error of rinv into kcal/mol/A
  const float rinv = 1.0f / sqrtf(safe);
  const float rinv2 = rinv * rinv;
  const float d = safe * rinv;  // == sqrt(d2) where live, 1 where masked

  // cutoff nonbonded: reaction-field Coulomb + switched LJ
  const float coeff_e = qq * (2.f * c.krf - rinv2 * rinv);
  const float rinv6 = rinv2 * rinv2 * rinv2;
  const float a12 = aa * rinv6 * rinv6;
  const float b6 = bb * rinv6;
  float pot_l = a12 - b6;
  const float dudr = (6.f * b6 - 12.f * a12) * rinv;
  const float t = (d - c.switch_dist) * c.inv_switch_span;
  const float sw = 1.f + t * t * t * (-10.f + t * (15.f - t * 6.f));
  const float dsw = t * t * (-30.f + t * (60.f - t * 30.f)) * c.inv_switch_span;
  const bool on = d > c.switch_dist;
  const float coeff_l = on ? (dudr * sw + pot_l * dsw) * rinv : dudr * rinv;
  coeff = m * (coeff_e + coeff_l);

  // harmonic bond / Urey-Bradley pairs: E = k (d - d0)^2
  const float delta = d - d0;
  if (kSpecial && mb) coeff += 2.f * kb * delta * rinv;

  // 1-4 scaled LJ + plain Coulomb
  const float a14_12 = a14 * rinv6 * rinv6;
  const float b14_6 = b14 * rinv6;
  if (kSpecial)
    coeff += (6.f * b14_6 - 12.f * a14_12) * rinv2 - qq14 * rinv2 * rinv;

  if (kEnergy) {
    const float pot_e = qq * (rinv + c.krf * d2 - c.crf);
    if (on) pot_l *= sw;
    pot = m * (pot_e + pot_l);
    if (kSpecial && mb) pot += kb * delta * delta;
    if (kSpecial) pot += a14_12 - b14_6 + qq14 * rinv;
  }
}
