// Campaign kernel: n_inner BAOAB Langevin steps of every replica in one
// launch, with positions, velocities and forces resident in shared memory.
//
// Replaces: molecular_dynamics_tpu/ops/fused_step.py make_fused_campaign_op
// -> kernel (step_body, forces, shake, rattle, gaussians, and the gb_every /
// sasa_every cadence blocks); the implicit-solvent passes it calls are in
// gb_terms.cuh and sasa_terms.cuh.
// Bound on an H100: float32 arithmetic, not memory. Global memory sees the
// state once at entry and once at exit (9*N floats each way per replica)
// and small tables (per-atom pair parameters, bonded lists) that stay in
// L1/L2, while each of the n_inner steps needs N*(N-1)/2 pair tests and ~70
// flops for each pair inside the cutoff, plus the bonded terms and 21
// constraint sweeps (2 SHAKE of 6, 3 RATTLE of 3).
// Design: one CTA per replica (128, 512 or 1024 threads by size, 256 with
// GB or LCPO). Per step, in the order of the reference's step_body:
// half kick -> RATTLE -> half drift -> SHAKE -> O-step -> RATTLE -> half
// drift -> SHAKE -> forces at t0 + i -> half kick -> RATTLE. Forces: the
// pair loop of pair_loop.cuh (each unordered pair once, 32-atom chunks met
// warp by warp, far chunk pairs skipped, parameters from per-atom arrays;
// special pairs from per-atom lists), angles (thread per angle), dihedrals
// and impropers together (thread per torsion, up to max_t terms, AMBER where
// per > 0 else CHARMM with the 2 pi wrap), the moving SMD bias.
// Scatters are gathers: a bonded term or a constraint writes its 3-vectors
// into a shared buffer, and after a barrier each atom sums its own entries
// through a per-atom (CSR) list in a fixed order. No atomics anywhere, so a
// launch gives the same bits every run, and cutting n_inner steps into
// several launches gives the same bits as one launch. SHAKE and RATTLE are
// Jacobi sweeps: every constraint reads the same iterate, a barrier, then
// all corrections are added (on one warp with __syncwarp instead, a launch
// took 30 % longer in vacuum and 12 % under GBIS: chip_smoke.py's levers).
// Noise: Philox4x32-10 keyed on (seed, replica, t0 + i, atom), philox.cuh.
// Implicit solvent (use_gb, n_sasa): the GB-OBC II and LCPO forces are added
// to the per-step force by the device functions the standalone kernels use.
// Their cadences follow the reference step for step. sasa_every = k > 1
// (held force): the LCPO force is evaluated at the entry positions of each
// k-step block and added unchanged to every force evaluation of the block;
// the carried force stays the total. gb_every = k > 1 (impulse, Verlet-I):
// the slow force (GB, and LCPO when its cadence is k too) is evaluated once
// a block and enters as velocity kicks of k dt / 2 at the block's ends, each
// followed by RATTLE; inside the block the per-step force is the fast one.
// The carried force is the total at launch entry and exit: the slow part is
// taken off on the way in and put back on the way out.
// Shared memory: the state (9 N floats), the pair loop's chunk boxes and the
// slow force of a block stay for the whole launch; the bonded and constraint buffers, the GB scratch
// (its dI cache is most of it) and the LCPO scratch are never live at the
// same time, so they share one region, as large as the largest of them. At
// N = 104 under GBIS that keeps a CTA at 46.8 KB (48.0 with a cadence), so
// that 4 CTAs fit an SM: 1024 replicas fill 528 slots in 1.94 waves.
#include <cstdint>
#include <cuda_runtime.h>

#include "gb_terms.cuh"
#include "pair_loop.cuh"
#include "philox.cuh"
#include "sasa_terms.cuh"
#include "shared_memory.cuh"

namespace {

// Threads a CTA of each instantiation. The vacuum ones take the pair
// loop's shape by size (pair_loop.cuh: 128, 512 or 1024 threads); the
// smallest is held to 64 registers for 8 CTAs an SM at 104 atoms
// (uncapped, 80 registers and 6 CTAs: 17 % longer, chip_smoke.py's levers),
// the medium one to 64 for 2 CTAs an SM; shared memory ends the largest at
// 1,248 atoms. Solvent: its shared memory allows 4 CTAs an SM, and
// __launch_bounds__ holds it to the registers that allow as many: at 256
// threads 64, and the spills (loop-invariant addresses, loaded outside the
// inner loops) cost less than the extra warps give (at 128 threads it takes
// 128 registers and 12 % longer; at 256 threads uncapped, 128 registers
// and 2 CTAs an SM, 43 % longer).
constexpr int kVacuumCtasPerSm = 8;  // 64 registers
constexpr int kMediumCtasPerSm = 2;  // 64 registers
constexpr int kSolventThreads = 256;
constexpr int kSolventCtasPerSm = 4;

constexpr float kEps = 1e-12f;
constexpr float kTwoPi = 6.283185307179586f;

// Order of the device pointers handed over by the wrapper
// (ops/fused_step.py TABLE_SLOTS keeps the same order).
enum Slot {
  kLjType, kLjTable, kCharge, kExcl, kSpIdx, kSpA, kSpB, kSpC, kSpStart,
  kSpSrc,
  kAngIdx, kAngK, kAngT0,
  kTorIdx, kTorK, kTorPhi0, kTorPer,
  kMinv, kC2, kWdiff,
  kBiasIdx, kBiasW,
  kConsIdx, kConsWsum, kConsWinv, kConsD0sq,
  kAngStart, kAngSrc, kAngW,
  kTorStart, kTorSrc, kTorW,
  kConsStart, kConsSrc, kConsW,
  kGbAtom, kSasaIdx, kSasaAtom,
  kNumSlots
};

struct Tables {
  PairLayout pair;
  const int* ang_idx; const float* ang_k; const float* ang_t0;
  const int* tor_idx; const float* tor_k; const float* tor_phi0;
  const float* tor_per;
  const float* minv; const float* c2; const float* wdiff;
  const int* bias_idx; const float* bias_w;
  const int* cons_idx; const float* cons_wsum; const float* cons_winv;
  const float* cons_d0sq;
  const int* ang_start; const int* ang_src; const float* ang_w;
  const int* tor_start; const int* tor_src; const float* tor_w;
  const int* cons_start; const int* cons_src; const float* cons_w;
  const float* gb_atom; const int* sasa_idx; const float* sasa_atom;
};

// Order of the integers (DIM_SLOTS in the wrapper).
struct Dims {
  int n_atoms, n_angles, n_tors, max_t, n_cons, n_bias, n_inner, shake_iters,
      rattle_iters, use_noise;
  int use_gb;      // GB-OBC II polar force on
  int n_sasa;      // heavy atoms of the LCPO set, 0 = LCPO off
  int sasa_every;  // LCPO cadence (1 = every step)
  int gb_every;    // GB cadence (1 = every step)
  int n_lj_types;  // LJ types of the pair layout
};

__host__ __device__ inline bool has_slow_buffer(const Dims& d) {
  return (d.use_gb && d.gb_every > 1) || (d.n_sasa && d.sasa_every > 1);
}

// Order of the floats (CONST_SLOTS in the wrapper).
struct Consts {
  float half_dt, c1, bias_fk, bias_c0, bias_slope, bias_tmax;
  PairConsts pair;
  GbConsts gb;
  float sasa_gamma;  // surface tension
};

struct Shared {
  float *x, *y, *z, *vx, *vy, *vz, *fx, *fy, *fz;
  float *slx, *sly, *slz;  // the slow (held or impulse) force of a block
  float* box;              // the pair loop's chunk bounding boxes
  // one region, three tenants that are never live at once
  float* abuf;  // 2 * n_angles 3-vectors: f0 | f2
  float* tbuf;  // 3 * n_tors 3-vectors: f0v | s | f3v
  float* rdir;  // n_cons 3-vectors: SHAKE reference directions
  float* dhat;  // n_cons 3-vectors: RATTLE unit bond vectors
  float* cbuf;  // n_cons 3-vectors: this sweep's corrections
  GbShared gb;
  SasaShared sasa;
};

// Sum of w[e] * buf[src[e]] over atom a's entries, in list order.
__device__ __forceinline__ void gather3(const float* buf, const int* start,
                                        const int* src, const float* w, int a,
                                        float& ax, float& ay, float& az) {
  ax = ay = az = 0.f;
  const int e1 = start[a + 1];
  for (int e = start[a]; e < e1; ++e) {
    const int s = 3 * src[e];
    const float wv = w[e];
    ax += wv * buf[s + 0];
    ay += wv * buf[s + 1];
    az += wv * buf[s + 2];
  }
}

// RATTLE: zero the along-bond relative velocity (rattle_iters Jacobi
// sweeps). With capture, also stores the bond vectors of x as the SHAKE
// reference directions of the drift that follows.
template <int kThreads>
__device__ void rattle(const Shared& s, const Tables& t, const Dims& d,
                       bool capture) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int c = tid; c < d.n_cons; c += kThreads) {
    const int i = t.cons_idx[2 * c], j = t.cons_idx[2 * c + 1];
    const float dx = s.x[i] - s.x[j];
    const float dy = s.y[i] - s.y[j];
    const float dz = s.z[i] - s.z[j];
    const float inv = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, kEps));
    s.dhat[3 * c + 0] = dx * inv;
    s.dhat[3 * c + 1] = dy * inv;
    s.dhat[3 * c + 2] = dz * inv;
    if (capture) {
      s.rdir[3 * c + 0] = dx;
      s.rdir[3 * c + 1] = dy;
      s.rdir[3 * c + 2] = dz;
    }
  }
  for (int it = 0; it < d.rattle_iters; ++it) {
    for (int c = tid; c < d.n_cons; c += kThreads) {
      const int i = t.cons_idx[2 * c], j = t.cons_idx[2 * c + 1];
      const float hx = s.dhat[3 * c], hy = s.dhat[3 * c + 1],
                  hz = s.dhat[3 * c + 2];
      const float lam = ((s.vx[i] - s.vx[j]) * hx + (s.vy[i] - s.vy[j]) * hy +
                         (s.vz[i] - s.vz[j]) * hz) *
                        t.cons_winv[c];
      s.cbuf[3 * c + 0] = lam * hx;
      s.cbuf[3 * c + 1] = lam * hy;
      s.cbuf[3 * c + 2] = lam * hz;
    }
    __syncthreads();
    for (int a = tid; a < d.n_atoms; a += kThreads) {
      float ax, ay, az;
      gather3(s.cbuf, t.cons_start, t.cons_src, t.cons_w, a, ax, ay, az);
      s.vx[a] += ax;
      s.vy[a] += ay;
      s.vz[a] += az;
    }
    __syncthreads();
  }
}

// SHAKE along the captured reference directions (shake_iters Jacobi sweeps).
template <int kThreads>
__device__ void shake(const Shared& s, const Tables& t, const Dims& d) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int it = 0; it < d.shake_iters; ++it) {
    for (int c = tid; c < d.n_cons; c += kThreads) {
      const int i = t.cons_idx[2 * c], j = t.cons_idx[2 * c + 1];
      const float dx = s.x[i] - s.x[j];
      const float dy = s.y[i] - s.y[j];
      const float dz = s.z[i] - s.z[j];
      const float rx = s.rdir[3 * c], ry = s.rdir[3 * c + 1],
                  rz = s.rdir[3 * c + 2];
      const float diff = dx * dx + dy * dy + dz * dz - t.cons_d0sq[c];
      const float denom = 2.f * t.cons_wsum[c] * (dx * rx + dy * ry + dz * rz);
      const float g = diff / (fabsf(denom) > 1e-12f ? denom : 1e-12f);
      s.cbuf[3 * c + 0] = g * rx;
      s.cbuf[3 * c + 1] = g * ry;
      s.cbuf[3 * c + 2] = g * rz;
    }
    __syncthreads();
    for (int a = tid; a < d.n_atoms; a += kThreads) {
      float ax, ay, az;
      gather3(s.cbuf, t.cons_start, t.cons_src, t.cons_w, a, ax, ay, az);
      s.x[a] += ax;
      s.y[a] += ay;
      s.z[a] += az;
    }
    __syncthreads();
  }
}

// Analytic 3-centre angle forces into abuf: f0 on atom 0, f2 on atom 2, and
// -(f0 + f2) on the middle atom (through the gather weights).
template <int kThreads>
__device__ __forceinline__ void angle_forces(const Shared& s, const Tables& t,
                                             const Dims& d) {
  for (int a = threadIdx.x; a < d.n_angles; a += kThreads) {
    const int i0 = t.ang_idx[3 * a], i1 = t.ang_idx[3 * a + 1],
              i2 = t.ang_idx[3 * a + 2];
    const float r21x = s.x[i0] - s.x[i1], r21y = s.y[i0] - s.y[i1],
                r21z = s.z[i0] - s.z[i1];
    const float r23x = s.x[i2] - s.x[i1], r23y = s.y[i2] - s.y[i1],
                r23z = s.z[i2] - s.z[i1];
    const float cx = r21y * r23z - r21z * r23y;
    const float cy = r21z * r23x - r21x * r23z;
    const float cz = r21x * r23y - r21y * r23x;
    const float nrm = sqrtf(fmaxf(cx * cx + cy * cy + cz * cz, kEps));
    const float dot = r21x * r23x + r21y * r23y + r21z * r23z;
    const float theta = atan2f(nrm, dot);
    const float n21i =
        rsqrtf(fmaxf(r21x * r21x + r21y * r21y + r21z * r21z, kEps));
    const float n23i =
        rsqrtf(fmaxf(r23x * r23x + r23y * r23y + r23z * r23z, kEps));
    const float cos_t = dot * n21i * n23i;
    const float sin_t = fmaxf(nrm * n21i * n23i, 1e-6f);
    const float coef = -2.f * t.ang_k[a] * (theta - t.ang_t0[a]) / sin_t;
    float* f0 = s.abuf + 3 * a;
    float* f2 = s.abuf + 3 * (d.n_angles + a);
    f0[0] = coef * (cos_t * r21x * n21i - r23x * n23i) * n21i;
    f0[1] = coef * (cos_t * r21y * n21i - r23y * n23i) * n21i;
    f0[2] = coef * (cos_t * r21z * n21i - r23z * n23i) * n21i;
    f2[0] = coef * (cos_t * r23x * n23i - r21x * n21i) * n23i;
    f2[1] = coef * (cos_t * r23y * n23i - r21y * n21i) * n23i;
    f2[2] = coef * (cos_t * r23z * n23i - r21z * n21i) * n23i;
  }
}

// Analytic 4-centre forces of dihedrals and impropers together into tbuf:
// the three vectors f0v, s, f3v, distributed by the gather weights as
// atom0 -f0v, atom1 +f0v +s, atom2 -s +f3v, atom3 -f3v.
template <int kThreads>
__device__ __forceinline__ void torsion_forces(const Shared& s,
                                               const Tables& t,
                                               const Dims& d) {
  for (int q = threadIdx.x; q < d.n_tors; q += kThreads) {
    const int i0 = t.tor_idx[4 * q], i1 = t.tor_idx[4 * q + 1],
              i2 = t.tor_idx[4 * q + 2], i3 = t.tor_idx[4 * q + 3];
    const float b1x = s.x[i0] - s.x[i1], b1y = s.y[i0] - s.y[i1],
                b1z = s.z[i0] - s.z[i1];
    const float b2x = s.x[i1] - s.x[i2], b2y = s.y[i1] - s.y[i2],
                b2z = s.z[i1] - s.z[i2];
    const float b3x = s.x[i2] - s.x[i3], b3y = s.y[i2] - s.y[i3],
                b3z = s.z[i2] - s.z[i3];
    const float cax = b1y * b2z - b1z * b2y;
    const float cay = b1z * b2x - b1x * b2z;
    const float caz = b1x * b2y - b1y * b2x;
    const float cbx = b2y * b3z - b2z * b3y;
    const float cby = b2z * b3x - b2x * b3z;
    const float cbz = b2x * b3y - b2y * b3x;
    const float mx = cay * cbz - caz * cby;
    const float my = caz * cbx - cax * cbz;
    const float mz = cax * cby - cay * cbx;
    const float b2n = sqrtf(fmaxf(b2x * b2x + b2y * b2y + b2z * b2z, kEps));
    const float sin_num = (b2x * mx + b2y * my + b2z * mz) / b2n;
    const float cos_num = cax * cbx + cay * cby + caz * cbz;
    const float phi = -atan2f(sin_num, cos_num);
    float coeff = 0.f;
    for (int m = 0; m < d.max_t; ++m) {
      const float k = t.tor_k[m * d.n_tors + q];
      const float phi0 = t.tor_phi0[m * d.n_tors + q];
      const float per = t.tor_per[m * d.n_tors + q];
      if (per > 0.f) {
        coeff += -per * k * sinf(per * phi - phi0);
      } else {
        float dp = phi - phi0;
        dp -= kTwoPi * rintf(dp / kTwoPi);
        coeff += 2.f * k * dp;
      }
    }
    const float na2 = fmaxf(cax * cax + cay * cay + caz * caz, kEps);
    const float nb2 = fmaxf(cbx * cbx + cby * cby + cbz * cbz, kEps);
    const float n2d2 = fmaxf(b2n * b2n, kEps);
    const float ff0 = (-coeff * b2n) / na2;
    const float ff1 = (b1x * b2x + b1y * b2y + b1z * b2z) / n2d2;
    const float ff2 = (b3x * b2x + b3y * b2y + b3z * b2z) / n2d2;
    const float ff3 = (coeff * b2n) / nb2;
    const float f0x = ff0 * cax, f0y = ff0 * cay, f0z = ff0 * caz;
    const float f3x = ff3 * cbx, f3y = ff3 * cby, f3z = ff3 * cbz;
    float* o0 = s.tbuf + 3 * q;
    float* o1 = s.tbuf + 3 * (d.n_tors + q);
    float* o2 = s.tbuf + 3 * (2 * d.n_tors + q);
    o0[0] = f0x; o0[1] = f0y; o0[2] = f0z;
    o1[0] = ff1 * f0x - ff2 * f3x;
    o1[1] = ff1 * f0y - ff2 * f3y;
    o1[2] = ff1 * f0z - ff2 * f3z;
    o2[0] = f3x; o2[1] = f3y; o2[2] = f3z;
  }
}

// Total force on every atom at the positions in shared memory; the SMD
// centre is evaluated at t_step. Expects a barrier before (positions
// complete) and leaves one behind (forces complete). kSolvent = false
// compiles the implicit-solvent calls out, so the vacuum kernels keep the
// registers (and the CTAs an SM) they have without them. The plain pairs'
// column sums go to (fx, fy, fz) round by round (pair_loop.cuh); a thread's
// atoms are those whose pair-loop rows it holds, so one per-atom pass adds
// the rows, the special pairs, the bonded gathers and the bias.
template <bool kSolvent, int kThreads>
__device__ void forces(const Shared& s, const Tables& t, const Dims& d,
                       const Consts& k, float t_step, bool with_gb,
                       bool with_sasa, bool add_held, int* overflow) {
  constexpr int kRows = chunks_per_warp(kThreads);
  const int tid = threadIdx.x;
  const int n = d.n_atoms;
  chunk_boxes<kThreads>(n, s.x, s.y, s.z, s.box);
  angle_forces<kThreads>(s, t, d);
  torsion_forces<kThreads>(s, t, d);
  for (int a = tid; a < n; a += kThreads) s.fx[a] = s.fy[a] = s.fz[a] = 0.f;
  __syncthreads();
  float rx[kRows], ry[kRows], rz[kRows];
  pair_rounds<kThreads, kRows, false>(n, s.x, s.y, s.z, s.fx, s.fy, s.fz,
                                      s.box, t.pair, k.pair, rx, ry, rz);
  // moving harmonic SMD bias: every thread sums the (few) group atoms itself
  float comx = 0.f, comy = 0.f, comz = 0.f;
  for (int b = 0; b < d.n_bias; ++b) {
    const int i = t.bias_idx[b];
    const float w = t.bias_w[b];
    comx += w * s.x[i];
    comy += w * s.y[i];
    comz += w * s.z[i];
  }
  const float dist =
      sqrtf(fmaxf(comx * comx + comy * comy + comz * comz, kEps));
  const float center = k.bias_c0 + k.bias_slope * fminf(t_step, k.bias_tmax);
  const float coefb = k.bias_fk * (dist - center) / dist;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int a = row_atom<kThreads>(n, q);
    if (a < 0) continue;
    float fx = s.fx[a] + rx[q], fy = s.fy[a] + ry[q], fz = s.fz[a] + rz[q];
    float unused = 0.f;
    special_sum<false>(a, s.x, s.y, s.z, t.pair, k.pair, fx, fy, fz, unused);
    float ax, ay, az, bx, by, bz;
    gather3(s.abuf, t.ang_start, t.ang_src, t.ang_w, a, ax, ay, az);
    gather3(s.tbuf, t.tor_start, t.tor_src, t.tor_w, a, bx, by, bz);
    const float wd = d.n_bias ? t.wdiff[a] : 0.f;
    fx += ax + bx - coefb * comx * wd;
    fy += ay + by - coefb * comy * wd;
    fz += az + bz - coefb * comz * wd;
    if (kSolvent && add_held) {
      fx += s.slx[a];
      fy += s.sly[a];
      fz += s.slz[a];
    }
    s.fx[a] = fx;
    s.fy[a] = fy;
    s.fz[a] = fz;
  }
  __syncthreads();
  if (!kSolvent) return;
  if (with_gb)
    gb_forces_add<kThreads, false>(d.n_atoms, s.x, s.y, s.z, t.gb_atom, k.gb,
                                   s.gb, s.fx, s.fy, s.fz);
  if (with_sasa)
    sasa_forces_add<kThreads, false>(d.n_sasa, t.sasa_idx, t.sasa_atom,
                                     k.sasa_gamma, s.x, s.y, s.z, s.sasa, s.fx,
                                     s.fy, s.fz, overflow);
}

// The slow force of a cadence block at the positions in shared memory, into
// (slx, sly, slz): GB when its cadence is > 1, LCPO when its cadence is > 1.
// Expects a barrier before and leaves one behind.
template <int kThreads>
__device__ void slow_force(const Shared& s, const Tables& t, const Dims& d,
                           const Consts& k, int* overflow) {
  for (int a = threadIdx.x; a < d.n_atoms; a += kThreads)
    s.slx[a] = s.sly[a] = s.slz[a] = 0.f;
  __syncthreads();
  if (d.use_gb && d.gb_every > 1)
    gb_forces_add<kThreads, false>(d.n_atoms, s.x, s.y, s.z, t.gb_atom, k.gb,
                                   s.gb, s.slx, s.sly, s.slz);
  if (d.n_sasa && d.sasa_every > 1)
    sasa_forces_add<kThreads, false>(d.n_sasa, t.sasa_idx, t.sasa_atom,
                                     k.sasa_gamma, s.x, s.y, s.z, s.sasa,
                                     s.slx, s.sly, s.slz, overflow);
}

// Half-block impulse of the slow force: v += (k dt / 2) F_slow / m, then
// RATTLE on the constrained components.
template <int kThreads>
__device__ void slow_kick(const Shared& s, const Tables& t, const Dims& d,
                          const Consts& k) {
  const float hk = k.half_dt * static_cast<float>(d.gb_every);
  for (int a = threadIdx.x; a < d.n_atoms; a += kThreads) {
    const float h = hk * t.minv[a];
    s.vx[a] += h * s.slx[a];
    s.vy[a] += h * s.sly[a];
    s.vz[a] += h * s.slz[a];
  }
  if (d.n_cons > 0) rattle<kThreads>(s, t, d, false);
}

__device__ __forceinline__ Shared carve(float* smem, const Dims& d) {
  Shared s;
  const int n = d.n_atoms;
  float* p = smem;
  s.x = p; p += n;  s.y = p; p += n;  s.z = p; p += n;
  s.vx = p; p += n; s.vy = p; p += n; s.vz = p; p += n;
  s.fx = p; p += n; s.fy = p; p += n; s.fz = p; p += n;
  s.slx = s.sly = s.slz = nullptr;
  if (has_slow_buffer(d)) {
    s.slx = p; p += n; s.sly = p; p += n; s.slz = p; p += n;
  }
  s.box = p; p += 6 * chunk_count(n);
  float* region = p;
  s.abuf = p; p += 6 * d.n_angles;
  s.tbuf = p; p += 9 * d.n_tors;
  s.rdir = p; p += 3 * d.n_cons;
  s.dhat = p; p += 3 * d.n_cons;
  s.cbuf = p;
  s.gb = gb_carve(region, n);
  s.sasa = sasa_carve(region, d.n_sasa);
  return s;
}

// ops/fused_step.py campaign_shared_bytes says the same.
__host__ __device__ inline size_t shared_floats(const Dims& d) {
  size_t region = 6 * static_cast<size_t>(d.n_angles) + 9 * d.n_tors +
                  9 * d.n_cons;
  if (d.use_gb && gb_shared_floats(d.n_atoms) > region)
    region = gb_shared_floats(d.n_atoms);
  if (d.n_sasa && sasa_shared_words(d.n_sasa) > region)
    region = sasa_shared_words(d.n_sasa);
  return 9 * static_cast<size_t>(d.n_atoms) +
         (has_slow_buffer(d) ? 3 * d.n_atoms : 0) + 6 * chunk_count(d.n_atoms) +
         region;
}

// One BAOAB step; the SMD centre of its force evaluation is that of t_abs.
template <bool kSolvent, int kThreads>
__device__ void baoab_step(const Shared& s, const Tables& t, const Dims& d,
                           const Consts& k, int rep, long long t_abs,
                           unsigned long long seed, bool with_gb,
                           bool with_sasa, bool add_held, int* overflow) {
  const int tid = threadIdx.x;
  const int n = d.n_atoms;
  const bool cons = d.n_cons > 0;
  // B: half kick with the stored forces
  for (int a = tid; a < n; a += kThreads) {
    const float h = k.half_dt * t.minv[a];
    s.vx[a] += h * s.fx[a];
    s.vy[a] += h * s.fy[a];
    s.vz[a] += h * s.fz[a];
  }
  if (cons) rattle<kThreads>(s, t, d, true);
  // A: half drift
  for (int a = tid; a < n; a += kThreads) {
    s.x[a] += k.half_dt * s.vx[a];
    s.y[a] += k.half_dt * s.vy[a];
    s.z[a] += k.half_dt * s.vz[a];
  }
  if (cons) shake<kThreads>(s, t, d);
  // O: exact Ornstein-Uhlenbeck solve
  for (int a = tid; a < n; a += kThreads) {
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (d.use_noise) thermostat_normals(seed, rep, t_abs, a, g0, g1, g2);
    const float c2 = t.c2[a];
    s.vx[a] = k.c1 * s.vx[a] + c2 * g0;
    s.vy[a] = k.c1 * s.vy[a] + c2 * g1;
    s.vz[a] = k.c1 * s.vz[a] + c2 * g2;
  }
  if (cons) rattle<kThreads>(s, t, d, true);
  // A: half drift
  for (int a = tid; a < n; a += kThreads) {
    s.x[a] += k.half_dt * s.vx[a];
    s.y[a] += k.half_dt * s.vy[a];
    s.z[a] += k.half_dt * s.vz[a];
  }
  if (cons) shake<kThreads>(s, t, d);
  __syncthreads();
  // B: half kick with the new forces, SMD centre at the step's start index
  forces<kSolvent, kThreads>(s, t, d, k, static_cast<float>(t_abs), with_gb,
                             with_sasa, add_held, overflow);
  for (int a = tid; a < n; a += kThreads) {
    const float h = k.half_dt * t.minv[a];
    s.vx[a] += h * s.fx[a];
    s.vy[a] += h * s.fy[a];
    s.vz[a] += h * s.fz[a];
  }
  if (cons) rattle<kThreads>(s, t, d, false);
}

// The launch: kSolvent carries GB / LCPO and their cadences. overflow: set
// to 1 when an LCPO neighbour list overflows (sasa_terms.cuh).
template <bool kSolvent, int kThreads>
__device__ __forceinline__ void campaign_body(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ frc, float* __restrict__ opos,
    float* __restrict__ ovel, float* __restrict__ ofrc, const Tables& t,
    const Dims& d, const Consts& k, long long t0, unsigned long long seed,
    int* overflow) {
  extern __shared__ float smem[];
  const Shared s = carve(smem, d);
  const int tid = threadIdx.x;
  const int rep = blockIdx.x;
  const int n = d.n_atoms;
  const size_t base = static_cast<size_t>(rep) * n * 3;

  for (int a = tid; a < n; a += kThreads) {
    s.x[a] = pos[base + 3 * a];
    s.y[a] = pos[base + 3 * a + 1];
    s.z[a] = pos[base + 3 * a + 2];
    s.vx[a] = vel[base + 3 * a];
    s.vy[a] = vel[base + 3 * a + 1];
    s.vz[a] = vel[base + 3 * a + 2];
    s.fx[a] = frc[base + 3 * a];
    s.fy[a] = frc[base + 3 * a + 1];
    s.fz[a] = frc[base + 3 * a + 2];
  }

  __syncthreads();

  const bool impulse = kSolvent && d.use_gb && d.gb_every > 1;
  const bool held = kSolvent && !impulse && d.n_sasa && d.sasa_every > 1;
  const bool gb_each = d.use_gb && !impulse;
  const bool sasa_each = d.n_sasa && d.sasa_every == 1;
  if (impulse) {
    // the carried force is the fast one inside this mode
    slow_force<kThreads>(s, t, d, k, overflow);
    for (int a = tid; a < n; a += kThreads) {
      s.fx[a] -= s.slx[a];
      s.fy[a] -= s.sly[a];
      s.fz[a] -= s.slz[a];
    }
    for (int j = 0; j < d.n_inner / d.gb_every; ++j) {
      slow_kick<kThreads>(s, t, d, k);
      for (int i = 0; i < d.gb_every; ++i)
        baoab_step<kSolvent, kThreads>(s, t, d, k, rep, t0 + j * d.gb_every + i, seed,
                                       false, sasa_each, false, overflow);
      __syncthreads();
      slow_force<kThreads>(s, t, d, k, overflow);
      slow_kick<kThreads>(s, t, d, k);
    }
    for (int a = tid; a < n; a += kThreads) {
      s.fx[a] += s.slx[a];
      s.fy[a] += s.sly[a];
      s.fz[a] += s.slz[a];
    }
  } else if (held) {
    for (int j = 0; j < d.n_inner / d.sasa_every; ++j) {
      __syncthreads();
      slow_force<kThreads>(s, t, d, k, overflow);
      for (int i = 0; i < d.sasa_every; ++i)
        baoab_step<kSolvent, kThreads>(s, t, d, k, rep, t0 + j * d.sasa_every + i, seed,
                                       gb_each, false, true, overflow);
    }
  } else {
    for (int step = 0; step < d.n_inner; ++step)
      baoab_step<kSolvent, kThreads>(s, t, d, k, rep, t0 + step, seed,
                                     gb_each, sasa_each, false, overflow);
  }
  __syncthreads();

  for (int a = tid; a < n; a += kThreads) {
    opos[base + 3 * a] = s.x[a];
    opos[base + 3 * a + 1] = s.y[a];
    opos[base + 3 * a + 2] = s.z[a];
    ovel[base + 3 * a] = s.vx[a];
    ovel[base + 3 * a + 1] = s.vy[a];
    ovel[base + 3 * a + 2] = s.vz[a];
    ofrc[base + 3 * a] = s.fx[a];
    ofrc[base + 3 * a + 1] = s.fy[a];
    ofrc[base + 3 * a + 2] = s.fz[a];
  }
}

// The four instantiations; the wrapper picks the solvent one when dims ask
// for GB or LCPO, else the vacuum one for the system's size.
__global__ void __launch_bounds__(kSmallThreads, kVacuumCtasPerSm)
campaign_vacuum(const float* __restrict__ pos, const float* __restrict__ vel,
                const float* __restrict__ frc, float* __restrict__ opos,
                float* __restrict__ ovel, float* __restrict__ ofrc, Tables t,
                Dims d, Consts k, long long t0, unsigned long long seed,
                int* overflow) {
  campaign_body<false, kSmallThreads>(pos, vel, frc, opos, ovel, ofrc, t, d,
                                      k, t0, seed, overflow);
}

__global__ void __launch_bounds__(kMediumThreads, kMediumCtasPerSm)
campaign_medium(const float* __restrict__ pos, const float* __restrict__ vel,
                const float* __restrict__ frc, float* __restrict__ opos,
                float* __restrict__ ovel, float* __restrict__ ofrc, Tables t,
                Dims d, Consts k, long long t0, unsigned long long seed,
                int* overflow) {
  campaign_body<false, kMediumThreads>(pos, vel, frc, opos, ovel, ofrc, t, d,
                                       k, t0, seed, overflow);
}

__global__ void __launch_bounds__(kLargeThreads)
campaign_large(const float* __restrict__ pos, const float* __restrict__ vel,
               const float* __restrict__ frc, float* __restrict__ opos,
               float* __restrict__ ovel, float* __restrict__ ofrc, Tables t,
               Dims d, Consts k, long long t0, unsigned long long seed,
               int* overflow) {
  campaign_body<false, kLargeThreads>(pos, vel, frc, opos, ovel, ofrc, t, d,
                                      k, t0, seed, overflow);
}

__global__ void __launch_bounds__(kSolventThreads, kSolventCtasPerSm)
campaign_solvent(const float* __restrict__ pos, const float* __restrict__ vel,
                 const float* __restrict__ frc, float* __restrict__ opos,
                 float* __restrict__ ovel, float* __restrict__ ofrc, Tables t,
                 Dims d, Consts k, long long t0, unsigned long long seed,
                 int* overflow) {
  campaign_body<true, kSolventThreads>(pos, vel, frc, opos, ovel, ofrc, t, d,
                                       k, t0, seed, overflow);
}

// The normals the campaign kernel draws: out[(r, i, a, 0..2)] for replica r,
// step t0 + i, atom a. One thread per (r, i, a).
__global__ void noise_kernel(float* __restrict__ out, int n_replicas,
                             int n_inner, int n_atoms, long long t0,
                             unsigned long long seed) {
  const long long total =
      static_cast<long long>(n_replicas) * n_inner * n_atoms;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int a = static_cast<int>(idx % n_atoms);
  const int i = static_cast<int>((idx / n_atoms) % n_inner);
  const int r = static_cast<int>(idx / (static_cast<long long>(n_atoms) * n_inner));
  float g0, g1, g2;
  thermostat_normals(seed, r, t0 + i, a, g0, g1, g2);
  out[3 * idx] = g0;
  out[3 * idx + 1] = g1;
  out[3 * idx + 2] = g2;
}

}  // namespace

namespace {

Dims dims_of(const int* dims) {
  return Dims{dims[0],  dims[1],  dims[2],  dims[3],  dims[4],
              dims[5],  dims[6],  dims[7],  dims[8],  dims[9],
              dims[10], dims[11], dims[12], dims[13], dims[14]};
}

using CampaignKernel = void (*)(const float*, const float*, const float*,
                                float*, float*, float*, Tables, Dims, Consts,
                                long long, unsigned long long, int*);

// The instantiation dims ask for, and its threads a CTA; nullptr past what
// the vacuum instantiations hold (the wrapper checks first).
CampaignKernel pick_kernel(const Dims& d, int& threads) {
  if (d.use_gb || d.n_sasa) {
    threads = kSolventThreads;
    return campaign_solvent;
  }
  switch (pair_loop_shape(d.n_atoms)) {
    case kSmallCta:
      threads = kSmallThreads;
      return campaign_vacuum;
    case kMediumCta:
      threads = kMediumThreads;
      return campaign_medium;
    case kLargeCta:
      threads = kLargeThreads;
      return campaign_large;
    default:
      threads = 0;
      return nullptr;
  }
}

}  // namespace

// Advance (R, N, 3) pos/vel/frc by dims[6] steps into opos/ovel/ofrc.
// `ptrs` holds kNumSlots device pointers in Slot order, `dims` the integers
// of Dims, `consts` the floats of Consts (all host arrays). The cadences
// must divide dims[6]; the wrapper checks that. `overflow` (one device int)
// is set to 1 when an LCPO neighbour list overflows; the wrapper reads it.
// Returns cudaGetLastError(), or the error that refused the shared memory
// (the wrapper checks it against SHARED_OPT_IN_BYTES first).
extern "C" int mdx_campaign_advance(const void* pos, const void* vel,
                                    const void* frc, void* opos, void* ovel,
                                    void* ofrc, const void* const* ptrs,
                                    const int* dims, const float* consts,
                                    int n_replicas, long long t0,
                                    unsigned long long seed, void* overflow,
                                    void* stream) {
  const Dims d = dims_of(dims);
  Tables t;
  t.pair = PairLayout{
      static_cast<const int*>(ptrs[kLjType]),
      static_cast<const float2*>(ptrs[kLjTable]),
      static_cast<const float*>(ptrs[kCharge]),
      static_cast<const unsigned*>(ptrs[kExcl]),
      static_cast<const int2*>(ptrs[kSpIdx]),
      static_cast<const float4*>(ptrs[kSpA]),
      static_cast<const float4*>(ptrs[kSpB]),
      static_cast<const float*>(ptrs[kSpC]),
      static_cast<const int*>(ptrs[kSpStart]),
      static_cast<const int*>(ptrs[kSpSrc]),
      d.n_lj_types};
  t.ang_idx = static_cast<const int*>(ptrs[kAngIdx]);
  t.ang_k = static_cast<const float*>(ptrs[kAngK]);
  t.ang_t0 = static_cast<const float*>(ptrs[kAngT0]);
  t.tor_idx = static_cast<const int*>(ptrs[kTorIdx]);
  t.tor_k = static_cast<const float*>(ptrs[kTorK]);
  t.tor_phi0 = static_cast<const float*>(ptrs[kTorPhi0]);
  t.tor_per = static_cast<const float*>(ptrs[kTorPer]);
  t.minv = static_cast<const float*>(ptrs[kMinv]);
  t.c2 = static_cast<const float*>(ptrs[kC2]);
  t.wdiff = static_cast<const float*>(ptrs[kWdiff]);
  t.bias_idx = static_cast<const int*>(ptrs[kBiasIdx]);
  t.bias_w = static_cast<const float*>(ptrs[kBiasW]);
  t.cons_idx = static_cast<const int*>(ptrs[kConsIdx]);
  t.cons_wsum = static_cast<const float*>(ptrs[kConsWsum]);
  t.cons_winv = static_cast<const float*>(ptrs[kConsWinv]);
  t.cons_d0sq = static_cast<const float*>(ptrs[kConsD0sq]);
  t.ang_start = static_cast<const int*>(ptrs[kAngStart]);
  t.ang_src = static_cast<const int*>(ptrs[kAngSrc]);
  t.ang_w = static_cast<const float*>(ptrs[kAngW]);
  t.tor_start = static_cast<const int*>(ptrs[kTorStart]);
  t.tor_src = static_cast<const int*>(ptrs[kTorSrc]);
  t.tor_w = static_cast<const float*>(ptrs[kTorW]);
  t.cons_start = static_cast<const int*>(ptrs[kConsStart]);
  t.cons_src = static_cast<const int*>(ptrs[kConsSrc]);
  t.cons_w = static_cast<const float*>(ptrs[kConsW]);
  t.gb_atom = static_cast<const float*>(ptrs[kGbAtom]);
  t.sasa_idx = static_cast<const int*>(ptrs[kSasaIdx]);
  t.sasa_atom = static_cast<const float*>(ptrs[kSasaAtom]);

  Consts k;
  k.half_dt = consts[0];
  k.c1 = consts[1];
  k.bias_fk = consts[2];
  k.bias_c0 = consts[3];
  k.bias_slope = consts[4];
  k.bias_tmax = consts[5];
  k.pair = PairConsts{consts[6], consts[7], consts[8], consts[9], consts[10]};
  k.gb = GbConsts{consts[11], consts[12], consts[13], consts[14], consts[15]};
  k.sasa_gamma = consts[16];

  const size_t shmem = shared_floats(d) * sizeof(float);
  int threads;
  const CampaignKernel kernel = pick_kernel(d, threads);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_dynamic_shared(kernel, shmem);
  if (err != 0) return err;
  kernel<<<n_replicas, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(vel),
      static_cast<const float*>(frc), static_cast<float*>(opos),
      static_cast<float*>(ovel), static_cast<float*>(ofrc), t, d, k, t0, seed,
      static_cast<int*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

// Build facts of the instantiation `dims` selects, at the shared memory it
// needs, into out[0..4] (kernel_occupancy in shared_memory.cuh).
extern "C" int mdx_campaign_kernel_info(const int* dims, int* out) {
  const Dims d = dims_of(dims);
  int threads;
  const CampaignKernel kernel = pick_kernel(d, threads);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return kernel_occupancy(kernel, threads, shared_floats(d) * sizeof(float),
                          out);
}

// Debug entry: fill out (R, n_inner, N, 3) with the kernel's normals.
extern "C" int mdx_campaign_noise(void* out, int n_replicas, int n_inner,
                                  int n_atoms, long long t0,
                                  unsigned long long seed, void* stream) {
  const long long total =
      static_cast<long long>(n_replicas) * n_inner * n_atoms;
  const int threads = 256;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  noise_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n_replicas, n_inner, n_atoms, t0, seed);
  return static_cast<int>(cudaGetLastError());
}
