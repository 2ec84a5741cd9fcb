// The pair loop of the campaign kernel (K1), the pair-forces kernel (K2)
// and the pair-tile kernel (K6), and the pieces the dense-row kernel (K5)
// shares with them: every 2-body term of a replica whose coordinates sit in
// shared memory, each unordered pair evaluated once, with the physics of
// pair_term().
//
// Layout (built by ops/nonbonded.py pair_layout; no N x N table is read):
//   lj_type (N) and lj_table (T x T of (lj_a, lj_b)): the LJ tables factored
//     into per-atom types, every entry the same float32 number;
//   charge (N): q sqrt(ELEC_FACTOR), qq = charge_i * charge_j;
//   excl (N x chunks): bit t of word [i, J] set where the pair (i, C J + t)
//     is not a plain pair (itself, past the chunk or the end, excluded, or
//     special);
//   the special pairs (bond, Urey-Bradley, 1-4 entries) with their own
//     parameters, and per-atom lists of them.
// The plain pairs: the atoms are cut into chunks of C = ceil(N / chunks) <= 32
// atoms (chunks = ceil(N / 32): 104 atoms make 4 chunks of 26, so that no
// chunk is mostly padding), chunk I owned by warp I mod (warps). A task
// (I, J) is one warp meeting chunk J with chunk I: lane l < C holds row atom
// C I + l in registers and meets column C J + (l + s) mod C at step s, the
// column's force accumulator moving one lane a step with __shfl_sync, so
// every pair of the two chunks is met once. A lane tests its exclusion bit
// and the cutoff before it reads any parameter. Tasks: the diagonal (I, I),
// shifts 1..C/2, an even C's halfway shift on lanes below C/2 only; then
// rounds k = 1..chunks/2 of the tasks (I, I + k mod chunks) (at k = chunks/2
// for an even count only I < k): every unordered pair of chunks once. In a
// round no two tasks share a column chunk, so each adds its column sums
// straight into the shared force array, and a barrier closes the round; the
// row sums stay in the owner's registers until the caller's per-atom pass.
// A task whose two chunks' bounding boxes lie farther apart than the cutoff
// is skipped (every pair in it is beyond the cutoff: it adds nothing). A task
// reads its row and column chunks through pointers to their first atoms, so
// the pair-tile kernel runs the same tasks on the two tiles it holds in
// shared memory. Special pairs are evaluated in the per-atom pass from both
// ends (about 8 % of the pairs). Every atom's sum runs in a fixed order: no
// atomics, the same bits every run. What each choice buys (chip_smoke.py's
// levers, campaign kernel per launch): every pair from both ends instead
// takes 24 % longer at 104 atoms and 49 % at 1,040; without the box test the
// 1,040-atom launch takes 2.5 times as long.
#pragma once

#include "pair_terms.cuh"

struct PairLayout {
  const int* lj_type;
  const float2* lj_table;
  const float* charge;
  const unsigned* excl;
  const int2* sp_idx;
  const float4* sp_a;  // (qq, lj_a, lj_b, mask)
  const float4* sp_b;  // (k_bond, d0, a14, b14)
  const float* sp_c;   // qq14
  const int* sp_start;
  const int* sp_src;
  int n_types;
};

constexpr int kChunk = 32;
constexpr unsigned kAllLanes = 0xffffffffu;

// The CTA shape of both kernels by system size (chip_smoke.py's levers
// measure each choice on the campaign kernel): 128 threads up to 128 atoms,
// one chunk a warp; 512 up to 512 atoms, one chunk a warp, so that 192
// replicas of 416 atoms fit one wave of 2 CTAs an SM (1024 threads there:
// 45 % longer); 1024 above, up to two chunks a warp (2,048 atoms), so the
// widest CTA does the most (at 1,040 atoms 512 threads take 30 % longer,
// 256 90 %). A warp keeps its chunks' row sums in registers.
constexpr int kSmallAtoms = 128;
constexpr int kSmallThreads = 128;
constexpr int kMediumAtoms = 512;
constexpr int kMediumThreads = 512;
constexpr int kLargeThreads = 1024;

__host__ __device__ constexpr int chunks_per_warp(int threads) {
  return threads == kLargeThreads ? 2 : 1;
}

// The instantiation of the pair loop's kernels that holds n atoms.
enum PairLoopShape { kSmallCta, kMediumCta, kLargeCta, kTooLarge };

inline PairLoopShape pair_loop_shape(int n) {
  if (n <= kSmallAtoms) return kSmallCta;
  if (n <= kMediumAtoms) return kMediumCta;
  // ops/nonbonded.py PAIR_LOOP_MAX_ATOMS
  return n <= kLargeThreads / 32 * chunks_per_warp(kLargeThreads) * kChunk
             ? kLargeCta
             : kTooLarge;
}

__host__ __device__ inline int chunk_count(int n) {
  return (n + kChunk - 1) / kChunk;
}

// Atoms a chunk: the chunks as even as 32 lanes allow.
__host__ __device__ inline int chunk_size(int n) {
  const int nc = chunk_count(n);
  return (n + nc - 1) / nc;
}

// Bounding boxes of the `count` chunks from chunk `first` on into box[6 q ..
// 6 q + 5] (lo xyz, hi xyz) for the q-th, warp w taking q = w, w + warps,
// ...; x, y, z hold the coordinates from chunk `first`'s first atom on. min
// and max are exact in any order.
template <int kThreads>
__device__ __forceinline__ void chunk_boxes(int n, int first, int count,
                                            const float* x, const float* y,
                                            const float* z, float* box) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int cs = chunk_size(n);
  for (int I = w; I < count; I += kWarps) {
    const int a =
        min((first + I) * cs + min(lane, cs - 1), n - 1) - first * cs;
    float lo[3] = {x[a], y[a], z[a]}, hi[3] = {x[a], y[a], z[a]};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[d] = fminf(lo[d], __shfl_xor_sync(kAllLanes, lo[d], off));
        hi[d] = fmaxf(hi[d], __shfl_xor_sync(kAllLanes, hi[d], off));
      }
    }
    if (lane < 3) {
      box[6 * I + lane] = lo[lane];
      box[6 * I + 3 + lane] = hi[lane];
    }
  }
}

// Every chunk of the replica, chunk I's box at box[6 I].
template <int kThreads>
__device__ __forceinline__ void chunk_boxes(int n, const float* x,
                                            const float* y, const float* z,
                                            float* box) {
  chunk_boxes<kThreads>(n, 0, chunk_count(n), x, y, z, box);
}

// True where no pair of two chunks with the boxes p and q can lie inside the
// cutoff. The margin keeps the test on the safe side of float32 rounding.
__device__ __forceinline__ bool boxes_apart(const float* p, const float* q,
                                            float cutoff2) {
  const float gx = fmaxf(0.f, fmaxf(q[0] - p[3], p[0] - q[3]));
  const float gy = fmaxf(0.f, fmaxf(q[1] - p[4], p[1] - q[4]));
  const float gz = fmaxf(0.f, fmaxf(q[2] - p[5], p[2] - q[5]));
  return gx * gx + gy * gy + gz * gz > cutoff2 * 1.0001f;
}

// The same for chunks I and J of one box array.
__device__ __forceinline__ bool boxes_apart(const float* box, int I, int J,
                                            float cutoff2) {
  return boxes_apart(box + 6 * I, box + 6 * J, cutoff2);
}

// One warp, one task (I, J): xr, yr, zr hold chunk I's coordinates from its
// first atom on, xc, yc, zc and the column sums fxc, fyc, fzc chunk J's. Row
// sums into (rx, ry, rz) of this lane's row atom; column sums added into
// (fxc, fyc, fzc), or, on the diagonal, into the row sums of the same atom.
// With kEnergy each pair's energy goes to e once.
template <bool kEnergy>
__device__ __forceinline__ void chunk_task(
    int I, int J, int n, const float* xr, const float* yr, const float* zr,
    const float* xc, const float* yc, const float* zc, float* fxc,
    float* fyc, float* fzc, const PairLayout& L, const PairConsts& c,
    float& rx, float& ry, float& rz, float& e) {
  const int lane = threadIdx.x & 31;
  const int cs = chunk_size(n);
  const int a = I * cs + lane;
  const bool diag = I == J;
  const bool row = lane < cs && a < n;
  const unsigned word =
      row ? __ldg(&L.excl[static_cast<size_t>(a) * chunk_count(n) + J])
          : kAllLanes;
  // a lane without a row atom stands on the chunk's first (its word skips
  // every pair)
  const int l = row ? lane : 0;
  const float xi = xr[l], yi = yr[l], zi = zr[l];
  const int ti = __ldg(&L.lj_type[I * cs + l]) * L.n_types;
  const float qi = __ldg(&L.charge[I * cs + l]);
  const int half = cs / 2;
  const int s_lo = diag ? 1 : 0, s_hi = diag ? half : cs - 1;
  // a lane past the chunk keeps its (empty) accumulator
  const int next = lane < cs ? (lane + 1 == cs ? 0 : lane + 1) : lane;
  float cx = 0.f, cy = 0.f, cz = 0.f;  // at step s: column (lane + s) mod C
  int t = lane + s_lo;  // (lane + s) mod C
  if (t >= cs) t -= cs;
  for (int s = s_lo; s <= s_hi; ++s) {
    // an even C's halfway shift of a chunk against itself meets each of its
    // pairs twice: lanes half..C-1 hold the pairs lanes below half count
    if (!((word >> t) & 1u) && !(diag && 2 * s == cs && lane >= half)) {
      const int b = J * cs + t;
      const float dx = xi - xc[t];
      const float dy = yi - yc[t];
      const float dz = zi - zc[t];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 <= c.cutoff2) {
        const float2 lj = __ldg(&L.lj_table[ti + __ldg(&L.lj_type[b])]);
        float coeff, pot = 0.f;
        pair_term<kEnergy, false>(d2, qi * __ldg(&L.charge[b]), lj.x, lj.y,
                                  1.f, 0.f, 0.f, 0.f, 0.f, 0.f, c, coeff, pot);
        const float gx = coeff * dx, gy = coeff * dy, gz = coeff * dz;
        rx -= gx;
        ry -= gy;
        rz -= gz;
        cx += gx;
        cy += gy;
        cz += gz;
        if (kEnergy) e += pot;
      }
    }
    cx = __shfl_sync(kAllLanes, cx, next);
    cy = __shfl_sync(kAllLanes, cy, next);
    cz = __shfl_sync(kAllLanes, cz, next);
    if (++t == cs) t = 0;
  }
  // the lane now holds column (lane + s_hi + 1) mod C: bring its own home
  int home = lane - (s_hi + 1) % cs;
  if (home < 0) home += cs;
  if (lane >= cs) home = lane;
  cx = __shfl_sync(kAllLanes, cx, home);
  cy = __shfl_sync(kAllLanes, cy, home);
  cz = __shfl_sync(kAllLanes, cz, home);
  if (diag) {
    rx += cx;
    ry += cy;
    rz += cz;
  } else if (lane < cs && J * cs + lane < n) {
    fxc[lane] += cx;
    fyc[lane] += cy;
    fzc[lane] += cz;
  }
}

// The atom whose pair-loop row thread threadIdx.x holds as its q-th, or -1:
// lane l of warp w holds atom C I + l of chunk I = w + q warps.
template <int kThreads>
__device__ __forceinline__ int row_atom(int n, int q) {
  const int cs = chunk_size(n);
  const int lane = threadIdx.x & 31;
  const int a = ((threadIdx.x >> 5) + q * (kThreads / 32)) * cs + lane;
  return lane < cs && a < n ? a : -1;
}

// Every plain pair of the replica. Expects the chunk boxes, the coordinates
// and (fx, fy, fz) = 0 (or what the caller wants the columns added to)
// complete behind a barrier; leaves the column sums complete behind one.
// Row q of the thread (atom row_atom(n, q)) ends in (rx, ry, rz)[q]; the
// caller adds it in its per-atom pass. Needs chunks <= kMaxQ warps.
template <int kThreads, int kMaxQ, bool kEnergy>
__device__ __forceinline__ float pair_rounds(
    int n, const float* x, const float* y, const float* z, float* fx,
    float* fy, float* fz, const float* box, const PairLayout& L,
    const PairConsts& c, float (&rx)[kMaxQ], float (&ry)[kMaxQ],
    float (&rz)[kMaxQ]) {
  constexpr int kWarps = kThreads / 32;
  const int w = threadIdx.x >> 5;
  const int nc = chunk_count(n), cs = chunk_size(n);
  float e = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    rx[q] = ry[q] = rz[q] = 0.f;
    const int I = w + q * kWarps;
    if (I < nc)
      chunk_task<kEnergy>(I, I, n, x + I * cs, y + I * cs, z + I * cs,
                          x + I * cs, y + I * cs, z + I * cs, fx + I * cs,
                          fy + I * cs, fz + I * cs, L, c, rx[q], ry[q], rz[q],
                          e);
  }
  for (int k = 1; k <= nc / 2; ++k) {
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      const int I = w + q * kWarps;
      if (I >= nc || (2 * k == nc && I >= k)) continue;
      const int J = (I + k) % nc;
      if (boxes_apart(box, I, J, c.cutoff2)) continue;
      chunk_task<kEnergy>(I, J, n, x + I * cs, y + I * cs, z + I * cs,
                          x + J * cs, y + J * cs, z + J * cs, fx + J * cs,
                          fy + J * cs, fz + J * cs, L, c, rx[q], ry[q], rz[q],
                          e);
    }
    __syncthreads();
  }
  if (nc < 2) __syncthreads();
  return e;
}

// Coordinates of atom i: from three arrays (shared memory), or from a
// replica's (N, 3) rows in device memory.
struct SoaCoords {
  const float *x, *y, *z;
  __device__ __forceinline__ float3 operator()(int i) const {
    return make_float3(x[i], y[i], z[i]);
  }
};
struct AosCoords {
  const float* p;
  __device__ __forceinline__ float3 operator()(int i) const {
    return make_float3(__ldg(&p[3 * i]), __ldg(&p[3 * i + 1]),
                       __ldg(&p[3 * i + 2]));
  }
};

// Force on atom a from its special pairs (F_a = -coeff (r_a - r_p), both ends
// compute the same coeff), in list order; with kEnergy a pair's energy is
// counted at its first atom.
template <bool kEnergy, typename Coords>
__device__ __forceinline__ void special_pairs(int a, const Coords& r,
                                              const PairLayout& L,
                                              const PairConsts& c, float& fx,
                                              float& fy, float& fz, float& e) {
  const float3 ra = r(a);
  const int e1 = __ldg(&L.sp_start[a + 1]);
  for (int k = __ldg(&L.sp_start[a]); k < e1; ++k) {
    const int s = __ldg(&L.sp_src[k]);
    const int2 ij = __ldg(&L.sp_idx[s]);
    const int p = ij.x == a ? ij.y : ij.x;
    const float3 rp = r(p);
    const float dx = ra.x - rp.x;
    const float dy = ra.y - rp.y;
    const float dz = ra.z - rp.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float4 pa = __ldg(&L.sp_a[s]);
    const float4 pb = __ldg(&L.sp_b[s]);
    float coeff, pot = 0.f;
    pair_term<kEnergy>(d2, pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w,
                       __ldg(&L.sp_c[s]), c, coeff, pot);
    fx -= coeff * dx;
    fy -= coeff * dy;
    fz -= coeff * dz;
    if (kEnergy && ij.x == a) e += pot;
  }
}

// The same with the coordinates in three arrays.
template <bool kEnergy>
__device__ __forceinline__ void special_sum(int a, const float* x,
                                            const float* y, const float* z,
                                            const PairLayout& L,
                                            const PairConsts& c, float& fx,
                                            float& fy, float& fz, float& e) {
  special_pairs<kEnergy>(a, SoaCoords{x, y, z}, L, c, fx, fy, fz, e);
}

// The layout from the device pointers of ops/nonbonded.py PAIR_LAYOUT_SLOTS,
// in order.
inline PairLayout pair_layout_of(const void* const* ptrs, int n_types) {
  return PairLayout{static_cast<const int*>(ptrs[0]),
                    static_cast<const float2*>(ptrs[1]),
                    static_cast<const float*>(ptrs[2]),
                    static_cast<const unsigned*>(ptrs[3]),
                    static_cast<const int2*>(ptrs[4]),
                    static_cast<const float4*>(ptrs[5]),
                    static_cast<const float4*>(ptrs[6]),
                    static_cast<const float*>(ptrs[7]),
                    static_cast<const int*>(ptrs[8]),
                    static_cast<const int*>(ptrs[9]),
                    n_types};
}
