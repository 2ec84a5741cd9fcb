// Pair-tile kernel: energy and forces of every 2-body term, each unordered
// pair evaluated once.
//
// Replaces: molecular_dynamics_tpu/ops/ring.py make_pair_ring_op ->
// _ring_kernel / _ring_chunk_kernel (the ring-shift pass over lane-padded
// rows; its shift chunks exist to bound Mosaic's compile time and stay
// behind).
// Bound on an H100: float32 arithmetic at every size (N*(N-1)/2 pairs of ~60
// flops a replica). The tables cost 16 bytes an unordered pair (20 more where
// it carries a bond or 1-4 term): 8.6 MB at 1,040 atoms.
// Design: the atoms are cut into tiles of 128, and a CTA takes one replica
// and one pair of tiles I <= J (45 pairs at 1,040 atoms). Its four warps
// each own 32 rows of tile I and meet 32-atom chunks of tile J with the ring
// idea done in registers: at step s lane l pairs its row with column
// (l + s) mod 32, and the columns' force accumulator moves one lane a step
// with __shfl_sync (the rolled-accumulator identity of the TPU kernel), so
// after 32 steps every lane holds its own column's sum. On a diagonal tile
// (I == J) each unordered pair must be met once: a chunk against itself takes
// the shifts 1..16, and the halfway shift 16, which meets every pair of it
// twice, only on lanes 0..15; of the chunk pairs, (w, w+1) are met by warp w
// and (w, w+2) by warps 0 and 1 only. The CTA writes tile I's and tile J's
// partial forces and its partial energy to a scratch buffer; a second kernel
// sums each atom's partials over the tile pairs in a fixed order. No atomics:
// bit-reproducible.
#include <cuda_runtime.h>

#include "pair_terms.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kWarps = kTile / 32;
constexpr unsigned kAll = 0xffffffffu;

// index of the tile pair (I, J), I <= J, in row-major upper-triangle order
__device__ __forceinline__ int tile_pair_index(int I, int J, int nt) {
  return I * nt - I * (I - 1) / 2 + (J - I);
}

__global__ void __launch_bounds__(kTile)
pair_tiles_kernel(const float* __restrict__ pos, float* __restrict__ part,
                  float* __restrict__ e_part, const float4* tab_a,
                  const float4* tab_b, const float* tab_c, int n, int nt,
                  PairConsts pc) {
  __shared__ float rx[kTile], ry[kTile], rz[kTile];  // tile I
  __shared__ float cx[kTile], cy[kTile], cz[kTile];  // tile J
  __shared__ float col[kWarps][3][kTile];  // each warp's column sums
  __shared__ float warp_e[kWarps];

  const int rep = blockIdx.x;
  const int p = blockIdx.y;
  const int n_pairs = gridDim.y;
  int I = 0, rem = p;
  while (rem >= nt - I) {
    rem -= nt - I;
    ++I;
  }
  const int J = I + rem;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int i0 = I * kTile, j0 = J * kTile;
  const float* P = pos + static_cast<size_t>(rep) * n * 3;
  {
    const int a = i0 + tid, b = j0 + tid;
    rx[tid] = a < n ? P[3 * a + 0] : 0.f;
    ry[tid] = a < n ? P[3 * a + 1] : 0.f;
    rz[tid] = a < n ? P[3 * a + 2] : 0.f;
    cx[tid] = b < n ? P[3 * b + 0] : 0.f;
    cy[tid] = b < n ? P[3 * b + 1] : 0.f;
    cz[tid] = b < n ? P[3 * b + 2] : 0.f;
    for (int q = 0; q < kWarps; ++q)
      col[q][0][tid] = col[q][1][tid] = col[q][2][tid] = 0.f;
  }
  __syncthreads();

  const bool diag = I == J;
  const int i = i0 + tid;  // this lane's row atom
  const bool row_ok = i < n;
  const float xi = rx[tid], yi = ry[tid], zi = rz[tid];
  float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f;
  for (int k = 0; k < kWarps; ++k) {
    // chunk pair (w, c = w + k mod 4); on a diagonal tile k = 3 is the pair
    // (w - 1, w), met by warp w - 1, and k = 2 is met by warps 0 and 1 only
    // (the pairs (0, 2) and (1, 3)). The branch is uniform in the warp.
    if (diag && (k == 3 || (k == 2 && w >= 2))) continue;
    const int c = (w + k) & (kWarps - 1);
    const bool self = diag && k == 0;
    const int s_lo = self ? 1 : 0;
    const int s_hi = self ? 16 : 31;
    float ax = 0.f, ay = 0.f, az = 0.f;  // at step s: column (lane + s) & 31
    for (int s = s_lo; s <= s_hi; ++s) {
      const int jc = c * 32 + ((lane + s) & 31);
      const int j = j0 + jc;
      // the halfway shift of a chunk against itself meets each of its pairs
      // twice: lanes 16..31 hold the pairs lanes 0..15 already count
      const bool live = row_ok && j < n && !(self && s == 16 && lane >= 16);
      if (live) {
        const float dx = xi - cx[jc];
        const float dy = yi - cy[jc];
        const float dz = zi - cz[jc];
        const float d2 = dx * dx + dy * dy + dz * dz;
        float coeff, pot;
        if (pair_at<true>(j * n + i, d2, tab_a, tab_b, tab_c, pc, coeff,
                          pot)) {
          const float gx = coeff * dx, gy = coeff * dy, gz = coeff * dz;
          fx -= gx;
          fy -= gy;
          fz -= gz;
          ax += gx;
          ay += gy;
          az += gz;
          e += pot;
        }
      }
      const int next = (lane + 1) & 31;
      ax = __shfl_sync(kAll, ax, next);
      ay = __shfl_sync(kAll, ay, next);
      az = __shfl_sync(kAll, az, next);
    }
    // the lane now holds column (lane + s_hi + 1) & 31: bring its own home
    const int home = (lane - s_hi - 1) & 31;
    ax = __shfl_sync(kAll, ax, home);
    ay = __shfl_sync(kAll, ay, home);
    az = __shfl_sync(kAll, az, home);
    col[w][0][c * 32 + lane] = ax;
    col[w][1][c * 32 + lane] = ay;
    col[w][2][c * 32 + lane] = az;
  }

  for (int off = 16; off > 0; off >>= 1) e += __shfl_down_sync(kAll, e, off);
  if (lane == 0) warp_e[w] = e;
  __syncthreads();

  float* out = part + (static_cast<size_t>(rep) * n_pairs + p) * 2 * kTile * 3;
  out[3 * tid + 0] = fx;  // tile I, row sums
  out[3 * tid + 1] = fy;
  out[3 * tid + 2] = fz;
  float sx = 0.f, sy = 0.f, sz = 0.f;  // tile J, column sums in warp order
  for (int q = 0; q < kWarps; ++q) {
    sx += col[q][0][tid];
    sy += col[q][1][tid];
    sz += col[q][2][tid];
  }
  out[3 * kTile + 3 * tid + 0] = sx;
  out[3 * kTile + 3 * tid + 1] = sy;
  out[3 * kTile + 3 * tid + 2] = sz;
  if (tid == 0) {
    float total = 0.f;
    for (int q = 0; q < kWarps; ++q) total += warp_e[q];
    e_part[static_cast<size_t>(rep) * n_pairs + p] = total;
  }
}

// Each atom's force: its tile's partials over every tile pair it is part
// of, in the order of the partner tile; each replica's energy: its partial
// energies in tile-pair order.
__global__ void __launch_bounds__(kTile)
pair_tiles_sum(const float* __restrict__ part, const float* __restrict__ e_part,
               float* __restrict__ frc, float* __restrict__ energy, int n,
               int nt) {
  const int rep = blockIdx.x;
  const int T = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_pairs = nt * (nt + 1) / 2;
  const int a = T * kTile + tid;
  if (a < n) {
    float fx = 0.f, fy = 0.f, fz = 0.f;
    for (int u = 0; u < nt; ++u) {
      const int I = min(T, u), J = max(T, u);
      const float* q = part + (static_cast<size_t>(rep) * n_pairs +
                               tile_pair_index(I, J, nt)) *
                                  2 * kTile * 3;
      if (T == I) {
        fx += q[3 * tid + 0];
        fy += q[3 * tid + 1];
        fz += q[3 * tid + 2];
      }
      if (T == J) {
        fx += q[3 * kTile + 3 * tid + 0];
        fy += q[3 * kTile + 3 * tid + 1];
        fz += q[3 * kTile + 3 * tid + 2];
      }
    }
    const size_t o = (static_cast<size_t>(rep) * n + a) * 3;
    frc[o + 0] = fx;
    frc[o + 1] = fy;
    frc[o + 2] = fz;
  }
  if (T == 0 && tid == 0) {
    float total = 0.f;
    for (int q = 0; q < n_pairs; ++q)
      total += e_part[static_cast<size_t>(rep) * n_pairs + q];
    energy[rep] = total;
  }
}

}  // namespace

// pos (R, N, 3) -> frc (R, N, 3), energy (R,); part (R, P, 2, 128, 3) and
// e_part (R, P) are scratch, P = nt (nt + 1) / 2 tile pairs of nt = ceil(N /
// 128) tiles. Returns cudaGetLastError() after each of the two launches.
extern "C" int mdx_pair_tiles(const void* pos, void* frc, void* energy,
                              void* part, void* e_part, const void* tab_a,
                              const void* tab_b, const void* tab_c,
                              int n_replicas, int n_atoms, float cutoff2,
                              float krf, float crf, float switch_dist,
                              float inv_switch_span, void* stream) {
  PairConsts pc{cutoff2, krf, crf, switch_dist, inv_switch_span};
  const int nt = (n_atoms + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  pair_tiles_kernel<<<dim3(n_replicas, nt * (nt + 1) / 2), kTile, 0, s>>>(
      static_cast<const float*>(pos), static_cast<float*>(part),
      static_cast<float*>(e_part), static_cast<const float4*>(tab_a),
      static_cast<const float4*>(tab_b), static_cast<const float*>(tab_c),
      n_atoms, nt, pc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_tiles_sum<<<dim3(n_replicas, nt), kTile, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(e_part),
      static_cast<float*>(frc), static_cast<float*>(energy), n_atoms, nt);
  return static_cast<int>(cudaGetLastError());
}
