// Dense pair kernel: energy and forces of every 2-body term, every pair
// evaluated from both ends, per-row half energies.
//
// Replaces: molecular_dynamics_tpu/ops/nonbonded.py make_nonbonded_op ->
// _kernel -> dense_pair_forces (the dense masked (N, N) pass; its lane
// padding and its block_r replica blocks stay behind).
// Bound on an H100: float32 arithmetic at every size (N*(N-1)/2 pairs of ~60
// flops a replica, evaluated twice here). The tables cost 16 bytes an
// ordered pair (20 more where it carries a bond or 1-4 term): 17.3 MB at
// 1,040 atoms, read by every replica's CTAs of a row tile through L2.
// Design: grid (replica, tile of 128 rows), so that 96 replicas of 1,040
// atoms still make 864 CTAs. A CTA stages its replica's coordinates in shared
// memory; thread i sums over all j in a fixed order (atom_pair_sum of
// pair_terms.cuh), reading entry [j * N + i] so that a warp's table loads
// are contiguous, and writes its atom's force
// and half its pair energies. No atomics: bit-reproducible. CTAs of one tile
// on neighbouring replicas read the same table rows, which keeps them in L2.
#include <cuda_runtime.h>

#include "pair_terms.cuh"

namespace {

constexpr int kRowTile = 128;

__global__ void __launch_bounds__(kRowTile)
nonbonded_rows_kernel(const float* __restrict__ pos, float* __restrict__ frc,
                      float* __restrict__ e_rows, const float4* tab_a,
                      const float4* tab_b, const float* tab_c, int n,
                      PairConsts pc) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;

  const int rep = blockIdx.x;
  const size_t base = static_cast<size_t>(rep) * n * 3;
  for (int a = threadIdx.x; a < n; a += kRowTile) {
    sx[a] = pos[base + 3 * a + 0];
    sy[a] = pos[base + 3 * a + 1];
    sz[a] = pos[base + 3 * a + 2];
  }
  __syncthreads();

  const int i = blockIdx.y * kRowTile + threadIdx.x;
  if (i >= n) return;
  float fx, fy, fz, e;
  atom_pair_sum<true>(i, n, sx, sy, sz, tab_a, tab_b, tab_c, pc, fx, fy, fz,
                      e);
  frc[base + 3 * i + 0] = fx;
  frc[base + 3 * i + 1] = fy;
  frc[base + 3 * i + 2] = fz;
  e_rows[static_cast<size_t>(rep) * n + i] = 0.5f * e;  // each pair twice
}

}  // namespace

// pos (R, N, 3) -> frc (R, N, 3), e_rows (R, N). Returns cudaGetLastError(),
// or -1 when the coordinates do not fit in 48 KB of shared memory.
extern "C" int mdx_nonbonded_rows(const void* pos, void* frc, void* e_rows,
                                  const void* tab_a, const void* tab_b,
                                  const void* tab_c, int n_replicas,
                                  int n_atoms, float cutoff2, float krf,
                                  float crf, float switch_dist,
                                  float inv_switch_span, void* stream) {
  PairConsts pc{cutoff2, krf, crf, switch_dist, inv_switch_span};
  const size_t shmem = 3 * static_cast<size_t>(n_atoms) * sizeof(float);
  if (shmem > 48 * 1024) return -1;
  const dim3 grid(n_replicas, (n_atoms + kRowTile - 1) / kRowTile);
  nonbonded_rows_kernel<<<grid, kRowTile, shmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<float*>(frc),
      static_cast<float*>(e_rows), static_cast<const float4*>(tab_a),
      static_cast<const float4*>(tab_b), static_cast<const float*>(tab_c),
      n_atoms, pc);
  return static_cast<int>(cudaGetLastError());
}
