// Pair-terms kernel: energy and forces of every 2-body term, one CTA per
// replica, one thread per atom (strided where N > blockDim).
//
// Replaces: molecular_dynamics_tpu/ops/ring.py ring_pair_forces (the
// ring-shift pair loop and its _ring_kernel launcher).
// Bound on an H100: float32 arithmetic, not memory. A replica moves
// N*3*4 bytes in and N*3*4+4 out, but needs N*(N-1)/2 pairs of ~60 flops
// (this design evaluates each from both ends, twice that); the tables (25 bytes a pair in all, 16 for a plain pair) stay
// in L1/L2 and are shared by every CTA.
// Design: coordinates in shared memory, thread i sums over all j != i in a
// fixed order (each pair is computed from both ends: no atomics and no
// scatter, bit-reproducible), energy = half the block-reduced sum.
#include <cuda_runtime.h>

#include "pair_terms.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pair_forces_kernel(const float* __restrict__ pos, float* __restrict__ frc,
                   float* __restrict__ energy, const float4* tab_a,
                   const float4* tab_b, const float* tab_c, int n,
                   PairConsts pc) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  __shared__ float warp_sum[kThreads / 32];

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * 3;
  for (int a = tid; a < n; a += kThreads) {
    sx[a] = pos[base + 3 * a + 0];
    sy[a] = pos[base + 3 * a + 1];
    sz[a] = pos[base + 3 * a + 2];
  }
  __syncthreads();

  float e_thread = 0.f;
  for (int a = tid; a < n; a += kThreads) {
    float fx, fy, fz, e;
    atom_pair_sum<true>(a, n, sx, sy, sz, tab_a, tab_b, tab_c, pc, fx, fy, fz,
                        e);
    frc[base + 3 * a + 0] = fx;
    frc[base + 3 * a + 1] = fy;
    frc[base + 3 * a + 2] = fz;
    e_thread += e;
  }
  for (int off = 16; off > 0; off >>= 1)
    e_thread += __shfl_down_sync(0xffffffffu, e_thread, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = e_thread;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    energy[blockIdx.x] = 0.5f * total;  // every pair was counted twice
  }
}

}  // namespace

// pos (R, N, 3) -> frc (R, N, 3), energy (R,). Returns cudaGetLastError().
extern "C" int mdx_pair_forces(const void* pos, void* frc, void* energy,
                               const void* tab_a, const void* tab_b,
                               const void* tab_c, int n_replicas, int n_atoms,
                               float cutoff2, float krf, float crf,
                               float switch_dist, float inv_switch_span,
                               void* stream) {
  PairConsts pc{cutoff2, krf, crf, switch_dist, inv_switch_span};
  const size_t shmem = 3 * static_cast<size_t>(n_atoms) * sizeof(float);
  pair_forces_kernel<<<n_replicas, kThreads, shmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<float*>(frc),
      static_cast<float*>(energy), static_cast<const float4*>(tab_a),
      static_cast<const float4*>(tab_b), static_cast<const float*>(tab_c),
      n_atoms, pc);
  return static_cast<int>(cudaGetLastError());
}
