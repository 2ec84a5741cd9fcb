// GB-OBC II kernel: polar solvation energy, forces and Born radii, one CTA
// per replica, one thread per atom (strided where N > blockDim).
//
// Replaces: the GB half of molecular_dynamics_tpu/ops/fused_step.py
// (born_pass, _hct_pair/_hct_tail, _gb_uprime, gb_chain_pass, the Born self
// terms) and the Still pair term of molecular_dynamics_tpu/ops/ring.py
// ring_pair_forces(gb=...).
// Bound on an H100: float32 arithmetic, not memory. A replica moves N*3*4
// bytes in and N*4*4+4 out, but needs N(N-1) HCT integrals (a logf and three
// divisions each), N(N-1)/2 Still terms (expf, two with salt) and N(N-1) HCT
// derivatives.
// Design: coordinates in shared memory; three passes over all j per thread
// (Born radii, Still + dE/dR, chain rule) with the per-atom Born radii and
// chain cotangents in shared memory between them; every pair is evaluated
// from both ends, so there is no scatter and no atomic: a launch gives the
// same bits every run. dI/dd is evaluated again in the chain pass instead of
// cached per pair (2 N^2 floats a replica would not fit beside the campaign
// kernel's state, and both kernels share the device functions).
#include <cuda_runtime.h>

#include "gb_terms.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
gb_forces_kernel(const float* __restrict__ pos, float* __restrict__ frc,
                 float* __restrict__ energy, float* __restrict__ born_out,
                 const float* __restrict__ atom, int n, GbConsts c) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* sborn = sz + n;
  float* sce = sborn + n;
  __shared__ float warp_sum[kThreads / 32];

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * 3;
  for (int a = tid; a < n; a += kThreads) {
    sx[a] = pos[base + 3 * a + 0];
    sy[a] = pos[base + 3 * a + 1];
    sz[a] = pos[base + 3 * a + 2];
  }
  __syncthreads();

  for (int i = tid; i < n; i += kThreads) {
    float born, dbdpsi;
    gb_born_pass(i, n, sx, sy, sz, atom, c, born, dbdpsi);
    sborn[i] = born;
    sce[i] = dbdpsi;
    born_out[static_cast<size_t>(blockIdx.x) * n + i] = born;
  }
  __syncthreads();

  float e_thread = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    float fx, fy, fz, der, e_pair, e_self;
    gb_still_pass<true>(i, n, sx, sy, sz, sborn, atom, c, fx, fy, fz, der,
                        e_pair, e_self);
    frc[base + 3 * i + 0] = fx;
    frc[base + 3 * i + 1] = fy;
    frc[base + 3 * i + 2] = fz;
    sce[i] = der * sce[i] * (0.5f * __ldg(&atom[kGbColumns * i + kGbRho]));
    e_thread += 0.5f * e_pair + e_self;  // every pair was counted twice
  }
  __syncthreads();

  for (int i = tid; i < n; i += kThreads) {
    float fx, fy, fz;
    gb_chain_pass(i, n, sx, sy, sz, sce, atom, fx, fy, fz);
    frc[base + 3 * i + 0] += fx;
    frc[base + 3 * i + 1] += fy;
    frc[base + 3 * i + 2] += fz;
  }

  for (int off = 16; off > 0; off >>= 1)
    e_thread += __shfl_down_sync(0xffffffffu, e_thread, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = e_thread;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    energy[blockIdx.x] = total;
  }
}

}  // namespace

// pos (R, N, 3) -> frc (R, N, 3), energy (R,), born (R, N); atom (N, 5) in
// GbColumn order. Returns cudaGetLastError().
extern "C" int mdx_gb_forces(const void* pos, void* frc, void* energy,
                             void* born, const void* atom, int n_replicas,
                             int n_atoms, float inv_eps_s, float kappa,
                             float obc_a, float obc_b, float obc_g,
                             void* stream) {
  GbConsts c{inv_eps_s, kappa, obc_a, obc_b, obc_g};
  const size_t shmem = 5 * static_cast<size_t>(n_atoms) * sizeof(float);
  gb_forces_kernel<<<n_replicas, kThreads, shmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<float*>(frc),
      static_cast<float*>(energy), static_cast<float*>(born),
      static_cast<const float*>(atom), n_atoms, c);
  return static_cast<int>(cudaGetLastError());
}
