// GB-OBC II kernel: polar solvation energy, forces and Born radii, one CTA
// per replica.
//
// Replaces: the GB half of molecular_dynamics_tpu/ops/fused_step.py
// (born_pass, _hct_pair/_hct_tail, _gb_uprime, gb_chain_pass, the Born self
// terms) and the Still pair term of molecular_dynamics_tpu/ops/ring.py
// ring_pair_forces(gb=...).
// Bound on an H100: arithmetic, not memory. A replica moves N*3*4 bytes in
// and N*4*4+4 out, but needs N(N-1) HCT integrals with their derivatives (a
// logf and three divisions each, beside the pair's square root),
// N(N-1)/2 Still terms (expf, two with salt, and a square root) and the
// chain rule; the divisions, roots, logarithms and exponentials go through
// the SFU, which issues 16 a clock an SM against 128 FMAs.
// Design: see gb_terms.cuh. Each HCT integral is evaluated once with its
// derivative, which a shared cache of N(N-1) floats keeps for the chain pass
// (as the TPU kernel caches it); 16 lanes share an atom in every pass.
// Coordinates, forces and the scratch in shared memory; no atomics, so a
// launch gives the same bits every run. The cache holds 236 atoms in 227 KB;
// the second instantiation evaluates the derivatives again in the chain pass
// instead, in 36 bytes an atom (6,456 atoms). The wrapper picks one by size
// (ops/gb.py gb_cached).
#include <cuda_runtime.h>

#include "gb_terms.cuh"
#include "shared_memory.cuh"

namespace {

// 256 rather than 128 threads: more warps to hide the latency of the
// shared-memory and SFU chains (on an H100 K3 takes 17 % less time, K4 29 %;
// chip_smoke.py's levers).
constexpr int kThreads = 256;

template <bool kCached>
__global__ void __launch_bounds__(kThreads)
gb_forces_kernel(const float* __restrict__ pos, float* __restrict__ frc,
                 float* __restrict__ energy, float* __restrict__ born_out,
                 const float* __restrict__ atom, int n, GbConsts c) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* fx = sz + n;
  float* fy = fx + n;
  float* fz = fy + n;
  const GbShared w = gb_carve(fz + n, n);
  __shared__ float warp_sum[kThreads / 32];

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * 3;
  for (int a = tid; a < n; a += kThreads) {
    sx[a] = pos[base + 3 * a + 0];
    sy[a] = pos[base + 3 * a + 1];
    sz[a] = pos[base + 3 * a + 2];
    fx[a] = fy[a] = fz[a] = 0.f;
  }
  __syncthreads();

  float e_thread =
      gb_forces_add<kThreads, true, kCached>(n, sx, sy, sz, atom, c, w, fx, fy, fz);
  for (int a = tid; a < n; a += kThreads) {
    frc[base + 3 * a + 0] = fx[a];
    frc[base + 3 * a + 1] = fy[a];
    frc[base + 3 * a + 2] = fz[a];
    born_out[static_cast<size_t>(blockIdx.x) * n + a] = w.born[a];
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

size_t shared_bytes(int n_atoms, bool cached) {
  return (6 * static_cast<size_t>(n_atoms) + gb_shared_floats(n_atoms, cached)) *
         sizeof(float);
}

template <typename Launch>
int with_kernel(bool cached, Launch launch) {
  return cached ? launch(gb_forces_kernel<true>) : launch(gb_forces_kernel<false>);
}

}  // namespace

// pos (R, N, 3) -> frc (R, N, 3), energy (R,), born (R, N); atom (N, 5) in
// GbColumn order; cached: 1 keeps the dI cache, 0 evaluates the derivatives
// again. Returns cudaGetLastError(), or the error that refused the shared
// memory (the wrapper checks it against SHARED_OPT_IN_BYTES first).
extern "C" int mdx_gb_forces(const void* pos, void* frc, void* energy,
                             void* born, const void* atom, int n_replicas,
                             int n_atoms, int cached, float inv_eps_s,
                             float kappa, float obc_a, float obc_b,
                             float obc_g, void* stream) {
  GbConsts c{inv_eps_s, kappa, obc_a, obc_b, obc_g};
  const size_t shmem = shared_bytes(n_atoms, cached != 0);
  return with_kernel(cached != 0, [&](auto kernel) {
    const int err = allow_dynamic_shared(kernel, shmem);
    if (err != 0) return err;
    kernel<<<n_replicas, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<float*>(frc),
        static_cast<float*>(energy), static_cast<float*>(born),
        static_cast<const float*>(atom), n_atoms, c);
    return static_cast<int>(cudaGetLastError());
  });
}

// Build facts of the kernel at n_atoms with or without the cache, into
// out[0..4] (kernel_occupancy).
extern "C" int mdx_gb_forces_info(int n_atoms, int cached, int* out) {
  return with_kernel(cached != 0, [&](auto kernel) {
    return kernel_occupancy(kernel, kThreads, shared_bytes(n_atoms, cached != 0),
                            out);
  });
}
