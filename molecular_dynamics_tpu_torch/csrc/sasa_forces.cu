// LCPO SASA kernel: nonpolar solvation energy and forces, one CTA per
// replica.
//
// Replaces: molecular_dynamics_tpu/ops/fused_step.py _sasa_tables and
// sasa_pass / _sasa_chunk (the dense (CH, lc, lc) pass with its MXU
// products).
// Bound on an H100: float32 arithmetic, not memory. A replica moves N*3*4
// bytes in and N*3*4+4 out; it needs nc(nc-1)/2 pair geometries (a square
// root and a division each) and, for every overlapping ordered pair, two sums
// over the neighbours its two atoms share.
// Design: see sasa_terms.cuh. Coordinates, forces and the pass's per-atom
// scratch (overlap bit masks, counts, offsets) in shared memory; the
// per-atom neighbour lists there too where they fit beside them, else in a
// global workspace of sasa_list_words(nc) words a replica
// (kListsGlobal). Every sum a gather in a fixed order, no atomics. A list
// that would overflow sets a flag in global memory, which the wrapper raises
// on.
#include <cuda_runtime.h>

#include "sasa_terms.cuh"
#include "shared_memory.cuh"

namespace {

// 256 rather than 128 threads: more warps to hide the latency of the
// shared-memory and SFU chains (on an H100 K3 takes 17 % less time, K4 29 %;
// chip_smoke.py's levers).
constexpr int kThreads = 256;

template <bool kListsGlobal>
__global__ void __launch_bounds__(kThreads)
sasa_forces_kernel(const float* __restrict__ pos, float* __restrict__ frc,
                   float* __restrict__ energy, const int* __restrict__ idx,
                   const float* __restrict__ atom, int n, int nc,
                   float gamma, int* __restrict__ overflow, float* lists) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* fx = sz + n;
  float* fy = fx + n;
  float* fz = fy + n;
  const SasaShared w = sasa_carve(
      fz + n, nc,
      kListsGlobal ? lists + blockIdx.x * sasa_list_words(nc) : nullptr);
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

  float e_thread = sasa_forces_add<kThreads, true>(
      nc, idx, atom, gamma, sx, sy, sz, w, fx, fy, fz, overflow);
  for (int a = tid; a < n; a += kThreads) {
    frc[base + 3 * a + 0] = fx[a];
    frc[base + 3 * a + 1] = fy[a];
    frc[base + 3 * a + 2] = fz[a];
  }
  for (int off = 16; off > 0; off >>= 1)
    e_thread += __shfl_down_sync(0xffffffffu, e_thread, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = e_thread;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int wp = 0; wp < kThreads / 32; ++wp) total += warp_sum[wp];
    energy[blockIdx.x] = total;
  }
}

size_t shared_bytes(int n_atoms, int n_compact, bool lists_global) {
  return (6 * static_cast<size_t>(n_atoms) +
          sasa_shared_words(n_compact, lists_global)) *
         sizeof(float);
}

}  // namespace

// pos (R, N, 3) -> frc (R, N, 3), energy (R,); idx (nc,) int32 and atom
// (nc, 5) in SasaColumn order; overflow: one device int, set to 1 when a
// neighbour list overflows (the forces are then wrong); lists: null, or the
// lists' global workspace, R * sasa_list_words(nc) floats (no clearing
// needed). Returns cudaGetLastError(), or the error that refused the shared
// memory (the wrapper checks it against SHARED_OPT_IN_BYTES first).
extern "C" int mdx_sasa_forces(const void* pos, void* frc, void* energy,
                               const void* idx, const void* atom,
                               int n_replicas, int n_atoms, int n_compact,
                               float gamma, void* overflow, void* lists,
                               void* stream) {
  const bool global = lists != nullptr;
  const size_t shmem = shared_bytes(n_atoms, n_compact, global);
  const auto kernel =
      global ? sasa_forces_kernel<true> : sasa_forces_kernel<false>;
  const int err = allow_dynamic_shared(kernel, shmem);
  if (err != 0) return err;
  kernel<<<n_replicas, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<float*>(frc),
      static_cast<float*>(energy), static_cast<const int*>(idx),
      static_cast<const float*>(atom), n_atoms, n_compact, gamma,
      static_cast<int*>(overflow), static_cast<float*>(lists));
  return static_cast<int>(cudaGetLastError());
}

// Build facts of the kernel at (n_atoms, n_compact), with the lists in
// global memory where lists_global, into out[0..4] (kernel_occupancy).
extern "C" int mdx_sasa_forces_info(int n_atoms, int n_compact,
                                    int lists_global, int* out) {
  const bool global = lists_global != 0;
  return kernel_occupancy(
      global ? sasa_forces_kernel<true> : sasa_forces_kernel<false>, kThreads,
      shared_bytes(n_atoms, n_compact, global), out);
}
