// Pair-forces kernel: energy and forces of every 2-body term, one CTA per
// replica; the standalone launch of the campaign kernel's pair loop.
//
// Replaces: molecular_dynamics_tpu/ops/ring.py ring_pair_forces (the
// ring-shift pair loop and its _ring_kernel launcher).
// Bound on an H100: float32 arithmetic. A replica moves N*3*4 bytes in and
// N*3*4+4 out and needs a test of ~9 flops for each plain pair of the chunk
// pairs whose boxes lie within the cutoff (N*(N-1)/2 at most), ~70 more for
// each pair inside the cutoff; its parameters are per-atom arrays and a
// small LJ type table that stay in L1 (no N x N table).
// Design: coordinates and the column sums in shared memory, the pair loop of
// pair_loop.cuh (each unordered pair once, 32-atom chunks met warp by warp,
// rounds closed by barriers, far chunk pairs skipped), then one pass an atom:
// its row sums, its column sums and its special pairs in a fixed order. The
// energy is each lane's sum, reduced in a fixed order. No atomics:
// bit-reproducible. The campaign kernel's CTA shape: 128, 512 or 1024
// threads by size, up to 2,048 atoms.
#include <cuda_runtime.h>

#include "pair_loop.cuh"
#include "shared_memory.cuh"

namespace {

template <int kThreads, int kMaxQ>
__global__ void __launch_bounds__(kThreads)
pair_forces_kernel(const float* __restrict__ pos, float* __restrict__ frc,
                   float* __restrict__ energy, PairLayout L, int n,
                   PairConsts pc) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* fx = sz + n;
  float* fy = fx + n;
  float* fz = fy + n;
  float* box = fz + n;
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
  chunk_boxes<kThreads>(n, sx, sy, sz, box);
  __syncthreads();

  float rx[kMaxQ], ry[kMaxQ], rz[kMaxQ];
  float e_thread = pair_rounds<kThreads, kMaxQ, true>(n, sx, sy, sz, fx, fy,
                                                      fz, box, L, pc, rx, ry,
                                                      rz);
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    const int a = row_atom<kThreads>(n, q);
    if (a < 0) continue;
    float gx = fx[a] + rx[q], gy = fy[a] + ry[q], gz = fz[a] + rz[q];
    special_sum<true>(a, sx, sy, sz, L, pc, gx, gy, gz, e_thread);
    frc[base + 3 * a + 0] = gx;
    frc[base + 3 * a + 1] = gy;
    frc[base + 3 * a + 2] = gz;
  }
  for (int off = 16; off > 0; off >>= 1)
    e_thread += __shfl_down_sync(kAllLanes, e_thread, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = e_thread;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    energy[blockIdx.x] = total;
  }
}

using PairKernel = void (*)(const float*, float*, float*, PairLayout, int,
                            PairConsts);

// The instantiation for n atoms and its threads a CTA: the campaign
// kernel's shape (pair_loop_shape in pair_loop.cuh); nullptr past 2,048
// atoms.
PairKernel pick_kernel(int n, int& threads) {
  switch (pair_loop_shape(n)) {
    case kSmallCta:
      threads = kSmallThreads;
      return pair_forces_kernel<kSmallThreads, chunks_per_warp(kSmallThreads)>;
    case kMediumCta:
      threads = kMediumThreads;
      return pair_forces_kernel<kMediumThreads,
                                chunks_per_warp(kMediumThreads)>;
    case kLargeCta:
      threads = kLargeThreads;
      return pair_forces_kernel<kLargeThreads, chunks_per_warp(kLargeThreads)>;
    default:
      threads = 0;
      return nullptr;
  }
}

size_t shared_bytes(int n) {
  return (6 * static_cast<size_t>(n) + 6 * chunk_count(n)) * sizeof(float);
}

}  // namespace

// pos (R, N, 3) -> frc (R, N, 3), energy (R,). `layout` holds the device
// pointers of ops/nonbonded.py PAIR_LAYOUT_SLOTS in order. Returns
// cudaGetLastError(), or the error that refused the launch (a size the
// kernel does not hold: cudaErrorInvalidValue; the wrapper checks first).
extern "C" int mdx_pair_forces(const void* pos, void* frc, void* energy,
                               const void* const* layout, int n_types,
                               int n_replicas, int n_atoms, float cutoff2,
                               float krf, float crf, float switch_dist,
                               float inv_switch_span, void* stream) {
  PairConsts pc{cutoff2, krf, crf, switch_dist, inv_switch_span};
  int threads;
  const PairKernel kernel = pick_kernel(n_atoms, threads);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = shared_bytes(n_atoms);
  const int err = allow_dynamic_shared(kernel, shmem);
  if (err != 0) return err;
  kernel<<<n_replicas, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<float*>(frc),
      static_cast<float*>(energy), pair_layout_of(layout, n_types), n_atoms,
      pc);
  return static_cast<int>(cudaGetLastError());
}

// Build facts of the instantiation for n_atoms into out[0..4]
// (kernel_occupancy in shared_memory.cuh).
extern "C" int mdx_pair_forces_info(int n_atoms, int* out) {
  int threads;
  const PairKernel kernel = pick_kernel(n_atoms, threads);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return kernel_occupancy(kernel, threads, shared_bytes(n_atoms), out);
}
