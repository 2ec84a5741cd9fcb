// Dense-row pair kernel (K5): energy and forces of every 2-body term, each
// atom's row summed from its own end, per-row half energies.
//
// Replaces: molecular_dynamics_tpu/ops/nonbonded.py make_nonbonded_op ->
// _kernel -> dense_pair_forces (the dense masked (N, N) pass and its tables;
// its lane padding and its block_r replica blocks stay behind).
// Bound on an H100: float32 arithmetic. A replica moves N*3*4 bytes in and
// N*4*4 out and needs a test of ~9 flops for each plain pair of the chunk
// pairs whose boxes lie within the cutoff, ~70 more for each pair inside it;
// a row design makes both from each end, twice the least. Its parameters are
// the per-atom layout of pair_loop.cuh (no N x N table).
// Design: one launch, grid (replica, group of kWarps row chunks); the CTA
// stages its replica's coordinates and every chunk's bounding box in shared
// memory. A warp takes a row chunk (pair_loop.cuh's 32-atom chunks), a lane
// one row atom, and walks the column chunks in order, skipping those whose
// box lies beyond the cutoff from the row chunk's; in a chunk every lane
// meets the same partner at a step (a broadcast from shared memory), tests
// its exclusion bit and the cutoff, and only then reads the partner's
// parameters. Then the atom's special pairs from its list (from both ends;
// the energy at the first). Each lane sums its own atom in a fixed order: no
// partial buffer, no second pass, no atomics, the same bits every run. A
// plain pair's energy counts half at each end.
#include <cuda_runtime.h>

#include "pair_loop.cuh"
#include "shared_memory.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// coordinates and every chunk's box: 4,096 atoms take 52 KB (the opt-in)
size_t shared_bytes(int n) {
  return (3 * static_cast<size_t>(n) + 6 * chunk_count(n)) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
nonbonded_rows_kernel(const float* __restrict__ pos, float* __restrict__ frc,
                      float* __restrict__ e_rows, PairLayout L, int n,
                      PairConsts pc) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* box = sz + n;

  const int rep = blockIdx.x;
  const size_t base = static_cast<size_t>(rep) * n * 3;
  for (int a = threadIdx.x; a < n; a += kThreads) {
    sx[a] = pos[base + 3 * a + 0];
    sy[a] = pos[base + 3 * a + 1];
    sz[a] = pos[base + 3 * a + 2];
  }
  __syncthreads();
  chunk_boxes<kThreads>(n, sx, sy, sz, box);
  __syncthreads();

  const int cs = chunk_size(n), nc = chunk_count(n);
  const int lane = threadIdx.x & 31;
  for (int I = blockIdx.y * kWarps + (threadIdx.x >> 5); I < nc;
       I += gridDim.y * kWarps) {
    const int a = I * cs + lane;
    if (lane >= cs || a >= n) continue;
    const float xi = sx[a], yi = sy[a], zi = sz[a];
    const int ti = __ldg(&L.lj_type[a]) * L.n_types;
    const float qi = __ldg(&L.charge[a]);
    const unsigned* words = L.excl + static_cast<size_t>(a) * nc;
    float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f;
    for (int J = 0; J < nc; ++J) {
      if (boxes_apart(box, I, J, pc.cutoff2)) continue;
      const unsigned word = __ldg(&words[J]);
      for (int t = 0; t < cs; ++t) {
        if ((word >> t) & 1u) continue;
        const int b = J * cs + t;
        const float dx = xi - sx[b];
        const float dy = yi - sy[b];
        const float dz = zi - sz[b];
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 > pc.cutoff2) continue;
        const float2 lj = __ldg(&L.lj_table[ti + __ldg(&L.lj_type[b])]);
        float coeff, pot = 0.f;
        pair_term<true, false>(d2, qi * __ldg(&L.charge[b]), lj.x, lj.y, 1.f,
                               0.f, 0.f, 0.f, 0.f, 0.f, pc, coeff, pot);
        fx -= coeff * dx;
        fy -= coeff * dy;
        fz -= coeff * dz;
        e += pot;
      }
    }
    e *= 0.5f;  // the partner counts the other half
    special_sum<true>(a, sx, sy, sz, L, pc, fx, fy, fz, e);
    frc[base + 3 * a + 0] = fx;
    frc[base + 3 * a + 1] = fy;
    frc[base + 3 * a + 2] = fz;
    e_rows[static_cast<size_t>(rep) * n + a] = e;
  }
}

}  // namespace

// pos (R, N, 3) -> frc (R, N, 3), e_rows (R, N) (their sum over N is the
// replica's energy). `layout` holds the device pointers of ops/nonbonded.py
// PAIR_LAYOUT_SLOTS in order. Returns cudaGetLastError(), or the error that
// refused more shared memory than a CTA may opt in to (the wrapper checks
// first).
extern "C" int mdx_nonbonded_rows(const void* pos, void* frc, void* e_rows,
                                  const void* const* layout, int n_types,
                                  int n_replicas, int n_atoms, float cutoff2,
                                  float krf, float crf, float switch_dist,
                                  float inv_switch_span, void* stream) {
  PairConsts pc{cutoff2, krf, crf, switch_dist, inv_switch_span};
  const size_t shmem = shared_bytes(n_atoms);
  const int err = allow_dynamic_shared(nonbonded_rows_kernel, shmem);
  if (err != 0) return err;
  const dim3 grid(n_replicas, (chunk_count(n_atoms) + kWarps - 1) / kWarps);
  nonbonded_rows_kernel<<<grid, kThreads, shmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<float*>(frc),
      static_cast<float*>(e_rows), pair_layout_of(layout, n_types), n_atoms,
      pc);
  return static_cast<int>(cudaGetLastError());
}

// Build facts of the kernel for n_atoms into out[0..4] (kernel_occupancy in
// shared_memory.cuh).
extern "C" int mdx_nonbonded_rows_info(int n_atoms, int* out) {
  return kernel_occupancy(nonbonded_rows_kernel, kThreads,
                          shared_bytes(n_atoms), out);
}
