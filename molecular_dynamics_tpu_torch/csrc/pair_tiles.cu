// Pair-tile kernel (K6): energy and forces of every 2-body term, each
// unordered pair evaluated once, a replica's work split over several CTAs.
//
// Replaces: molecular_dynamics_tpu/ops/ring.py make_pair_ring_op ->
// _ring_kernel / _ring_chunk_kernel (the ring-shift pass over lane-padded
// rows and its dense tables; its shift chunks exist to bound Mosaic's compile
// time and stay behind).
// Bound on an H100: float32 arithmetic. A replica moves N*3*4 bytes in and
// N*3*4+4 out and needs a test of ~9 flops for each plain pair of the chunk
// pairs whose boxes lie within the cutoff, ~70 more for each pair inside it;
// its parameters are the per-atom layout of pair_loop.cuh (no N x N table).
// Design: the tasks of pair_loop.cuh (32-atom chunks met warp by warp, the
// partner's force accumulator rotating through the lanes, the exclusion bit
// and the cutoff tested before any parameter is read, far chunk pairs
// skipped), split into groups: the chunks into tiles of kTileChunks, and a
// CTA of one warp a chunk takes one replica and one pair of tiles A <= B (45
// groups at 1,040 atoms, so that 96 replicas fill the card where the
// pair-forces kernel runs one CTA a replica). It holds the two tiles'
// coordinates and boxes in shared memory. Warp w keeps the rows of chunk w
// of tile A in registers and meets every chunk of tile B (on the diagonal
// group, the tile's own chunks as pair_rounds does: itself, then (w, w + k)
// for k = 1..chunks/2), adding the column sums into its own shared array, so
// that no warp waits on another until the group's end; the arrays are then
// summed in warp order. The diagonal group also adds each of its atoms'
// special pairs (from both ends, the energy at the first). A group whose
// chunk pairs all lie beyond the cutoff writes only its flag; the others
// write their atoms' partial forces and a partial energy, and a second
// kernel sums each atom's partials over the groups in a fixed order,
// skipping the empty ones. With one group (up to kTileChunks chunks) the CTA
// writes the result itself and the second kernel is not launched. No
// atomics: the same bits every run.
#include <cuda_runtime.h>

#include "pair_loop.cuh"
#include "shared_memory.cuh"

namespace {

// chunks a tile, and warps a CTA (chip_smoke.py's levers time other sizes)
constexpr int kTileChunks = 4;
constexpr int kThreads = kTileChunks * 32;
// CTAs an SM the register cap allows: 1024 threads, 64 registers a thread
constexpr int kCtasPerSm = 1024 / kThreads;
// a tile's slots in the partial forces
constexpr int kTileAtoms = kTileChunks * kChunk;

__host__ __device__ inline int tile_count(int n) {
  return (chunk_count(n) + kTileChunks - 1) / kTileChunks;
}

__host__ __device__ inline int group_count(int n) {
  const int nt = tile_count(n);
  return nt * (nt + 1) / 2;
}

// index of the group (A, B), A <= B, in row-major upper-triangle order
__device__ __forceinline__ int group_index(int A, int B, int nt) {
  return A * nt - A * (A - 1) / 2 + (B - A);
}

// whether two chunks with the boxes p and q may hold a pair within the cutoff
__device__ __forceinline__ bool near_chunks(const float* p, const float* q,
                                            float cutoff2) {
  return !boxes_apart(p, q, cutoff2);
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
pair_tiles_kernel(const float* __restrict__ pos, float* __restrict__ frc,
                  float* __restrict__ energy, float* __restrict__ part,
                  float* __restrict__ e_part, int* __restrict__ live,
                  PairLayout L, int n, PairConsts pc) {
  __shared__ float ax[kTileAtoms], ay[kTileAtoms], az[kTileAtoms];  // tile A
  __shared__ float bx[kTileAtoms], by[kTileAtoms], bz[kTileAtoms];  // tile B
  // each warp's column sums of tile B (of tile A on the diagonal)
  __shared__ float cx[kTileChunks][kTileAtoms], cy[kTileChunks][kTileAtoms],
      cz[kTileChunks][kTileAtoms];
  __shared__ float box[2 * kTileChunks * 6];  // tile A's chunks, then B's
  __shared__ float warp_e[kTileChunks];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int rep = blockIdx.x;
  const int cs = chunk_size(n), nc = chunk_count(n), nt = tile_count(n);
  const int n_groups = group_count(n);
  const float* P = pos + static_cast<size_t>(rep) * n * 3;
  float* const box_b = box + 6 * kTileChunks;

  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    int A = 0, rem = g;
    while (rem >= nt - A) {
      rem -= nt - A;
      ++A;
    }
    const int B = A + rem;
    const bool diag = A == B;
    const int ca = A * kTileChunks, cb = B * kTileChunks;  // first chunks
    const int na = min(kTileChunks, nc - ca), nb = min(kTileChunks, nc - cb);
    const int a0 = ca * cs, b0 = cb * cs;  // first atoms
    {
      const int a = a0 + tid, b = b0 + tid;
      const bool in_a = tid < na * cs && a < n, in_b = tid < nb * cs && b < n;
      ax[tid] = in_a ? P[3 * a + 0] : 0.f;
      ay[tid] = in_a ? P[3 * a + 1] : 0.f;
      az[tid] = in_a ? P[3 * a + 2] : 0.f;
      if (!diag) {  // the diagonal group reads tile A twice
        bx[tid] = in_b ? P[3 * b + 0] : 0.f;
        by[tid] = in_b ? P[3 * b + 1] : 0.f;
        bz[tid] = in_b ? P[3 * b + 2] : 0.f;
      }
    }
    __syncthreads();
    chunk_boxes<kThreads>(n, ca, na, ax, ay, az, box);
    if (!diag) chunk_boxes<kThreads>(n, cb, nb, bx, by, bz, box_b);
    __syncthreads();
    // a chunk always meets itself; an off-diagonal group may meet nothing
    bool any = diag;
    if (!diag && tid < na * nb)
      any = near_chunks(box + 6 * (tid / nb), box_b + 6 * (tid % nb),
                        pc.cutoff2);
    if (!__syncthreads_or(any)) {
      if (tid == 0) live[static_cast<size_t>(rep) * n_groups + g] = 0;
      continue;
    }

    float rx = 0.f, ry = 0.f, rz = 0.f, e = 0.f;
    const int r0 = w * cs;  // this warp's row chunk in tile A
    float *const sx = cx[w], *const sy = cy[w], *const sz = cz[w];
    for (int l = lane; l < kTileAtoms; l += 32) sx[l] = sy[l] = sz[l] = 0.f;
    __syncwarp();
    if (w < na && diag) {
      chunk_task<true>(ca + w, ca + w, n, ax + r0, ay + r0, az + r0, ax + r0,
                       ay + r0, az + r0, sx + r0, sy + r0, sz + r0, L, pc, rx,
                       ry, rz, e);
      for (int k = 1; k <= na / 2; ++k) {
        const int j = (w + k) % na, c0 = j * cs;
        if (!(2 * k == na && w >= k) &&
            near_chunks(box + 6 * w, box + 6 * j, pc.cutoff2))
          chunk_task<true>(ca + w, ca + j, n, ax + r0, ay + r0, az + r0,
                           ax + c0, ay + c0, az + c0, sx + c0, sy + c0,
                           sz + c0, L, pc, rx, ry, rz, e);
      }
    } else if (w < na) {
      for (int j = 0; j < nb; ++j) {
        const int c0 = j * cs;
        if (near_chunks(box + 6 * w, box_b + 6 * j, pc.cutoff2))
          chunk_task<true>(ca + w, cb + j, n, ax + r0, ay + r0, az + r0,
                           bx + c0, by + c0, bz + c0, sx + c0, sy + c0,
                           sz + c0, L, pc, rx, ry, rz, e);
      }
    }
    __syncthreads();

    // this group's part: the row sums of tile A (on the diagonal with the
    // column sums of the same tile and the special pairs), then the column
    // sums of tile B
    const size_t slot =
        (static_cast<size_t>(rep) * n_groups + g) * 2 * kTileAtoms * 3;
    const int l = r0 + lane, a = a0 + l;
    if (w < na && lane < cs && a < n) {
      float fx = rx, fy = ry, fz = rz;
      if (diag) {
        for (int q = 0; q < kTileChunks; ++q) {
          fx += cx[q][l];
          fy += cy[q][l];
          fz += cz[q][l];
        }
        special_pairs<true>(a, AosCoords{P}, L, pc, fx, fy, fz, e);
      }
      float* out = n_groups == 1
                       ? frc + (static_cast<size_t>(rep) * n + a) * 3
                       : part + slot + 3 * l;
      out[0] = fx;
      out[1] = fy;
      out[2] = fz;
    }
    if (!diag && tid < nb * cs && b0 + tid < n) {
      float fx = 0.f, fy = 0.f, fz = 0.f;
      for (int q = 0; q < kTileChunks; ++q) {
        fx += cx[q][tid];
        fy += cy[q][tid];
        fz += cz[q][tid];
      }
      float* out = part + slot + 3 * kTileAtoms + 3 * tid;
      out[0] = fx;
      out[1] = fy;
      out[2] = fz;
    }
    for (int off = 16; off > 0; off >>= 1)
      e += __shfl_down_sync(kAllLanes, e, off);
    if (lane == 0) warp_e[w] = e;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int q = 0; q < kTileChunks; ++q) total += warp_e[q];
      if (n_groups == 1) {
        energy[rep] = total;
      } else {
        e_part[static_cast<size_t>(rep) * n_groups + g] = total;
        live[static_cast<size_t>(rep) * n_groups + g] = 1;
      }
    }
    __syncthreads();  // the next group reuses the shared arrays
  }
}

// Each atom's force: its tile's parts over every group it belongs to, in the
// order of the partner tile, skipping the groups that met nothing; each
// replica's energy: its partial energies in group order.
__global__ void __launch_bounds__(kThreads)
pair_tiles_sum(const float* __restrict__ part, const float* __restrict__ e_part,
               const int* __restrict__ live, float* __restrict__ frc,
               float* __restrict__ energy, int n) {
  const int rep = blockIdx.x;
  const int T = blockIdx.y;
  const int tid = threadIdx.x;
  const int cs = chunk_size(n), nt = tile_count(n);
  const int n_groups = group_count(n);
  const size_t first = static_cast<size_t>(rep) * n_groups;
  const int nat = min(kTileChunks, chunk_count(n) - T * kTileChunks) * cs;
  const int a = T * kTileChunks * cs + tid;
  if (tid < nat && a < n) {
    float fx = 0.f, fy = 0.f, fz = 0.f;
    for (int u = 0; u < nt; ++u) {
      const int A = min(T, u), B = max(T, u);
      const size_t g = first + group_index(A, B, nt);
      if (!live[g]) continue;
      const float* q =
          part + g * 2 * kTileAtoms * 3 + (T == A ? 0 : 3 * kTileAtoms);
      fx += q[3 * tid + 0];
      fy += q[3 * tid + 1];
      fz += q[3 * tid + 2];
    }
    const size_t o = (static_cast<size_t>(rep) * n + a) * 3;
    frc[o + 0] = fx;
    frc[o + 1] = fy;
    frc[o + 2] = fz;
  }
  if (T == 0 && tid == 0) {
    float total = 0.f;
    for (int g = 0; g < n_groups; ++g)
      if (live[first + g]) total += e_part[first + g];
    energy[rep] = total;
  }
}

}  // namespace

// The scratch a launch for n_atoms needs a replica, into out[0..1]: groups,
// and floats of partial forces a group (e_part and live take one entry a
// group). With one group the launch uses no scratch.
extern "C" int mdx_pair_tiles_scratch(int n_atoms, int* out) {
  out[0] = group_count(n_atoms);
  out[1] = 2 * kTileAtoms * 3;
  return 0;
}

// pos (R, N, 3) -> frc (R, N, 3), energy (R,); part (R, G, 2, kTileAtoms, 3),
// e_part (R, G) and live (R, G) int are scratch (mdx_pair_tiles_scratch),
// unread with one group. `layout` holds the device pointers of
// ops/nonbonded.py PAIR_LAYOUT_SLOTS in order. Returns cudaGetLastError()
// after each launch.
extern "C" int mdx_pair_tiles(const void* pos, void* frc, void* energy,
                              void* part, void* e_part, void* live,
                              const void* const* layout, int n_types,
                              int n_replicas, int n_atoms, float cutoff2,
                              float krf, float crf, float switch_dist,
                              float inv_switch_span, void* stream) {
  PairConsts pc{cutoff2, krf, crf, switch_dist, inv_switch_span};
  const int n_groups = group_count(n_atoms);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  pair_tiles_kernel<<<dim3(n_replicas, n_groups), kThreads, 0, s>>>(
      static_cast<const float*>(pos), static_cast<float*>(frc),
      static_cast<float*>(energy), static_cast<float*>(part),
      static_cast<float*>(e_part), static_cast<int*>(live),
      pair_layout_of(layout, n_types), n_atoms, pc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_groups == 1) return static_cast<int>(err);
  pair_tiles_sum<<<dim3(n_replicas, tile_count(n_atoms)), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(e_part),
      static_cast<const int*>(live), static_cast<float*>(frc),
      static_cast<float*>(energy), n_atoms);
  return static_cast<int>(cudaGetLastError());
}

// Build facts of the group kernel into out[0..4] (kernel_occupancy in
// shared_memory.cuh); it takes no dynamic shared memory at any size.
extern "C" int mdx_pair_tiles_info(int n_atoms, int* out) {
  (void)n_atoms;
  return kernel_occupancy(pair_tiles_kernel, kThreads, 0, out);
}
