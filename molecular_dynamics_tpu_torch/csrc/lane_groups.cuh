// Groups of kLanes consecutive lanes (a power of two that divides 32) that
// share one row's partner range: the Born and chain passes of GB, the area
// and force passes of LCPO. Every lane of the warp calls group_sum, also a
// lane whose row lies past the end; the butterfly adds in a fixed order, so
// lane 0 of a group gets the same bits every run (the other lanes may round
// differently and are not read).
#pragma once

template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
  static_assert(kLanes > 0 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
                "a group is a power of two of lanes inside one warp");
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
