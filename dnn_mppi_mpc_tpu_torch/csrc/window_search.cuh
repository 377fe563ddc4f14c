// The nearest-waypoint search of the rollouts, split across a lane group:
// the one copy of the running-min rule that the diff-drive rollout
// (diffdrive_rollout.cuh), the race-car rollout (bicycle_rollout.cuh) and
// the generic rollout share, and the carried search of
// waypoint_carry="rollout" (dmm_carried_row). G consecutive lanes of a warp (G a power of two, 1 to 16) share one
// sample; G = 1 is one lane a sample, the sequential scan itself.
#pragma once

#include <climits>
#include <cmath>

constexpr unsigned kFullMask = 0xffffffffu;

// The window row of the running min over the whole window, from lane
// `lane`'s running min over rows i ≡ lane (mod G): the lane of row 0 starts
// from row 0's d, NaN or not, every other lane from (+∞, W), and a row
// replaces the partial only by a strict <. Rounds of xor shuffles then
// merge (d, row): the smaller d wins, on a tie the smaller row, and a NaN
// partial (only row 0's can be one) wins over all. That is the row of the
// sequential scan (row 0 unless a later row is strictly less than all
// before it), so every lane of the group returns it, with its d.
template <int G>
__device__ __forceinline__ int dmm_window_row(int W, int lane, float x, float y,
                                              const float2* sxy, float* d_out) {
  static_assert(G >= 1 && G <= 16 && (G & (G - 1)) == 0, "G: a power of two, 1 to 16");
  float dmin = INFINITY;
  int imin = W;
  int i = lane;
  if (lane == 0) {
    const float2 r = sxy[0];
    const float dx = x - r.x;
    const float dy = y - r.y;
    dmin = dx * dx + dy * dy;
    imin = 0;
    i = G;
  }
#pragma unroll 8  // eight shared-memory loads in flight together (root PERF.md §6)
  for (; i < W; i += G) {
    const float2 r = sxy[i];
    const float dx = x - r.x;
    const float dy = y - r.y;
    const float d = dx * dx + dy * dy;
    if (d < dmin) {
      dmin = d;
      imin = i;
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(kFullMask, dmin, o, G);
    const int oi = __shfl_xor_sync(kFullMask, imin, o, G);
    if (od != od || (dmin == dmin && (od < dmin || (od == dmin && oi < imin)))) {
      dmin = od;
      imin = oi;
    }
  }
  *d_out = dmin;
  return imin;
}

// The carried search (waypoint_carry="rollout", the Pallas ticks'
// window_refs_carried): the running min over the rows idx ≤ i < idx + span
// of the W staged rows, from d = 1e30 and no row, a row replacing it only
// by a strict <, so a NaN d never wins and the first of equal rows does
// (the path end's repeated rows resolve to the genuine one). Lane j scans
// rows idx + j, idx + j + G, ... (idx is the same in every lane of the
// group), and rounds of xor shuffles merge (d, row): the smaller d wins, on
// a tie the smaller row. That is the row of the sequential masked scan,
// returned in every lane of the group with its d, or -1 with d = 1e30 when
// no row beat 1e30 (a NaN state): the caller then keeps idx.
template <int G>
__device__ __forceinline__ int dmm_carried_row(int W, int span, int idx, int lane, float x,
                                               float y, const float2* sxy, float* d_out) {
  static_assert(G >= 1 && G <= 16 && (G & (G - 1)) == 0, "G: a power of two, 1 to 16");
  float dmin = 1.0e30f;
  int imin = INT_MAX;
  const int end = min(idx + span, W);
#pragma unroll 4
  for (int i = idx + lane; i < end; i += G) {
    const float2 r = sxy[i];
    const float dx = x - r.x;
    const float dy = y - r.y;
    const float d = dx * dx + dy * dy;
    if (d < dmin) {
      dmin = d;
      imin = i;
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(kFullMask, dmin, o, G);
    const int oi = __shfl_xor_sync(kFullMask, imin, o, G);
    if (od < dmin || (od == dmin && oi < imin)) {
      dmin = od;
      imin = oi;
    }
  }
  *d_out = dmin;
  return imin == INT_MAX ? -1 : imin;
}

// Lane `src` of the caller's group hands `v` to every lane of the group
// (G = 1: the lane's own value, no shuffle).
template <int G>
__device__ __forceinline__ float dmm_group_shfl(float v, int src) {
  if constexpr (G == 1) {
    return v;
  } else {
    return __shfl_sync(kFullMask, v, src, G);
  }
}
