// FlashMask's mask on Hopper, shared by the tensor-core kernels K5
// (flashmask_fwd_sm90.cu), K6 (flashmask_dq_sm90.cu) and K7
// (flashmask_dkv_sm90.cu).
//
// startend_row_indices [B, Hm, Sk, ncol] int32 gives each key column the
// query rows it hides, read here as two [start, end) intervals: ncol 1
// [LTS] is [LTS, end of rows) and an empty one; ncol 2 [LTS, LTE] one
// interval; ncol 4 [LTS, LTE, UTS, UTE] two. Causal adds the rows above
// the column (top-left, rows < column hidden).
//
// A block skips a tile of the other operand only where the mask hides all
// of the block's pairs with it. Before its loop a block marks each tile
// live (some column lets some row of the pair through: the column's first
// allowed row at or after the rows' start, found by jumping past the
// causal bound and the two intervals, is at most their last) and partial
// (some column's interval meets the rows, so its elements must be tested
// against the intervals). One warp then compacts the live tiles, in
// order, into a list that the loads and the products both walk.
#pragma once

#include <cuda_runtime.h>

namespace fm90 {

constexpr int kOpen = 0x7fffffff;  // the end of an interval open to the last row
constexpr int kPartial = 1 << 30;  // list entry flag: the tile's intervals meet the block
constexpr int kTile = kPartial - 1;

// key column kp's hidden rows as two [start, end) intervals; none past Sk
// (the ragged edge is masked by position)
__device__ __forceinline__ int4 column(const int* idx, int ncol, int kp, int Sk) {
  if (kp >= Sk) return make_int4(0, 0, 0, 0);
  const int* c = idx + static_cast<long long>(kp) * ncol;
  if (ncol == 1) return make_int4(__ldg(c), kOpen, 0, 0);
  if (ncol == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(c));
    return make_int4(v.x, v.y, 0, 0);
  }
  return __ldg(reinterpret_cast<const int4*>(c));
}

__device__ __forceinline__ bool hidden(const int4& iv, int r) {
  return (r >= iv.x && r < iv.y) || (r >= iv.z && r < iv.w);
}

// the first row at or after q0 that key column kp lets through: past the
// causal bound [0, kp) and the two hidden intervals. Each can be passed at
// most once, as the row only grows, so three rounds reach the fixed point
__device__ __forceinline__ int first_allowed(const int4& iv, int kp, int q0, int causal) {
  int r = q0;
#pragma unroll
  for (int round = 0; round < 3; ++round) {
    if (causal && r < kp) r = kp;
    if (r >= iv.x && r < iv.y) r = iv.y;
    if (r >= iv.z && r < iv.w) r = iv.w;
  }
  return r;
}

__device__ __forceinline__ bool meets(int start, int end, int q0, int q_last) {
  return start < end && start <= q_last && end > q0;
}

__device__ __forceinline__ bool meets(const int4& iv, int q0, int q_last) {
  return meets(iv.x, iv.y, q0, q_last) || meets(iv.z, iv.w, q0, q_last);
}

// K5 and K6, blocks of rows [q0, q_last]: OR into flags[t] bit 0 where
// 64-key tile t (t < n_kt) is live for the rows and bit 1 where it is
// partial. flags must be zeroed, and visible to every thread, first. A
// warp reads 32 columns of one tile at a time (32 divides 64 and
// kThreads), one vote each
template <int kThreads>
__device__ __forceinline__ void mark_k_tiles(const int* idx, int ncol, int Sk, int q0,
                                             int q_last, int causal, int n_kt, int* flags,
                                             int tid) {
  for (int c0 = 32 * (tid / 32); c0 < n_kt * 64; c0 += kThreads) {
    const int kp = c0 + tid % 32;
    const int4 iv = column(idx, ncol, kp, Sk);
    const bool live = kp < Sk && first_allowed(iv, kp, q0, causal) <= q_last;
    const bool part = meets(iv, q0, q_last);
    const unsigned lv = __ballot_sync(0xffffffffu, live);
    const unsigned pt = __ballot_sync(0xffffffffu, part);
    if (tid % 32 == 0 && (lv | pt)) atomicOr(&flags[c0 / 64], (lv ? 1 : 0) | (pt ? 2 : 0));
  }
}

// One warp: the live tiles among flags[0, n), in order, into list as
// first + t, with kPartial set on a partial tile; lane 0 stores their
// count in *n_live and, when tiles is not null, adds it and n to tiles[0]
// and tiles[1] (the tiles computed and the tiles within the causal bound)
__device__ __forceinline__ void compact_live(const int* flags, int n, int first, int* list,
                                             int* n_live, int* tiles, int lane) {
  int count = 0;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int t = t0 + lane;
    const int f = t < n ? flags[t] : 0;
    const unsigned live = __ballot_sync(0xffffffffu, f & 1);
    if (f & 1)
      list[count + __popc(live & ((1u << lane) - 1u))] = (first + t) | (f & 2 ? kPartial : 0);
    count += __popc(live);
  }
  if (lane == 0) {
    *n_live = count;
    if (tiles != nullptr) {
      atomicAdd(tiles, count);
      atomicAdd(tiles + 1, n);
    }
  }
}

}  // namespace fm90
