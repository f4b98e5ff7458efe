// The block of the float32 dK/dV passes on Hopper's tensor cores (sm_90a) in
// 3xTF32, shared by flash_attention_dkv_tf32.cu (K3) and
// flashmask_dkv_tf32.cu (K7), on top of sm90_tf32.cuh.
//
// Both compute dV = sum_q P^T . dO and dK = scale * sum_q dS^T . Q over one
// tile of keys, with P^T = 2^(S^T * scale * log2(e) - lse * log2(e))
// recomputed from the forward's row logsumexp and dS^T = P^T o (dP^T - Delta).
// A block owns kM keys and 256 threads, two warpgroups, so K and V come in
// once; the kN-row Q and dO tiles stream through a ring of kStages stages by
// TMA, each with its rows' lse and Delta (kN floats each, read along the
// columns) by cp.async, all landing on the stage's mbarrier. Thread 0
// issues the loads (no producer warp: ptxas holds a block of 288 threads to
// 168 registers a thread). Per Q/dO tile:
//   1. all threads split the stage's Q and dO: hi in place, lo into the
//      split set, and both written transposed (Q^T, dO^T: q contiguous) in
//      hi and lo parts into the set; fence.proxy.async and a barrier hand
//      the tiles to wgmma;
//   2. each warpgroup computes S^T = K.Q^T and dP^T = V.dO^T (m64nNk8, SS,
//      N = kN): all four operands K-major in D as TMA lands them, keys on
//      the accumulator's rows. At D <= 64 the warpgroups own 64 keys each;
//      at D = 128 both see the block's 64 keys and each reduces over half
//      of D, then they add each other's partial sums through shared memory
//      (the half of Q lo and dO lo that only the writer's products read);
//   3. the kernel forms P^T and dS^T in the accumulator registers, each
//      element at its TRUE q index (lse, Delta, the causal test, the ragged
//      edge, dropout's hash and FlashMask's intervals);
//   4. P^T and dS^T are split into hi and lo A registers, and the tile's
//      dV = P^T.dO and dK = dS^T.Q (m64n64k8, RS: 64 columns of D a
//      warpgroup) are summed in a fresh accumulator, then added to dV and
//      dK in registers. The tensor cores add into an accumulator rounding
//      toward zero, so summing every tile in place would lose a bit of the
//      sum per few products, biased, over the thousands of q rows of a long
//      document; this way each tile's sum is rounded to nearest once. These
//      products reduce over q, and TF32 wgmma takes K-major operands only,
//      so their B operands are dO^T and Q^T. Their q order is permuted,
//      8g + 2c + e stored at 8g + c + 4e (sm90_tf32.cuh), so that the
//      accumulator registers of P^T and dS^T are the A fragments as they
//      stand: the same sum over q in another order. A barrier then frees
//      the stage and the split set, and the first warp loads the tile
//      kStages ahead.
// Every product runs as three TF32 products, a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, in f32 accumulators. No atomics: each output element has one
// owner thread, so the same inputs give the same bits.
//
// Shared memory (227 KB a block). Each streamed q tile needs eight tiles:
// Q and dO in hi and lo (B of S^T, dP^T) and Q^T, dO^T in hi and lo (B of
// dK, dV); the resident keys four: K and V in hi and lo (A from shared
// memory needs its lo tile too).
//   D <= 64: 128-key blocks (a warpgroup per 64 keys), 32-row q tiles:
//     K/V hi + lo 128 KB, two stages of raw Q + dO 32 KB, one split set
//     (Q lo, dO lo, Q^T and dO^T hi + lo) 48 KB: 208 KB.
//   D = 128: 128-key blocks would need 256 KB for K and V alone, so the
//     block has 64 keys (the warpgroups split D); K/V hi + lo 128 KB;
//     32-row tiles would need 128 KB more, so the q tiles have 16 rows: two
//     stages 32 KB, one split set 48 KB: 208 KB. S^T and dP^T are then
//     m64n16k8 products, and Q^T/dO^T rows are 64 bytes (64-byte swizzle).
// D = 16 and 32 run as D = 64 with zero columns (TMA fills them).
#pragma once

#include "sm90_tf32.cuh"

namespace dkv32 {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;

// shared memory in bytes from a 1024-byte aligned base: K hi, K lo, V hi,
// V lo, then kStages stages of a Q tile and a dO tile (their hi after the
// split), then the split set (Q lo, dO lo, Q^T hi, Q^T lo, dO^T hi,
// dO^T lo), then kStages (lse, Delta) rows of kN floats each, then the
// mbarriers (K and V, kStages full)
template <int DP>
struct Layout {
  static constexpr bool kSplitD = DP > 64;       // the warpgroups split D, else the keys
  static constexpr int kM = kSplitD ? 64 : 128;  // keys per block
  static constexpr int kN = kSplitD ? 16 : 32;   // q rows per Q/dO tile
  static constexpr int kThreads = 256;
  static constexpr int kSlices = (kSplitD ? DP / 2 : DP) / 8;  // k slices of S^T a warpgroup sums
  static constexpr int kStages = 2;
  static constexpr int kBoxes = DP / 32;  // 32-column boxes in a row
  static constexpr int kKBox = kM * 128;
  static constexpr int kK = kBoxes * kKBox;  // K or V, hi or lo: 32 KB
  static constexpr int kQBox = kN * 128;
  static constexpr int kQ = kBoxes * kQBox;  // Q or dO, hi or lo: 8 KB
  static constexpr int kTRow = kN * 4;       // bytes in a row of Q^T: the swizzle
  static constexpr int kT = DP * kTRow;      // Q^T or dO^T, hi or lo: 8 KB
  static constexpr int kStage = 4 * kK;      // stage s: Q at kStage + 2 s kQ, dO after it
  static constexpr int kSet = kStage + kStages * 2 * kQ;
  static constexpr int kRows = kSet + 2 * kQ + 4 * kT;
  static constexpr int kBar = kRows + kStages * 2 * kN * 4;
  static constexpr int kEnd = kBar + 8 * (1 + kStages);
  static constexpr int kBytes = kEnd + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
  static_assert(!kSplitD || 128 * kN / 2 * 4 == 2 * kQBox,
                "a warpgroup's partial S^T fills its half of Q lo");
};

// this warpgroup's first key in the block, and its first output column
template <int DP>
__device__ __forceinline__ int wg_key(int wg) {
  return Layout<DP>::kSplitD ? 0 : 64 * wg;
}

template <int DP>
__device__ __forceinline__ int wg_col(int wg) {
  return Layout<DP>::kSplitD ? 64 * wg : 0;
}

template <int DP>
__device__ __forceinline__ uint32_t bar_full(uint32_t base, int s) {
  return base + Layout<DP>::kBar + 8 * (1 + s);
}

// thread 0: the barriers of K/V and of each stage (the TMA transaction's
// arrival, then one from each lane of the first warp when its cp.async
// copies of the stage's rows have landed)
template <int DP>
__device__ __forceinline__ void init_barriers(uint32_t base) {
  mbar_init(base + Layout<DP>::kBar, 1);
  for (int s = 0; s < Layout<DP>::kStages; ++s) mbar_init(bar_full<DP>(base, s), 1 + 32);
  fence_barrier_init();
}

// thread 0: keys [k0, k0 + kM) of K and V, on the K/V barrier
template <int DP>
__device__ __forceinline__ void load_kv(uint32_t base, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int k0, int h, int b) {
  using L = Layout<DP>;
  const uint32_t bar = base + L::kBar;
  mbar_arrive_expect_tx(bar, 2 * L::kK);
  for (int c = 0; c < L::kBoxes; ++c) {
    tma_load_4d(base + c * L::kKBox, tk, bar, 32 * c, h, k0, b);
    tma_load_4d(base + 2 * L::kK + c * L::kKBox, tv, bar, 32 * c, h, k0, b);
  }
}

// the first warp (lane = its thread): q rows [q0, q0 + kN) of Q and dO into
// stage s by TMA, their lse and Delta into the stage's rows by cp.async
// (zeros past Sq, where Q and dO are zero-filled and P is masked)
template <int DP>
__device__ __forceinline__ void load_qdo(uint32_t base, const CUtensorMap* tq,
                                         const CUtensorMap* tdo, const float* lse,
                                         const float* delta, long long rows, int Sq, int q0,
                                         int h, int b, int s, int lane) {
  using L = Layout<DP>;
  const uint32_t full = bar_full<DP>(base, s);
  if (lane == 0) {
    const uint32_t dst = base + L::kStage + s * 2 * L::kQ;
    mbar_arrive_expect_tx(full, 2 * L::kQ);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(dst + c * L::kQBox, tq, full, 32 * c, h, q0, b);
      tma_load_4d(dst + L::kQ + c * L::kQBox, tdo, full, 32 * c, h, q0, b);
    }
  }
  const uint32_t st = base + L::kRows + s * 2 * L::kN * 4;
  for (int r = lane; r < L::kN; r += 32) {
    const int qp = q0 + r;
    const long long at = qp < Sq ? rows + qp : 0;
    cp_async_4(st + 4 * r, lse + at, qp < Sq);
    cp_async_4(st + 4 * (L::kN + r), delta + at, qp < Sq);
  }
  cp_async_mbar_arrive(full);
}

// K and V (at sm) become their hi parts beside their lo tiles
template <int DP>
__device__ __forceinline__ void split_kv(uint8_t* sm, int tid) {
  using L = Layout<DP>;
  split_in_place(sm, sm + L::kK, L::kK, tid, L::kThreads);
  split_in_place(sm + 2 * L::kK, sm + 3 * L::kK, L::kK, tid, L::kThreads);
}

// Step 1 of the note: the stage's Q and dO tiles (at qdo) become their hi
// parts, and the split set (at set) gets Q lo, dO lo and Q^T, dO^T in hi and
// lo parts. A unit is 8 q rows x 2 columns of one tensor; the Q units come
// first, so each warp takes units of one kind.
template <int DP>
__device__ __forceinline__ void split_qdo(uint8_t* qdo, uint8_t* set, int tid) {
  using L = Layout<DP>;
  constexpr int kUnits = (L::kN / 8) * (DP / 2);
  for (int u = tid; u < 2 * kUnits; u += L::kThreads) {
    const int which = u / kUnits;  // 0: Q, 1: dO
    const int w = u % kUnits;
    const int g = w / (DP / 2), n0 = 2 * (w % (DP / 2));
    uint8_t* const tile = qdo + which * L::kQ;
    uint8_t* const lo = set + which * L::kQ;
    uint8_t* const t_hi = set + 2 * L::kQ + which * 2 * L::kT;
    float2 x[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t off = tile_offset(8 * g + r, n0, L::kN);
      x[r] = *reinterpret_cast<const float2*>(tile + off);
      store_split2(tile, lo, off, x[r]);
    }
    store_transposed<L::kTRow>(t_hi, t_hi + L::kT, g, n0, x, DP);
  }
}

// Step 2: this warpgroup's S^T = K.Q^T into sc and dP^T = V.dO^T into dp,
// three TF32 products each, from stage s (over this warpgroup's half of D
// when the warpgroups split it); committed, not waited for
template <int DP>
__device__ __forceinline__ void issue_sdp(float (&sc)[Layout<DP>::kN / 2],
                                          float (&dp)[Layout<DP>::kN / 2], uint32_t base, int wg,
                                          int s) {
  using L = Layout<DP>;
  base = opaque(base);
  const uint32_t k_hi = base + 128 * wg_key<DP>(wg), k_lo = k_hi + L::kK;
  const uint32_t v_hi = k_hi + 2 * L::kK, v_lo = k_hi + 3 * L::kK;
  const uint32_t q_hi = base + L::kStage + s * 2 * L::kQ, o_hi = q_hi + L::kQ;
  const uint32_t q_lo = base + L::kSet, o_lo = q_lo + L::kQ;
  const int kk0 = L::kSplitD ? wg * L::kSlices : 0;
#pragma unroll
  for (int part = 0; part < 3; ++part) {  // A_lo.B_hi, A_hi.B_lo, A_hi.B_hi
#pragma unroll
    for (int i = 0; i < L::kSlices; ++i) {
      const int kk = kk0 + i;
      const uint32_t a = (kk / 4) * L::kKBox + (kk % 4) * 32;
      const uint32_t bq = (kk / 4) * L::kQBox + (kk % 4) * 32;
      wgmma_tf32_ss(sc, desc_sw128((part == 0 ? k_lo : k_hi) + a, 16, 1024),
                    desc_sw128((part == 1 ? q_lo : q_hi) + bq, 16, 1024), part > 0 || i > 0);
      wgmma_tf32_ss(dp, desc_sw128((part == 0 ? v_lo : v_hi) + a, 16, 1024),
                    desc_sw128((part == 1 ? o_lo : o_hi) + bq, 16, 1024), part > 0 || i > 0);
    }
  }
  wgmma_commit();
}

// Step 2's end when the warpgroups split D: each adds the other's partial
// S^T and dP^T (thread t of one warpgroup holds the elements thread t of
// the other does). A partial goes where only its writer's products read:
// the writer's half of the Q lo and dO lo tiles, free once S^T and dP^T
// are done. A barrier; both warpgroups sum in the same order.
template <int DP>
__device__ __forceinline__ void exchange_sdp(float (&sc)[Layout<DP>::kN / 2],
                                             float (&dp)[Layout<DP>::kN / 2], uint8_t* sm, int wg,
                                             int t) {
  using L = Layout<DP>;
  if constexpr (L::kSplitD) {
    constexpr int kR = L::kN / 2;
    auto slot = [&](int w, int tensor) {
      return reinterpret_cast<float*>(sm + L::kSet + tensor * L::kQ + w * 2 * L::kQBox) + t * kR;
    };
#pragma unroll
    for (int i = 0; i < kR; i += 4) {
      *reinterpret_cast<float4*>(slot(wg, 0) + i) =
          make_float4(sc[i], sc[i + 1], sc[i + 2], sc[i + 3]);
      *reinterpret_cast<float4*>(slot(wg, 1) + i) =
          make_float4(dp[i], dp[i + 1], dp[i + 2], dp[i + 3]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kR; i += 4) {
      const float4 os = *reinterpret_cast<const float4*>(slot(1 - wg, 0) + i);
      const float4 od = *reinterpret_cast<const float4*>(slot(1 - wg, 1) + i);
      const float ps[4] = {os.x, os.y, os.z, os.w}, pd[4] = {od.x, od.y, od.z, od.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // the same order in both warpgroups: warpgroup 0's half first
        sc[i + r] = wg == 0 ? sc[i + r] + ps[r] : ps[r] + sc[i + r];
        dp[i + r] = wg == 0 ? dp[i + r] + pd[r] : pd[r] + dp[i + r];
      }
    }
  }
}

// a B operand of step 4: a transposed tile's rows of kTRow bytes
template <int DP>
__device__ __forceinline__ uint64_t desc_t(uint32_t addr) {
  return Layout<DP>::kTRow == 128 ? desc_sw128(addr, 16, 1024) : desc_sw64(addr, 16, 512);
}

// acc += x.B over the tile's q rows, x (accumulator-layout values) split
// into hi and lo A registers, B (a transposed tile's 64 rows, in hi and lo
// parts) from the split set: the three products summed from 0 in tmp,
// then added to acc, rounded to nearest once
template <int DP>
__device__ __forceinline__ void add_product(float (&acc)[32], float (&tmp)[32],
                                            const float (&x)[Layout<DP>::kN / 2], uint32_t b_hi,
                                            uint32_t b_lo) {
  constexpr int kSl = Layout<DP>::kN / 8;
  uint32_t hi[kSl][4], lo[kSl][4];
#pragma unroll
  for (int ks = 0; ks < kSl; ++ks) pack_a_tf32(hi[ks], lo[ks], x, ks);
  fence_operand(tmp);
  wgmma_fence();
#pragma unroll
  for (int part = 0; part < 3; ++part)  // x_lo.B_hi, x_hi.B_lo, x_hi.B_hi
#pragma unroll
    for (int ks = 0; ks < kSl; ++ks)
      wgmma_tf32_rs(tmp, part == 0 ? lo[ks] : hi[ks],
                    desc_t<DP>((part == 1 ? b_lo : b_hi) + ks * 32), part > 0 || ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(tmp);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += tmp[i];
}

// Step 4: dV += P^T.dO and dK += dS^T.Q over this warpgroup's 64 columns
// of D, P^T in pt and dS^T in dst
template <int DP>
__device__ __forceinline__ void add_products(float (&dv)[32], float (&dk)[32], float (&tmp)[32],
                                             const float (&pt)[Layout<DP>::kN / 2],
                                             const float (&dst)[Layout<DP>::kN / 2],
                                             uint32_t base, int wg) {
  using L = Layout<DP>;
  // Q^T hi, Q^T lo, dO^T hi, dO^T lo, kT apart, from this warpgroup's rows
  const uint32_t qt = opaque(base) + L::kSet + 2 * L::kQ + wg_col<DP>(wg) * L::kTRow;
  add_product<DP>(dv, tmp, pt, qt + 2 * L::kT, qt + 3 * L::kT);
  add_product<DP>(dk, tmp, dst, qt, qt + L::kT);
}

// dk (times scale) and dv of this thread's keys key0 and key0 + 8,
// columns col + 8 i and + 1 (this warpgroup's 64), into the contiguous
// [B, Sk, H, D] f32 outputs
__device__ __forceinline__ void store_dkv(float* dk_out, float* dv_out, const float (&dk)[32],
                                          const float (&dv)[32], int b, int h, int key0, int col,
                                          int Sk, int H, int D, float scale) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kp = key0 + 8 * hh;
    if (kp >= Sk) continue;
    const long long off = ((static_cast<long long>(b) * Sk + kp) * H + h) * D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = col + 8 * i;
      if (c < D) {
        *reinterpret_cast<float2*>(dk_out + off + c) =
            make_float2(dk[4 * i + 2 * hh] * scale, dk[4 * i + 2 * hh + 1] * scale);
        *reinterpret_cast<float2*>(dv_out + off + c) =
            make_float2(dv[4 * i + 2 * hh], dv[4 * i + 2 * hh + 1]);
      }
    }
  }
}

}  // namespace dkv32
