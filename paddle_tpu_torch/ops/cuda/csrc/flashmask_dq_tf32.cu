// FlashMask dQ pass on Hopper's tensor cores (sm_90a) in 3xTF32: K6 for
// float32 inputs. bfloat16 runs on flashmask_dq_sm90.cu; the f32 dK/dV pass
// (K7) on flashmask_dkv_tf32.cu.
//
// Replaces paddle_tpu/ops/pallas/flashmask.py::_fm_bwd_dq_kernel (:103,
// launched by _fm_bwd, :251, call :269): dQ = scale * sum_k dS . K, with
// P = exp(q.k^T * scale - lse) recomputed per tile from the forward's row
// logsumexp and set to 0 where the column-interval mask hides the pair
// (flashmask_sm90_common.cuh), dP = dO . V^T and dS = P o (dP - Delta),
// Delta = rowsum(dO o O) computed by the wrapper in f32 as [B, H, 1, Sq].
// It keeps the bf16 K6's contract:
//   - layout [B, S, H, D] through TMA tensor maps over per-tensor strides
//     (a 16-byte aligned base and strides that are multiples of 16 bytes,
//     which the wrapper guarantees by copying any other input);
//   - hidden pairs get P SELECTED to 0, never multiplied by a 0/1 mask: a
//     row that sees no key has lse = -1e30 + log(1e-30), where
//     2^(s - lse) is inf and inf * 0 NaN. Such a row gets dQ = 0 exactly,
//     as the Pallas kernel gives;
//   - any Sq, Sk: TMA fills the rows past the end (and the columns past D)
//     with zeros, and the pairs there are masked;
//   - dq contiguous [B, Sq, H, D] in f32; no dropout (the Pallas kernel has
//     none); an optional tile counter.
//
// Arithmetic: every product a.b in three TF32 products, a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi, summed in f32 (sm90_tf32.cuh). dQ sums dS.K over
// as many keys as a document has, and the tensor cores add into an
// accumulator rounding toward zero, so each k tile's products are summed
// from 0 in a fresh accumulator and added to dQ in f32, rounded to nearest
// once, as the f32 dK/dV block does (dkv_tf32.cuh).
//
// Design: flash_attention_dq_tf32.cu's block (one block per (kM-row q
// tile, head, batch), the heads fastest in the grid; a warpgroup per 64
// rows, no producer warp; thread 0 brings Q and dO in once and streams
// 32-key K and V tiles through a ring of kStages stages by TMA; Q and dO
// split into hi and lo once; per K/V tile all threads write K's and V's hi
// in place and a split set of K lo, V lo and K^T in hi and lo; S = Q.K^T
// and dP = dO.V^T (m64n32k8, SS), dS in the accumulator registers, dS.K
// (m64nDk8, RS, B = K^T); 128-row blocks, two stages and two split sets at
// D <= 64, 64-row blocks, one stage and one set at D = 128) with the bf16
// K6's list of live k tiles:
//   - before the loop all threads read the key columns' intervals up to the
//     causal bound and vote, per 32-key tile, whether any column lets a row
//     of the block's [q0, q_last] through (live) and whether any column's
//     intervals meet those rows (partial); one warp compacts the live tiles,
//     in order, into a list written over the flags it reads
//     (flashmask_sm90_common.cuh). TMA and the products walk only that list;
//   - the list takes 4 bytes a k tile beside K2's 224 KB: room for about
//     500 tiles (16000 keys); a block with more votes, lists and walks them
//     in rounds of that many, the TMA ring going on across rounds;
//   - a thread reads its columns' intervals from global memory (__ldg; the
//     index tensor stays in L2) and tests its pairs against them only in a
//     partial tile, and against the ragged edge and the causal diagonal
//     only in a tile that meets them.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, so 165 TFLOP/s for three
// products; 3.35 TB/s HBM), counted over the (q, k) pairs the mask allows,
// N: three products, 6 D N flops a head, against q, k, v, dO, dq, lse,
// Delta and the indices read or written once. At the FlashMask path of
// chip_smoke.py (B=1, S=8192, 32 heads, D=128, causal documents, 10.5M
// allowed pairs a head) that is 257.6 GFLOP, 1.56 ms (3.84 ms at
// 67 TFLOP/s), against 0.05 ms of bytes: bound by operations. What the
// design leaves on the table is the f32 K2's (narrow m64n32k8 products of S
// and dP, every block splitting every K/V tile it reads, one warpgroup a
// block at D = 128), and a block computes a 32-key tile wherever one of its
// rows sees one of its keys.

#include "flash_attention_common.cuh"
#include "flashmask_sm90_common.cuh"
#include "sm90_tf32.cuh"

namespace {

using namespace fm90;
using namespace sm90;

constexpr int kN = 32;  // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const int* idx;      // [B, Hm, Sk, ncol]
  const float* lse;    // [B, H, 1, Sq]
  const float* delta;  // [B, H, 1, Sq]
  float* dq;
  int* tiles;  // null, or (live tiles, tiles within the causal bound) summed over blocks
  int B, Sq, Sk, H, D, Hm, ncol;
  int round;  // k tiles a block votes on, lists and walks at a time
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// shared memory in bytes from a 1024-byte aligned base: Q hi, Q lo, dO hi,
// dO lo, then kStages stages of a K tile and a V tile (their hi after the
// split), then kSets sets of K lo, V lo, K^T hi and K^T lo, then the
// mbarriers (Q and dO, kStages full), then the live-tile count and a flag,
// later a list entry, for each k tile of a round (kFixed + 4 bytes a tile)
template <int DP>
struct Layout {
  static constexpr int kM = DP <= 64 ? 128 : 64;  // q rows per block
  static constexpr int kThreads = 2 * kM;         // a warpgroup per 64 rows
  static constexpr int kStages = DP <= 64 ? 2 : 1;
  static constexpr int kSets = DP <= 64 ? 2 : 1;
  static constexpr int kBoxes = DP / 32;  // 32-column boxes in a row
  static constexpr int kQBox = kM * 128;
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kKVBox = kN * 128;
  static constexpr int kKV = kBoxes * kKVBox;
  static constexpr int kT = DP * 128;  // K^T: DP rows of 32 keys
  static constexpr int kStage = 4 * kQ;  // stage s at kStage + 2 s kKV
  static constexpr int kSet = kStage + kStages * 2 * kKV;  // set i at kSet + i kSetBytes
  static constexpr int kSetBytes = 2 * kKV + 2 * kT;  // K lo, V lo, K^T hi, K^T lo
  static constexpr int kBar = kSet + kSets * kSetBytes;
  static constexpr int kList = kBar + 8 * (1 + kStages);
  static constexpr int kFixed = kList + 16 + 1024;  // + alignment slack
  static int bytes(int round) { return kFixed + 4 * round; }
};

// Step 1 of the note: the K and V tiles at k and v become their hi parts,
// and the split set at set gets K lo, V lo, K^T hi and K^T lo. A unit is
// 8 keys x 2 columns of K and of V. Where the threads outnumber the units
// (D <= 64), K and V are units of their own, the K units first, so each
// warp takes units of one kind.
template <int DP>
__device__ __forceinline__ void split_kv(uint8_t* k, uint8_t* v, uint8_t* set, int tid) {
  using L = Layout<DP>;
  constexpr int kUnits = (kN / 8) * (DP / 2);
  constexpr bool kApart = kUnits < L::kThreads;
  uint8_t* const k_lo = set;
  uint8_t* const v_lo = set + L::kKV;
  uint8_t* const kt_hi = set + 2 * L::kKV;
  uint8_t* const kt_lo = kt_hi + L::kT;
  for (int u = tid; u < (kApart ? 2 : 1) * kUnits; u += L::kThreads) {
    const int w = u % kUnits;
    const int g = w / (DP / 2), n0 = 2 * (w % (DP / 2));
    if (!kApart || u >= kUnits) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t off = tile_offset(8 * g + r, n0, kN);
        store_split2(v, v_lo, off, *reinterpret_cast<const float2*>(v + off));
      }
    }
    if (!kApart || u < kUnits) {
      float2 kk[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t off = tile_offset(8 * g + r, n0, kN);
        kk[r] = *reinterpret_cast<const float2*>(k + off);
        store_split2(k, k_lo, off, kk[r]);
      }
      store_transposed(kt_hi, kt_lo, g, n0, kk, DP);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(Layout<DP>::kThreads, 1)
    flashmask_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo, const Params p) {
  using L = Layout<DP>;
  constexpr int kM = L::kM;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem[];
  uint8_t* const sm = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;
  int* const n_live = reinterpret_cast<int*>(sm + L::kList);
  int* const list = n_live + 4;  // flags (bit 0: live, bit 1: partial), then the list

  // heads vary fastest, so every head's heaviest causal tile runs first
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int b = blockIdx.z;
  const int q_last = min(q0 + kM, p.Sq) - 1;
  const int tid = threadIdx.x;
  int n_kt = (p.Sk + kN - 1) / kN;
  if (p.causal) n_kt = min(n_kt, (q0 + kM - 1) / kN + 1);
  const int* idx = p.idx + (static_cast<long long>(b) * p.Hm + (p.Hm > 1 ? h : 0)) * p.Sk * p.ncol;

  // Q and dO land while the block votes on its first round
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar_q, 2 * L::kQ);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(base + c * L::kQBox, &tq, bar_q, 32 * c, h, q0, b);
      tma_load_4d(base + 2 * L::kQ + c * L::kQBox, &tdo, bar_q, 32 * c, h, q0, b);
    }
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;

  // lse * log2(e) and Delta of this thread's rows; 0 past Sq, where Q and dO
  // are zero-filled, so S = dP = 0 and dS = 0 there
  float lse2[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = row0 + 8 * hh;
    lse2[hh] = qp < p.Sq ? p.lse[rows + qp] * kLog2e : 0.f;
    delta[hh] = qp < p.Sq ? p.delta[rows + qp] : 0.f;
  }

  // list entries walked in earlier rounds: where the ring stands
  int done = 0;
  // thread 0: the K/V tile of this round's list entry t into its stage
  auto load_kv = [&](int t) {
    const int s = (done + t) % kStages;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t kb = base + L::kStage + s * 2 * L::kKV;
    const int k0 = (list[t] & kTile) * kN;
    mbar_arrive_expect_tx(full, 2 * L::kKV);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(kb + c * L::kKVBox, &tk, full, 32 * c, h, k0, b);
      tma_load_4d(kb + L::kKV + c * L::kKVBox, &tv, full, 32 * c, h, k0, b);
    }
  };
  // step 1 of the note for this round's list entry t, into its stage and
  // split set
  auto split_tile = [&](int t) {
    const int g = done + t;
    const int kb_off = L::kStage + (g % kStages) * 2 * L::kKV;
    mbar_wait(bar_full + 8 * (g % kStages), (g / kStages) & 1);
    split_kv<DP>(sm + kb_off, sm + kb_off + L::kKV, sm + L::kSet + (g % L::kSets) * L::kSetBytes,
                 tid);
  };

  constexpr int kO = DP / 2;  // dQ accumulator registers (m64 x DP)
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;

  bool q_split = false;
  for (int r0 = 0; r0 < n_kt; r0 += p.round) {
    const int n_r = min(p.round, n_kt - r0);
    for (int t = tid; t < n_r; t += L::kThreads) list[t] = 0;
    __syncthreads();
    // the live and partial k tiles r0 .. r0 + n_r - 1
    mark_k_tiles<L::kThreads, kN>(idx, p.ncol, p.Sk, q0, q_last, p.causal, n_r, list, tid, r0);
    __syncthreads();
    // in place: each round of the warp reads its 32 flags before it writes
    // list entries, which land at or before them
    if (tid < 32) compact_live(list, n_r, r0, list, n_live, p.tiles, tid);
    __syncthreads();
    const int nl = *n_live;
    if (nl == 0) continue;
    if (tid == 0)
      for (int t = 0; t < min(kStages, nl); ++t) load_kv(t);
    if (!q_split) {
      mbar_wait(bar_q, 0);
      split_in_place(sm, sm + L::kQ, L::kQ, tid, L::kThreads);
      split_in_place(sm + 2 * L::kQ, sm + 3 * L::kQ, L::kQ, tid, L::kThreads);
      q_split = true;
    }
    split_tile(0);
    fence_proxy_async();
    __syncthreads();

    for (int j = 0; j < nl; ++j) {
      const int g = done + j;
      const int entry = list[j];
      const int k0 = (entry & kTile) * kN;
      const bool partial = entry & kPartial;
      // the tile's operands, from a base the compiler cannot hoist
      // descriptors out of the loop for; this warpgroup's 64 rows of Q and
      // dO
      const uint32_t sb = opaque(base);
      const uint32_t q_hi = sb + wg * 64 * 128, q_lo = q_hi + L::kQ;
      const uint32_t o_hi = q_hi + 2 * L::kQ, o_lo = q_hi + 3 * L::kQ;
      const uint32_t k_hi = sb + L::kStage + (g % kStages) * 2 * L::kKV, v_hi = k_hi + L::kKV;
      const uint32_t k_lo = sb + L::kSet + (g % L::kSets) * L::kSetBytes, v_lo = k_lo + L::kKV;
      const uint32_t kt_hi = k_lo + 2 * L::kKV, kt_lo = kt_hi + L::kT;
      float sc[kN / 2], dp[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_operand(sc);
      fence_operand(dp);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 3; ++part) {  // A_lo.B_hi, A_hi.B_lo, A_hi.B_hi
#pragma unroll
        for (int kk = 0; kk < DP / 8; ++kk) {
          const uint32_t a = (kk / 4) * L::kQBox + (kk % 4) * 32;
          const uint32_t bk = (kk / 4) * L::kKVBox + (kk % 4) * 32;
          wgmma_tf32_ss(sc, desc_sw128((part == 0 ? q_lo : q_hi) + a, 16, 1024),
                        desc_sw128((part == 1 ? k_lo : k_hi) + bk, 16, 1024), part > 0 || kk > 0);
          wgmma_tf32_ss(dp, desc_sw128((part == 0 ? o_lo : o_hi) + a, 16, 1024),
                        desc_sw128((part == 1 ? v_lo : v_hi) + bk, 16, 1024), part > 0 || kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sc);
      fence_operand(dp);
      const bool more = j + 1 < nl;
      if constexpr (kStages == 1) {
        // one warpgroup, one stage: S and dP were the stage's last readers,
        // so the next tile loads while dS and dS.K run
        __syncthreads();
        if (tid == 0 && more) load_kv(j + 1);
      }

      // dS = P o (dP - Delta) in place of S, P selected to 0 where hidden:
      // by the ragged edge and the causal diagonal only in a tile that
      // meets them, by the intervals only in a partial tile
      const bool edge = k0 + kN > p.Sk || (p.causal && k0 + kN - 1 > q0 + 64 * wg);
#pragma unroll
      for (int i = 0; i < kN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * i + col0 + e;
          int4 civ = make_int4(0, 0, 0, 0);
          if (partial) civ = column(idx, p.ncol, kp, p.Sk);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int x = 4 * i + 2 * hh + e;
            const int r = row0 + 8 * hh;
            float pj = ex2(fmaf(sc[x], p.scale_log2, -lse2[hh]));
            if ((edge && (kp >= p.Sk || (p.causal && r < kp))) || (partial && hidden(civ, r)))
              pj = 0.f;
            sc[x] = pj * (dp[x] - delta[hh]);
          }
        }

      // the tile's dS.K, summed from 0 in tmp
      uint32_t da_hi[kN / 8][4], da_lo[kN / 8][4];
#pragma unroll
      for (int ks = 0; ks < kN / 8; ++ks) pack_a_tf32(da_hi[ks], da_lo[ks], sc, ks);
      float tmp[kO];
#pragma unroll
      for (int i = 0; i < kO; ++i) tmp[i] = 0.f;
      fence_operand(tmp);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 3; ++part)  // dS_lo.K_hi, dS_hi.K_lo, dS_hi.K_hi
#pragma unroll
        for (int ks = 0; ks < kN / 8; ++ks)
          wgmma_tf32_rs(tmp, part == 0 ? da_lo[ks] : da_hi[ks],
                        desc_sw128((part == 1 ? kt_lo : kt_hi) + ks * 32, 16, 1024),
                        part > 0 || ks > 0);
      wgmma_commit();
      if constexpr (L::kSets == 2) {
        // the next tile's split runs while dS.K is on the tensor cores
        if (more) split_tile(j + 1);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      fence_operand(tmp);
      // dQ += the tile's sum, rounded to nearest once
#pragma unroll
      for (int i = 0; i < kO; ++i) acc[i] += tmp[i];
      __syncthreads();  // tile j's stage and split set are free
      if (kStages > 1 && tid == 0 && j + kStages < nl) load_kv(j + kStages);
      if constexpr (L::kSets == 1) {
        if (more) {
          split_tile(j + 1);
          fence_proxy_async();
          __syncthreads();
        }
      }
    }
    done += nl;
  }
  if (!q_split) mbar_wait(bar_q, 0);  // Q's and dO's load lands before the block exits

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = row0 + 8 * hh;
    if (qp >= p.Sq) continue;
    float* row = p.dq + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * p.D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + col0;
      if (c < p.D)
        *reinterpret_cast<float2*>(row + c) =
            make_float2(acc[4 * i + 2 * hh] * p.scale, acc[4 * i + 2 * hh + 1] * p.scale);
    }
  }
}

template <int DP>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  using L = Layout<DP>;
  const int smem = L::bytes(p.round);
  cudaError_t err = cudaFuncSetAttribute(flashmask_dq_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.Sq + L::kM - 1) / L::kM, p.B);
  flashmask_dq_tf32_kernel<DP>
      <<<grid, L::kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

}  // namespace

// The arguments of paddle_flashmask_bwd_dq_sm90 (flashmask_dq_sm90.cu),
// tiles included; dk and dv are not touched. dtype must be 0 (float32), D
// one of 16, 32, 64, 128, and every stride of q, k, v, dO a multiple of 4
// elements with a 16-byte aligned base (TMA). dq is a contiguous
// [B, Sq, H, D] f32 tensor. Returns the cudaError_t of the launch (0 on
// success), or sm90::kErrTensorMap when a tensor map cannot be encoded.
extern "C" int paddle_flashmask_bwd_dq_tf32(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* idx, void* dq, void* dk, void* dv, void* tiles, int dtype,
    int B, int Sq, int Sk, int H, int D, int Hm, int ncol, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal,
    float scale, void* stream) {
  (void)dk;
  (void)dv;
  if (dtype != 0 || (D != 16 && D != 32 && D != 64 && D != 128) || B < 1 || Sq < 1 || Sk < 1 ||
      H < 1 || (Hm != 1 && Hm != H) || (ncol != 1 && ncol != 2 && ncol != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int km = D <= 64 ? Layout<64>::kM : Layout<128>::kM;
  CUtensorMap maps[4];
  if (!encode_bshd_f32(&maps[0], q, B, Sq, H, D, q_sb, q_ss, q_sh, km) ||
      !encode_bshd_f32(&maps[1], k, B, Sk, H, D, k_sb, k_ss, k_sh, kN) ||
      !encode_bshd_f32(&maps[2], v, B, Sk, H, D, v_sb, v_ss, v_sh, kN) ||
      !encode_bshd_f32(&maps[3], dout, B, Sq, H, D, o_sb, o_ss, o_sh, km))
    return kErrTensorMap;
  Params p;
  p.idx = static_cast<const int*>(idx);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.tiles = static_cast<int*>(tiles);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.D = D;
  p.Hm = Hm;
  p.ncol = ncol;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  // as many k tiles a round as the list has room for (232448 bytes a block)
  const int fixed = D <= 64 ? Layout<64>::bytes(0) : Layout<128>::bytes(0);
  p.round = min((Sk + kN - 1) / kN, (232448 - fixed) / 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D <= 64 ? launch<64>(maps, p, s) : launch<128>(maps, p, s);
  return static_cast<int>(err);
}
