// FlashMask forward on Hopper's tensor cores (sm_90a) in 3xTF32: K5 for
// float32 inputs. bfloat16 runs on flashmask_fwd_sm90.cu.
//
// Replaces paddle_tpu/ops/pallas/flashmask.py::_fm_fwd_kernel (:52,
// launched by _fm_fwd, :209, call :222): attention under the column-interval
// mask of startend_row_indices [B, Hm, Sk, ncol] int32 (contiguous, Hm = 1
// broadcast over the heads; flashmask_sm90_common.cuh reads it). It keeps
// the bf16 K5's contract:
//   - layout [B, S, H, D] through TMA tensor maps over per-tensor strides
//     (a 16-byte aligned base and strides that are multiples of 16 bytes,
//     which the wrapper guarantees by copying any other input);
//   - hidden scores are SELECTED to -inf before the row max, never
//     multiplied by a 0/1 mask, so a row that sees no key keeps m = -inf,
//     gets p = 2^-inf = 0 everywhere and ends with O = 0 exactly and
//     lse = -1e30 + log(1e-30), as the Pallas kernel does;
//   - any Sq, Sk: TMA fills the rows past the end (and the columns past D)
//     with zeros, and the scores there are masked;
//   - O in f32 [B, Sq, H, D], lse f32 [B, H, 1, Sq]; no dropout (the Pallas
//     kernel has none); an optional tile counter.
//
// Arithmetic: every product a.b in three TF32 products, a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi, summed in f32 (sm90_tf32.cuh), as in the f32 K1.
// The tensor cores add into an accumulator rounding toward zero, so each
// tile's P.V is summed from 0 in a fresh accumulator and added to O in f32
// (O = O * alpha + tile, one rounding to nearest), as the f32 dK/dV block
// does (dkv_tf32.cuh): over a document of thousands of keys, adding every
// tile in place would lose a biased last place every few products.
//
// Design: flash_attention_fwd_tf32.cu's block (one block per (128-row q
// tile, head, batch), the heads fastest in the grid; 256 threads, two
// warpgroups of 64 rows, no producer warp; thread 0 brings Q in once and the
// K/V tiles through a ring of kStages stages by TMA; Q split into hi and lo
// once; per K/V tile all threads write K's hi in place and K's lo over the
// stage's V, and V transposed in hi and lo into a V^T set, then S = Q.K^T
// (SS), the online softmax in exp2 on the accumulator registers, P split in
// registers and P.V (RS); 64-key tiles, three stages and two V^T sets at
// D <= 64, 32-key tiles, two stages and one V^T set at D = 128) with the
// bf16 K5's mask:
//   - before the loop all 256 threads read the key columns' intervals up to
//     the causal bound and vote, per k tile, whether any column lets a row
//     of the block's [q0, q_last] through (a live tile) and whether any
//     column's intervals meet those rows (a partial tile); one warp then
//     compacts the live tiles, in order, into a list written over the flags
//     it reads (flashmask_sm90_common.cuh, mark_k_tiles at the kernel's tile
//     width). TMA and the products walk only that list: a dead tile is
//     neither loaded, split nor computed, and the skip drops no allowed pair;
//   - the list takes 4 bytes a k tile beside K1's 224 KB: room for about
//     500 tiles (32000 keys at D <= 64, 16000 at D = 128); a block with more
//     votes, lists and walks them in rounds of that many, the TMA ring going
//     on across rounds;
//   - there is no room to stage a tile's column intervals beside K and V, so
//     a thread reads its columns' intervals from global memory (__ldg; the
//     index tensor stays in L2) and tests its scores against them only in a
//     partial tile, and against the ragged edge and the causal diagonal
//     only in a tile that meets them, as K1 does.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, so 165 TFLOP/s for three
// products; 3.35 TB/s HBM), counted over the (q, k) pairs the mask allows,
// N: two products, 4 D N flops a head, against q, k, v, o, lse and the
// indices read or written once. At the FlashMask path of chip_smoke.py
// (B=1, S=8192, 32 heads, D=128, causal documents, 10.5M allowed pairs a
// head) that is 171.7 GFLOP, 1.04 ms (2.56 ms at 67 TFLOP/s), against
// 0.04 ms of bytes: bound by operations. What the design leaves on the
// table is the f32 K1's (every block splits every K/V tile it reads, a
// barrier a tile stops both warpgroups), and a 128-row block computes a k
// tile wherever one of its rows sees one of its keys.

#include "flash_attention_common.cuh"
#include "flashmask_sm90_common.cuh"
#include "sm90_tf32.cuh"

namespace {

using namespace fm90;
using namespace sm90;
using paddle_fa::kNegInf;

constexpr int kM = 128;  // q rows per block: two warpgroups of 64
constexpr int kThreadsTC = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const int* idx;  // [B, Hm, Sk, ncol]
  float* o;
  float* lse;
  int* tiles;  // null, or (live tiles, tiles within the causal bound) summed over blocks
  int B, Sq, Sk, H, D, Hm, ncol;
  int round;  // k tiles a block votes on, lists and walks at a time
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// shared memory in bytes from a 1024-byte aligned base: Q hi, Q lo, then
// kStages stages of a K tile and a V tile (K's lo once V is transposed),
// then kSets sets of V^T hi and lo, then the mbarriers (Q, kStages full),
// then the live-tile count and a flag, later a list entry, for each k tile
// of a round (kFixed + 4 bytes a k tile)
template <int DP>
struct Layout {
  static constexpr int kN = DP <= 64 ? 64 : 32;     // keys per K/V tile
  static constexpr int kStages = DP <= 64 ? 3 : 2;  // K/V tiles in flight
  static constexpr int kSets = DP <= 64 ? 2 : 1;    // V^T tiles
  static constexpr int kBoxes = DP / 32;            // 32-column boxes in a row
  static constexpr int kQBox = kM * 128;
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kKVBox = kN * 128;
  static constexpr int kKV = kBoxes * kKVBox;
  static constexpr int kTBox = DP * 128;  // 32 keys of V^T
  static constexpr int kT = (kN / 32) * kTBox;
  static constexpr int kStage = 2 * kQ;  // stage s at kStage + 2 s kKV
  static constexpr int kVt = kStage + kStages * 2 * kKV;
  static constexpr int kBar = kVt + kSets * 2 * kT;
  static constexpr int kList = kBar + 8 * (1 + kStages);
  static constexpr int kFixed = kList + 16 + 1024;  // + alignment slack
  static int bytes(int round) { return kFixed + 4 * round; }
};

// Step 1 of the note: the K tile at k becomes K's hi, the V tile at v K's
// lo; V goes transposed into vt_hi and vt_lo. A unit is 8 keys x 2 columns.
template <int DP>
__device__ __forceinline__ void split_kv(uint8_t* k, uint8_t* v, uint8_t* vt_hi, uint8_t* vt_lo,
                                         int tid) {
  constexpr int kN = Layout<DP>::kN;
  constexpr int kUnits = (kN / 8) * (DP / 2);
  for (int u = tid; u < kUnits; u += kThreadsTC) {
    const int g = u / (DP / 2), n0 = 2 * (u % (DP / 2));
    float2 vv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t off = tile_offset(8 * g + r, n0, kN);
      const float2 kx = *reinterpret_cast<const float2*>(k + off);
      vv[r] = *reinterpret_cast<const float2*>(v + off);
      store_split2(k, v, off, kx);
    }
    store_transposed(vt_hi, vt_lo, g, n0, vv, DP);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreadsTC, 1)
    flashmask_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<DP>;
  constexpr int kN = L::kN;
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

  // Q lands while the block votes on its first round
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar_q, L::kQ);
    for (int c = 0; c < L::kBoxes; ++c)
      tma_load_4d(base + c * L::kQBox, &tq, bar_q, 32 * c, h, q0, b);
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);

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
  // V^T set
  auto split_tile = [&](int t) {
    const int g = done + t;
    const int kb_off = L::kStage + (g % kStages) * 2 * L::kKV;
    const int vt_off = L::kVt + (g % L::kSets) * 2 * L::kT;
    mbar_wait(bar_full + 8 * (g % kStages), (g / kStages) & 1);
    split_kv<DP>(sm + kb_off, sm + kb_off + L::kKV, sm + vt_off, sm + vt_off + L::kT, tid);
  };

  constexpr int kO = DP / 2;  // O accumulator registers (m64 x DP)
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;
  // running max of the raw scores (-inf until a row sees a key) and this
  // thread's part of the row sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  bool q_split = false;
  for (int r0 = 0; r0 < n_kt; r0 += p.round) {
    const int n_r = min(p.round, n_kt - r0);
    for (int t = tid; t < n_r; t += kThreadsTC) list[t] = 0;
    __syncthreads();
    // the live and partial k tiles r0 .. r0 + n_r - 1
    mark_k_tiles<kThreadsTC, kN>(idx, p.ncol, p.Sk, q0, q_last, p.causal, n_r, list, tid, r0);
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
      split_in_place(sm, sm + L::kQ, L::kQ, tid, kThreadsTC);
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
      // descriptors out of the loop for
      const uint32_t sb = opaque(base);
      const uint32_t q_hi = sb + wg * 64 * 128, q_lo = q_hi + L::kQ;  // this warpgroup's Q
      const uint32_t k_hi = sb + L::kStage + (g % kStages) * 2 * L::kKV, k_lo = k_hi + L::kKV;
      const uint32_t vt_hi = sb + L::kVt + (g % L::kSets) * 2 * L::kT, vt_lo = vt_hi + L::kT;
      float sc[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) sc[i] = 0.f;
      fence_operand(sc);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 3; ++part) {  // Q_lo.K_hi, Q_hi.K_lo, Q_hi.K_hi
        const uint32_t qa = part == 0 ? q_lo : q_hi;
        const uint32_t kt = part == 1 ? k_lo : k_hi;
#pragma unroll
        for (int kk = 0; kk < DP / 8; ++kk)
          wgmma_tf32_ss(sc, desc_sw128(qa + (kk / 4) * L::kQBox + (kk % 4) * 32, 16, 1024),
                        desc_sw128(kt + (kk / 4) * L::kKVBox + (kk % 4) * 32, 16, 1024),
                        part > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sc);

      // hide the ragged edge and the causal diagonal (only in a tile that
      // meets them), then what the intervals hide (only in a partial tile)
      const bool edge = k0 + kN > p.Sk || (p.causal && k0 + kN - 1 > q0 + 64 * wg);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 8 * i + col0 + e;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              if (kp >= p.Sk || (p.causal && row0 + 8 * hh < kp))
                sc[4 * i + 2 * hh + e] = -INFINITY;
          }
      }
      if (partial) {
#pragma unroll
        for (int i = 0; i < kN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int4 civ = column(idx, p.ncol, k0 + 8 * i + col0 + e, p.Sk);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              if (hidden(civ, row0 + 8 * hh)) sc[4 * i + 2 * hh + e] = -INFINITY;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kN / 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          mx[hh] = fmaxf(mx[hh], fmaxf(sc[4 * i + 2 * hh], sc[4 * i + 2 * hh + 1]));
      // a tile that raises no row max leaves the row exactly as it was
      // (alpha = 1), so a wholly hidden row stays at m = -inf, l = 0, O = 0
      float alpha[2], mscaled[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
        alpha[hh] = m_new == m[hh] ? 1.f : ex2((m[hh] - m_new) * p.scale_log2);
        m[hh] = m_new;
        mscaled[hh] = m_new == -INFINITY ? 0.f : m_new * p.scale_log2;
        l[hh] *= alpha[hh];
      }
      // probabilities in place, exactly 0 where hidden (2^-inf)
#pragma unroll
      for (int i = 0; i < kN / 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * i + 2 * hh + e];
            x = ex2(fmaf(x, p.scale_log2, -mscaled[hh]));
            l[hh] += x;
          }

      // the tile's P.V, summed from 0 in tmp
      uint32_t pa_hi[kN / 8][4], pa_lo[kN / 8][4];
#pragma unroll
      for (int ks = 0; ks < kN / 8; ++ks) pack_a_tf32(pa_hi[ks], pa_lo[ks], sc, ks);
      float tmp[kO];
#pragma unroll
      for (int i = 0; i < kO; ++i) tmp[i] = 0.f;
      fence_operand(tmp);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 3; ++part)  // P_lo.V_hi, P_hi.V_lo, P_hi.V_hi
#pragma unroll
        for (int ks = 0; ks < kN / 8; ++ks)
          wgmma_tf32_rs(tmp, part == 0 ? pa_lo[ks] : pa_hi[ks],
                        desc_sw128((part == 1 ? vt_lo : vt_hi) + (ks / 4) * L::kTBox +
                                       (ks % 4) * 32,
                                   16, 1024),
                        part > 0 || ks > 0);
      wgmma_commit();
      const bool more = j + 1 < nl;
      if constexpr (L::kSets == 2) {
        // the next tile's split runs while P.V is on the tensor cores
        if (more) split_tile(j + 1);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      fence_operand(tmp);
      // O = O * alpha + the tile's sum, rounded to nearest once
#pragma unroll
      for (int i = 0; i < kO; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], tmp[i]);
      __syncthreads();  // tile j's stage and V^T set are free
      if (tid == 0 && j + kStages < nl) load_kv(j + kStages);
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
  if (!q_split) mbar_wait(bar_q, 0);  // Q's load lands before the block exits

  float den[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) den[hh] = fmaxf(quad_sum(l[hh]), 1e-30f);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = row0 + 8 * hh;
    if (qp >= p.Sq) continue;
    float* orow = p.o + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * p.D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + col0;
      if (c < p.D)
        *reinterpret_cast<float2*>(orow + c) =
            make_float2(acc[4 * i + 2 * hh] / den[hh], acc[4 * i + 2 * hh + 1] / den[hh]);
    }
    if (lane % 4 == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qp] =
          (m[hh] == -INFINITY ? kNegInf : m[hh] * p.scale) + logf(den[hh]);
  }
}

template <int DP>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, cudaStream_t stream) {
  const int smem = Layout<DP>::bytes(p.round);
  cudaError_t err = cudaFuncSetAttribute(flashmask_fwd_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.Sq + kM - 1) / kM, p.B);
  flashmask_fwd_tf32_kernel<DP><<<grid, kThreadsTC, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// The arguments of paddle_flashmask_fwd_sm90 (flashmask_fwd_sm90.cu), tiles
// included. dtype must be 0 (float32), D one of 16, 32, 64, 128, and every
// stride of q, k, v a multiple of 4 elements with a 16-byte aligned base
// (TMA). o is a contiguous [B, Sq, H, D] f32 tensor, lse a contiguous
// [B, H, 1, Sq] f32 tensor. Returns the cudaError_t of the launch (0 on
// success), or sm90::kErrTensorMap when a tensor map cannot be encoded.
extern "C" int paddle_flashmask_fwd_tf32(const void* q, const void* k, const void* v,
                                         const void* idx, void* o, void* lse, void* tiles,
                                         int dtype, int B, int Sq, int Sk, int H, int D, int Hm,
                                         int ncol, long long q_sb, long long q_ss, long long q_sh,
                                         long long k_sb, long long k_ss, long long k_sh,
                                         long long v_sb, long long v_ss, long long v_sh,
                                         int causal, float scale, void* stream) {
  if (dtype != 0 || (D != 16 && D != 32 && D != 64 && D != 128) || B < 1 || Sq < 1 || Sk < 1 ||
      H < 1 || (Hm != 1 && Hm != H) || (ncol != 1 && ncol != 2 && ncol != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kn = D <= 64 ? Layout<64>::kN : Layout<128>::kN;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd_f32(&tq, q, B, Sq, H, D, q_sb, q_ss, q_sh, kM) ||
      !encode_bshd_f32(&tk, k, B, Sk, H, D, k_sb, k_ss, k_sh, kn) ||
      !encode_bshd_f32(&tv, v, B, Sk, H, D, v_sb, v_ss, v_sh, kn))
    return kErrTensorMap;
  Params p;
  p.idx = static_cast<const int*>(idx);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
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
  p.round = min((Sk + kn - 1) / kn, (232448 - fixed) / 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D <= 64 ? launch<64>(tq, tk, tv, p, s) : launch<128>(tq, tk, tv, p, s);
  return static_cast<int>(err);
}
