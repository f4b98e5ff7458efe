// FlashMask forward on Hopper's tensor cores (sm_90a): K5 for bfloat16
// inputs. The float32 K5 is flashmask_fwd_tf32.cu; the bfloat16 K6 and K7
// are flashmask_dq_sm90.cu and flashmask_dkv_sm90.cu.
//
// Replaces paddle_tpu/ops/pallas/flashmask.py::_fm_fwd_kernel (:52,
// launched by _fm_fwd, :209, call :222): attention under the column-interval
// mask of startend_row_indices [B, Hm, Sk, ncol] int32 (contiguous, Hm = 1
// broadcast over the heads), in the layouts of _tile_mask (:32): causal
// ncol 1, rows >= LTS hidden; causal ncol 2, rows in [LTS, LTE) hidden;
// non-causal ncol 4, rows in [LTS, LTE) or [UTS, UTE) hidden; causal adds
// rows < column (top-left). Its contract:
//   - layout [B, S, H, D] through per-tensor strides, here TMA tensor maps
//     (a 16-byte aligned base and strides that are multiples of 16 bytes,
//     which the wrapper guarantees by copying any other input);
//   - hidden scores are SELECTED to -inf before the row max, never
//     multiplied by a 0/1 mask, so a row that sees no key keeps m = -inf,
//     gets p = 2^-inf = 0 everywhere and ends with O = 0 exactly and
//     lse = -1e30 + log(1e-30), as the Pallas kernel does;
//   - any Sq, Sk: TMA fills the rows past the end (and the columns past D
//     when D < 64) with zeros, and the scores there are masked;
//   - O in bf16 [B, Sq, H, D], lse f32 [B, H, 1, Sq]; no dropout (the
//     Pallas kernel has none).
//
// Design: flash_attention_fwd_sm90.cu's block (one block per (128-row q
// tile, head, batch), heaviest causal tiles first; two consumer warpgroups
// of 64 rows, one producer warp, a ring of kStages K/V stages filled by
// TMA on mbarriers, S = Q.K^T and O += P.V with wgmma, the online softmax
// in exp2 on the accumulator registers, P rounded to bf16 as the register
// A operand) with FlashMask's mask:
//   - before the loop, all 288 threads read the key columns' intervals up
//     to the causal bound (flashmask_sm90_common.cuh, shared with K6 and
//     K7) and decide, for each 64-key tile, whether any of
//     its columns lets a row of the block's [q0, q_last] through (a "live"
//     tile: the first allowed row at or after q0, found by jumping past the
//     causal bound and the two intervals, is at most q_last) and whether
//     any column's intervals meet those rows at all (a "partial" tile).
//     One warp compacts the live tiles into a list in shared memory, so the
//     producer and the consumers walk the same list: a dead tile is neither
//     loaded nor computed, and the skip drops no allowed pair;
//   - the producer's lanes write each live tile's 64 columns as two
//     [start, end) intervals into its stage beside the K and V boxes;
//   - a consumer thread tests its elements against their columns' intervals
//     only in a partial tile, and against the ragged edge and the causal
//     diagonal only in a tile that meets them, as K1 does.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 3.35 TB/s HBM),
// counted over the (q, k) pairs the mask allows, N: two products, 4 D N
// flops a head, against q, k, v, o, lse and the indices read or written
// once. At the FlashMask path of chip_smoke.py (B=1, S=8192, 32 heads,
// D=128, causal documents, 10.5M allowed pairs a head) that is 0.17 ms of
// operations against 0.08 ms of bytes: bound by operations. A 128-row
// block skips a k tile only where none of its 128 rows sees it, so it
// visits more tiles at document edges than 64-row tiles would.

#include "flash_attention_common.cuh"
#include "flashmask_sm90_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace fm90;
using namespace paddle_fa;
using namespace sm90;

constexpr int kM = 128;  // q rows per block: two consumer warpgroups of 64
constexpr int kN = 64;   // keys per K/V tile
constexpr int kStages = 4;  // K/V tiles in flight: TMA runs up to 3 tiles ahead
constexpr int kConsumers = 256;
constexpr int kThreadsTC = kConsumers + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const int* idx;  // [B, Hm, Sk, ncol]
  __nv_bfloat16* o;
  float* lse;
  int* tiles;  // null, or (live tiles, tiles within the causal bound) summed over blocks
  int B, Sq, Sk, H, D, Hm, ncol;
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// shared memory in bytes from a 1024-byte aligned base: the Q tile, kStages
// K tiles, kStages V tiles, kStages interval slabs (64 columns x int4), the
// mbarriers (Q, kStages full, kStages empty), then the live-tile count, a
// flag and a list entry for each k tile (kFixed + 8 bytes a k tile in all)
template <int DP>
struct Layout {
  static constexpr int kBoxes = DP / 64;  // 64-column boxes in a row
  static constexpr int kQBox = kM * 128;
  static constexpr int kKVBox = kN * 128;
  static constexpr int kKV = kBoxes * kKVBox;
  static constexpr int kK = kBoxes * kQBox;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kI = kV + kStages * kKV;
  static constexpr int kBar = kI + kStages * kN * 16;
  static constexpr int kList = kBar + 8 * (1 + 2 * kStages) + 16;
  static constexpr int kFixed = kList + 16 + 1024;  // + alignment slack
  static int bytes(int n_kt) { return kFixed + 8 * n_kt; }
};

template <int DP>
__global__ void __launch_bounds__(kThreadsTC, 1)
    flashmask_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - smem_u32(smem));
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  int4* sI = reinterpret_cast<int4*>(gbase + L::kI);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  int* n_live = reinterpret_cast<int*>(gbase + L::kList);
  int* flags = n_live + 4;  // bit 0: live, bit 1: partial
  int* list = flags + (p.Sk + kN - 1) / kN;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;  // heaviest causal tiles first
  const int q_last = min(q0 + kM, p.Sq) - 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp_id = tid / 32;
  int n_kt = (p.Sk + kN - 1) / kN;
  if (p.causal) n_kt = min(n_kt, (q0 + kM - 1) / kN + 1);
  const int* idx = p.idx + (static_cast<long long>(b) * p.Hm + (p.Hm > 1 ? h : 0)) * p.Sk * p.ncol;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA transaction's arrival, then one from each producer lane
      // after it wrote the stage's intervals
      mbar_init(bar_full + 8 * s, 1 + 32);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  for (int t = tid; t < n_kt; t += kThreadsTC) flags[t] = 0;
  __syncthreads();

  // the live and partial k tiles (flashmask_sm90_common.cuh)
  mark_k_tiles<kThreadsTC>(idx, p.ncol, p.Sk, q0, q_last, p.causal, n_kt, flags, tid);
  __syncthreads();
  if (warp_id == 0) compact_live(flags, n_kt, 0, list, n_live, p.tiles, tid);
  __syncthreads();
  const int nl = *n_live;

  if (tid >= kConsumers) {  // the producer warp
    const int lane = tid - kConsumers;
    if (lane == 0 && nl > 0) {
      mbar_arrive_expect_tx(bar_q, L::kBoxes * L::kQBox);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(sq + c * L::kQBox, &tq, bar_q, 64 * c, h, q0, b);
    }
    for (int j = 0; j < nl; ++j) {
      const int s = j % kStages;
      const int k0 = (list[j] & kTile) * kN;
      if (j >= kStages) mbar_wait(bar_empty + 8 * s, (j / kStages - 1) & 1);
      const uint32_t full = bar_full + 8 * s;
      if (lane == 0) {
        mbar_arrive_expect_tx(full, 2 * L::kKV);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(sk + s * L::kKV + c * L::kKVBox, &tk, full, 64 * c, h, k0, b);
          tma_load_4d(sv + s * L::kKV + c * L::kKVBox, &tv, full, 64 * c, h, k0, b);
        }
      }
      for (int c = lane; c < kN; c += 32) sI[s * kN + c] = column(idx, p.ncol, k0 + c, p.Sk);
      mbar_arrive(full);
    }
    return;
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);

  constexpr int kO = DP / 2;  // O accumulator registers (m64 x DP)
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;
  // running max of the raw scores (-inf until a row sees a key) and this
  // thread's part of the row sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  if (nl > 0) mbar_wait(bar_q, 0);
  const uint32_t qa = sq + wg * 64 * 128;  // this warpgroup's 64 rows of Q

  for (int j = 0; j < nl; ++j) {
    const int s = j % kStages;
    const int entry = list[j];
    const int k0 = (entry & kTile) * kN;
    const bool partial = entry & kPartial;
    const uint32_t kb = sk + s * L::kKV;
    const uint32_t vb = sv + s * L::kKV;
    const int4* iv = sI + s * kN;
    mbar_wait(bar_full + 8 * s, (j / kStages) & 1);

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_operand(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n64k16_ss(sc, desc_sw128(qa + (kk / 4) * L::kQBox + (kk % 4) * 32, 16, 1024),
                         desc_sw128(kb + (kk / 4) * L::kKVBox + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);

    // hide what the intervals hide (only in a partial tile), the ragged
    // edge and the causal diagonal (only in a tile that meets them); row max
    const bool edge = k0 + kN > p.Sk || (p.causal && k0 + kN - 1 > q0 + 64 * wg);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * i + col0 + e;
        const int kp = k0 + c;
        int4 civ = make_int4(0, 0, 0, 0);
        if (partial) civ = iv[c];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float& x = sc[4 * i + 2 * hh + e];
          const int r = row0 + 8 * hh;
          if ((edge && (kp >= p.Sk || (p.causal && r < kp))) || (partial && hidden(civ, r)))
            x = -INFINITY;
          mx[hh] = fmaxf(mx[hh], x);
        }
      }
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
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * i + 2 * hh + e];
          x = ex2(fmaf(x, p.scale_log2, -mscaled[hh]));
          l[hh] += x;
        }

    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) pack_a(pa[ks], sc, ks);
#pragma unroll
    for (int i = 0; i < kO; ++i) acc[i] *= alpha[(i >> 1) & 1];
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs(acc, pa[ks], desc_sw128(vb + ks * 2048, L::kKVBox, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    mbar_arrive(bar_empty + 8 * s);
  }

  float den[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) den[hh] = fmaxf(quad_sum(l[hh]), 1e-30f);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = row0 + 8 * hh;
    if (qp >= p.Sq) continue;
    __nv_bfloat16* orow = p.o + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * p.D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + col0;
      if (c < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(acc[4 * i + 2 * hh] / den[hh], acc[4 * i + 2 * hh + 1] / den[hh]);
    }
    if (lane % 4 == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qp] =
          (m[hh] == -INFINITY ? kNegInf : m[hh] * p.scale) + logf(den[hh]);
  }
}

template <int DP>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, cudaStream_t stream) {
  const int smem = Layout<DP>::bytes((p.Sk + kN - 1) / kN);
  if (smem > 232448) return cudaErrorInvalidValue;  // Sk past ~500k keys
  cudaError_t err = cudaFuncSetAttribute(flashmask_fwd_sm90_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kM - 1) / kM, p.H, p.B);
  flashmask_fwd_sm90_kernel<DP><<<grid, kThreadsTC, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements. idx is the contiguous [B, Hm, Sk, ncol] int32
// tensor of start/end rows (Hm in {1, H}, ncol in {1, 2, 4}); o a
// contiguous [B, Sq, H, D] bf16 tensor, lse a contiguous [B, H, 1, Sq] f32
// tensor; tiles null, or a zeroed int32 pair on the device to which each
// block adds its live k tiles and its k tiles within the causal bound.
// dtype must be 1 (bfloat16), D one of 16, 32, 64, 128, and every stride
// of q, k, v a multiple of 8 elements with a 16-byte aligned base (TMA).
// Returns the cudaError_t of the launch (0 on success), or
// sm90::kErrTensorMap when a tensor map cannot be encoded.
extern "C" int paddle_flashmask_fwd_sm90(const void* q, const void* k, const void* v,
                                         const void* idx, void* o, void* lse, void* tiles,
                                         int dtype, int B, int Sq, int Sk, int H, int D, int Hm,
                                         int ncol, long long q_sb, long long q_ss, long long q_sh,
                                         long long k_sb, long long k_ss, long long k_sh,
                                         long long v_sb, long long v_ss, long long v_sh,
                                         int causal, float scale, void* stream) {
  if (dtype != 1 || (D != 16 && D != 32 && D != 64 && D != 128) || B < 1 || Sq < 1 || Sk < 1 ||
      H < 1 || (Hm != 1 && Hm != H) || (ncol != 1 && ncol != 2 && ncol != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(&tq, q, B, Sq, H, D, q_sb, q_ss, q_sh, kM) ||
      !encode_bshd(&tk, k, B, Sk, H, D, k_sb, k_ss, k_sh, kN) ||
      !encode_bshd(&tv, v, B, Sk, H, D, v_sb, v_ss, v_sh, kN))
    return kErrTensorMap;
  Params p;
  p.idx = static_cast<const int*>(idx);
  p.o = static_cast<__nv_bfloat16*>(o);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D <= 64 ? launch<64>(tq, tk, tv, p, s) : launch<128>(tq, tk, tv, p, s);
  return static_cast<int>(err);
}
