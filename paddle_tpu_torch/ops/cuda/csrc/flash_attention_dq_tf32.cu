// Flash-attention dQ pass on Hopper's tensor cores (sm_90a) in 3xTF32: K2
// for float32 inputs. bfloat16 runs on flash_attention_dq_sm90.cu; K3
// (dK/dV) in float32 stays on flash_attention_bwd.cu.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel (:142,
// launched by _flash_bwd, :310): dQ = scale * sum_k dS . K, with
// P = exp(q.k^T * scale - lse) recomputed per tile from the forward's row
// logsumexp, dP' = dO . V^T (times keep/(1-p) under dropout) and
// dS = P o (dP' - Delta), Delta = rowsum(dO o O) computed by the wrapper in
// f32 as [B, H, 1, Sq]. It keeps the bf16 K2's contract: layout
// [B, S, H, D] through TMA tensor maps over per-tensor strides (a 16-byte
// aligned base and strides that are multiples of 16 bytes, which the
// wrapper guarantees by copying any other input); top-left causal, the
// k tiles past a block's diagonal not loaded; any Sq, Sk, out-of-range rows
// and columns with P = 0 exactly; dropout replaying the forward's mask (the
// Pallas _dropout_mask hash over the PALLAS tiles,
// flash_attention_common.cuh); dq contiguous [B, Sq, H, D] in f32.
//
// Arithmetic: every product in three TF32 products, a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, summed in f32 (sm90_tf32.cuh), as in the f32 K1.
//
// Design. One block per (kM-row q tile, head, batch); the heads vary
// fastest in the grid, so every head's heaviest causal tile is launched
// before any lighter one, which balances the SMs' load better than
// heaviest first within each head alone. One warpgroup per 64 rows, no
// producer warp. Thread 0 brings Q and dO in once and streams 32-key K and
// V tiles through a ring of kStages stages by TMA, issuing tile
// j + kStages once tile j is done. Q and dO are split into hi and lo tiles
// once. Per K/V tile:
//   1. all threads split the tile: K's and V's hi in place, and a split set
//      of K's and V's lo and K written transposed in hi and lo parts (keys
//      in the order of sm90_tf32.cuh), since TF32 wgmma takes K-major
//      operands only and K is the B operand of dS.K; fence.proxy.async and
//      a barrier hand the tiles to wgmma;
//   2. each warpgroup computes S = Q.K^T and dP = dO.V^T with wgmma
//      (m64n32k8, SS); under dropout the tile's keep bits are hashed while
//      the products run;
//   3. forms P = 2^(S * scale * log2(e) - lse * log2(e)) (one FFMA and one
//      ex2 a score) and dS = P o (dP' - Delta) in the accumulator
//      registers, lse and Delta held per row, as the bf16 K2 does;
//   4. splits dS into hi and lo A registers and adds dS.K to dQ with wgmma
//      (m64nDk8, RS, B = K^T).
// With two split sets (D <= 64), step 1 of tile j + 1 runs while step 4's
// products of tile j are on the tensor cores, and one barrier a tile hands
// over both. With one set and one stage (D = 128), the next tile's load
// starts once S and dP are done, and its split waits for dS.K. dq is
// scaled once and written from registers. D = 16 and 32 run as D = 64
// with zero columns.
//
// Shared memory (227 KB a block), 32-key tiles. D <= 64: 128-row blocks
// (two warpgroups); Q and dO hi + lo 128 KB, two stages of K + V 32 KB,
// two split sets 64 KB: 224 KB. D = 128: 128-row blocks would need 256 KB
// for Q and dO alone, so the block has 64 rows (one warpgroup): Q and dO
// hi + lo 128 KB, one stage of K + V 32 KB, one split set 64 KB: 224 KB.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, so 165 TFLOP/s for three
// products; 3.35 TB/s HBM): at the GPT-2-small training shape B=8, S=1024,
// H=12, D=64, causal, three products over the 525k kept (q, k) pairs of
// each of 96 heads are 19.35 GFLOP, 0.117 ms; q, k, v, dO, dq, lse and
// Delta move 127 MB, 0.038 ms: bound by operations. What this design
// leaves on the table: the narrow m64n32k8 products of S and dP, which
// read their A tile from shared memory each time (a 64-key tile would not
// fit beside Q and dO's hi and lo), the split of every K/V tile by every
// block that reads it, and at D = 128 a single warpgroup on an SM.

#include "flash_attention_common.cuh"
#include "sm90_tf32.cuh"

namespace {

using namespace paddle_fa;
using namespace sm90;

constexpr int kN = 32;  // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* lse;    // [B, H, 1, Sq]
  const float* delta;  // [B, H, 1, Sq]
  float* dq;
  int B, Sq, Sk, H, D;
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
  DropoutArgs drop;
};

// shared memory in bytes from a 1024-byte aligned base: Q hi, Q lo, dO hi,
// dO lo, then kStages stages of a K tile and a V tile (their hi after the
// split), then kSets sets of K lo, V lo, K^T hi and K^T lo, then the
// mbarriers (Q and dO, kStages full)
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
  static constexpr int kBytes = kBar + 8 * (1 + kStages) + 1024;  // + alignment slack
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

template <int DP, bool kDropout>
__global__ void __launch_bounds__(Layout<DP>::kThreads, 1)
    dq_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const Params p) {
  using L = Layout<DP>;
  constexpr int kM = L::kM;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem[];
  uint8_t* const sm = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;

  // heads vary fastest, so every head's heaviest causal tile runs first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  int n_kt = (p.Sk + kN - 1) / kN;
  if (p.causal) n_kt = min(n_kt, (q0 + kM - 1) / kN + 1);

  auto load_kv = [&](int j) {
    const int s = j % kStages;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t kb = base + L::kStage + s * 2 * L::kKV;
    mbar_arrive_expect_tx(full, 2 * L::kKV);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(kb + c * L::kKVBox, &tk, full, 32 * c, h, j * kN, b);
      tma_load_4d(kb + L::kKV + c * L::kKVBox, &tv, full, 32 * c, h, j * kN, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar_q, 2 * L::kQ);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(base + c * L::kQBox, &tq, bar_q, 32 * c, h, q0, b);
      tma_load_4d(base + 2 * L::kQ + c * L::kQBox, &tdo, bar_q, 32 * c, h, q0, b);
    }
    for (int j = 0; j < min(kStages, n_kt); ++j) load_kv(j);
  }
  __syncthreads();

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;

  // lse * log2(e) and Delta of this thread's rows; 0 past Sq, where Q and dO
  // are zero-filled, so S = dP = 0 and dS = 0 there
  float lse2[2], delta[2];
  uint32_t rkey[2] = {0u, 0u};
  int rin[2] = {0, 0};
  const uint32_t head = kDropout ? head_key(static_cast<uint32_t>(*p.drop.seed), b, h) : 0u;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = row0 + 8 * hh;
    lse2[hh] = qp < p.Sq ? p.lse[rows + qp] * kLog2e : 0.f;
    delta[hh] = qp < p.Sq ? p.delta[rows + qp] : 0.f;
    if constexpr (kDropout) {
      const int iq = qp / p.drop.block_q;
      rkey[hh] = row_key(head, iq);
      rin[hh] = qp - iq * p.drop.block_q;
    }
  }

  // step 1 of the note for tile j, into its stage and split set
  auto split_tile = [&](int j) {
    const int kb_off = L::kStage + (j % kStages) * 2 * L::kKV;
    mbar_wait(bar_full + 8 * (j % kStages), (j / kStages) & 1);
    split_kv<DP>(sm + kb_off, sm + kb_off + L::kKV, sm + L::kSet + (j % L::kSets) * L::kSetBytes,
                 tid);
  };
  mbar_wait(bar_q, 0);
  split_in_place(sm, sm + L::kQ, L::kQ, tid, L::kThreads);
  split_in_place(sm + 2 * L::kQ, sm + 3 * L::kQ, L::kQ, tid, L::kThreads);
  split_tile(0);
  fence_proxy_async();
  __syncthreads();
  const uint32_t q_hi = base + wg * 64 * 128;  // this warpgroup's 64 rows of Q and dO
  const uint32_t q_lo = q_hi + L::kQ;
  const uint32_t o_hi = q_hi + 2 * L::kQ;
  const uint32_t o_lo = q_hi + 3 * L::kQ;

  constexpr int kO = DP / 2;  // dQ accumulator registers (m64 x DP)
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kN;
    const uint32_t k_hi = base + L::kStage + (j % kStages) * 2 * L::kKV, v_hi = k_hi + L::kKV;
    const uint32_t k_lo = base + L::kSet + (j % L::kSets) * L::kSetBytes, v_lo = k_lo + L::kKV;
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
    // dropout: this tile's keep bits (bit 4i + 2hh + e of keep, as sc's
    // index), hashed while S and dP are on the tensor cores
    uint32_t keep = 0u;
    if constexpr (kDropout) {
#pragma unroll
      for (int i = 0; i < kN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * i + col0 + e;
          const int ik = kp / p.drop.block_k;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            if (keep_bit(rkey[hh], ik, rin[hh], kp - ik * p.drop.block_k, p.drop.thresh))
              keep |= 1u << (4 * i + 2 * hh + e);
        }
    }
    wgmma_wait<0>();
    fence_operand(sc);
    fence_operand(dp);
    const bool more = j + 1 < n_kt;
    if constexpr (kStages == 1) {
      // one warpgroup, one stage: S and dP were the stage's last readers,
      // so the next tile loads while dS and dS.K run
      __syncthreads();
      if (tid == 0 && more) load_kv(j + 1);
    }

    // dS = P o (dP' - Delta) in place of S; P is masked only in a tile that
    // meets the ragged edge or the causal diagonal
    const bool edge = k0 + kN > p.Sk || (p.causal && k0 + kN - 1 > q0 + 64 * wg);
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * i + 2 * hh + e;
          const int kp = k0 + 8 * i + col0 + e;
          float pj = ex2(fmaf(sc[idx], p.scale_log2, -lse2[hh]));
          if (edge && (kp >= p.Sk || (p.causal && row0 + 8 * hh < kp))) pj = 0.f;
          float dpj = dp[idx];
          if constexpr (kDropout) dpj = (keep >> idx) & 1u ? dpj / p.drop.keep_prob : 0.f;
          sc[idx] = pj * (dpj - delta[hh]);
        }

    uint32_t da_hi[kN / 8][4], da_lo[kN / 8][4];
#pragma unroll
    for (int ks = 0; ks < kN / 8; ++ks) pack_a_tf32(da_hi[ks], da_lo[ks], sc, ks);
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part)  // dS_lo.K_hi, dS_hi.K_lo, dS_hi.K_hi
#pragma unroll
      for (int ks = 0; ks < kN / 8; ++ks)
        wgmma_tf32_rs(acc, part == 0 ? da_lo[ks] : da_hi[ks],
                      desc_sw128((part == 1 ? kt_lo : kt_hi) + ks * 32, 16, 1024));
    wgmma_commit();
    if constexpr (L::kSets == 2) {
      // the next tile's split runs while dS.K is on the tensor cores
      if (more) split_tile(j + 1);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_operand(acc);
    __syncthreads();  // tile j's stage and split set are free
    if (kStages > 1 && tid == 0 && j + kStages < n_kt) load_kv(j + kStages);
    if constexpr (L::kSets == 1) {
      if (more) {
        split_tile(j + 1);
        fence_proxy_async();
        __syncthreads();
      }
    }
  }

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

template <int DP, bool kDropout>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  using L = Layout<DP>;
  cudaError_t err = cudaFuncSetAttribute(dq_tf32_kernel<DP, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.Sq + L::kM - 1) / L::kM, p.B);
  dq_tf32_kernel<DP, kDropout>
      <<<grid, L::kThreads, L::kBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <bool kDropout>
cudaError_t launch_d(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  return p.D <= 64 ? launch<64, kDropout>(maps, p, stream) : launch<128, kDropout>(maps, p, stream);
}

}  // namespace

// The arguments of paddle_flash_attention_bwd_dkv (flash_attention_bwd.cu);
// dk and dv are not touched. dtype must be 0 (float32), D one of 16, 32,
// 64, 128, and every stride of q, k, v, dO a multiple of 4 elements with a
// 16-byte aligned base (TMA). dq is a contiguous [B, Sq, H, D] f32 tensor.
// Returns the cudaError_t of the launch (0 on success), or
// sm90::kErrTensorMap when a tensor map cannot be encoded.
extern "C" int paddle_flash_attention_bwd_dq_tf32(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* seed, void* dq, void* dk, void* dv, int dtype, int B, int Sq,
    int Sk, int H, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, float scale, int dropout_on,
    float keep_prob, uint32_t thresh, int block_q, int block_k, void* stream) {
  (void)dk;
  (void)dv;
  if (dtype != 0 || (D != 16 && D != 32 && D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (block_q < 1 || block_k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int km = D <= 64 ? Layout<64>::kM : Layout<128>::kM;
  CUtensorMap maps[4];
  if (!encode_bshd_f32(&maps[0], q, B, Sq, H, D, q_sb, q_ss, q_sh, km) ||
      !encode_bshd_f32(&maps[1], k, B, Sk, H, D, k_sb, k_ss, k_sh, kN) ||
      !encode_bshd_f32(&maps[2], v, B, Sk, H, D, v_sb, v_ss, v_sh, kN) ||
      !encode_bshd_f32(&maps[3], dout, B, Sq, H, D, o_sb, o_ss, o_sh, km))
    return kErrTensorMap;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.D = D;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.drop.seed = static_cast<const int*>(seed);
  p.drop.on = dropout_on;
  p.drop.keep_prob = keep_prob;
  p.drop.thresh = thresh;
  p.drop.block_q = block_q;
  p.drop.block_k = block_k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dropout_on ? launch_d<true>(maps, p, s) : launch_d<false>(maps, p, s);
  return static_cast<int>(err);
}
