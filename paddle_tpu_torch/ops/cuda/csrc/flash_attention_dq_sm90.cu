// Flash-attention dQ pass on Hopper's tensor cores (sm_90a): K2 for
// bfloat16 and float16 inputs (one instantiation each over the element
// type T). The float32 dQ pass is flash_attention_dq_tf32.cu
// (3xTF32).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel (:142,
// launched by _flash_bwd, :310): dQ = scale * sum_k dS . K, with
// P = exp(q.k^T * scale - lse) recomputed per tile from the forward's row
// logsumexp, dP' = dO . V^T (times keep/(1-p) under dropout) and
// dS = P o (dP' - Delta), Delta = rowsum(dO o O) computed by the wrapper in
// f32 as [B, H, 1, Sq]. It keeps the f32 K2's contract: layout
// [B, S, H, D] through per-tensor strides (here TMA tensor maps: a 16-byte
// aligned base and strides that are multiples of 16 bytes, which the
// wrapper guarantees by copying any other input); top-left causal, the
// k tiles past a block's diagonal not loaded; any Sq, Sk, out-of-range rows
// and columns with P = 0 exactly; dropout replaying the forward's mask (the
// Pallas _dropout_mask hash over the PALLAS tiles,
// flash_attention_common.cuh); dq contiguous [B, Sq, H, D] in T.
//
// Design: flash_attention_fwd_sm90.cu's block. One block per (128-row q
// tile, head, batch), heaviest causal tiles first; two consumer warpgroups
// of 64 rows and one producer warp whose elected thread brings Q and dO in
// once and streams the 64-row K and V tiles through a ring of kStages
// stages by TMA on mbarriers (sm90_common.cuh). Per K/V tile each consumer
// warpgroup
//   1. computes S = Q.K^T and dP = dO.V^T with wgmma (m64n64k16, all four
//      operands K-major from shared memory), T in, f32 sums;
//   2. forms P = 2^(S * scale * log2(e) - lse * log2(e)) (one FFMA and one
//      ex2 a score) and dS = P o (dP' - Delta) in the accumulator
//      registers, lse and Delta held per row;
//   3. rounds dS to T in registers, the register A operand as it stands,
//      and adds dS.K to dQ with wgmma (m64nDk16, the same K tile read
//      MN-major through the transpose bit).
// Step 1 of tile j + 1 and step 3 of tile j are issued together, and step 2
// of tile j + 1 runs while dS.K of tile j is still on the tensor cores
// (FlashAttention-3's order inside a warpgroup); the bits are those of
// waiting on each product in turn. dq is scaled once and written from
// registers.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 or fp16 tensor cores, 3.35 TB/s HBM):
// at the Llama training shape B=4, S=2048, H=12, D=64, causal, three
// products over the 2.1M kept (q, k) pairs of each of 48 heads are
// 38.7 GFLOP, 0.039 ms; q, k, v, dO, dq, lse and Delta move 63.7 MB,
// 0.019 ms: bound by operations. At the GPT-2-small training shape B=8,
// S=1024: 19.3 GFLOP, 0.0196 ms, against the same 63.7 MB, 0.019 ms. At
// about 150 registers a thread one block fits on an SM (two would need 96,
// and spill), so the overlap inside a warpgroup is what keeps the tensor
// cores busy while dS is formed; what is left is the exp2 of every score
// and one wait a tile on the products.

#include "flash_attention_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace paddle_fa;
using namespace sm90;

constexpr int kM = 128;  // q rows per block: two consumer warpgroups of 64
constexpr int kN = 64;   // keys per K/V tile
constexpr int kConsumers = 256;
constexpr int kThreadsTC = kConsumers + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* lse;    // [B, H, 1, Sq]
  const float* delta;  // [B, H, 1, Sq]
  void* dq;  // T
  int B, Sq, Sk, H, D;
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
  DropoutArgs drop;
};

// shared memory in bytes from a 1024-byte aligned base: the Q and dO
// tiles, kStages K tiles, kStages V tiles, then the mbarriers (Q and dO,
// kStages full, kStages empty). TMA runs up to kStages - 1 K/V tiles ahead:
// 3 at D <= 64 (96 KB), 2 at D = 128 (160 KB)
template <int DP>
struct Layout {
  static constexpr int kStages = DP <= 64 ? 4 : 3;
  static constexpr int kBoxes = DP / 64;  // 64-column boxes in a row
  static constexpr int kQBox = kM * 128;
  static constexpr int kKVBox = kN * 128;
  static constexpr int kKV = kBoxes * kKVBox;
  static constexpr int kO = kBoxes * kQBox;  // dO
  static constexpr int kK = 2 * kBoxes * kQBox;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBar = kV + kStages * kKV;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

template <typename T, int DP, bool kDropout>
__global__ void __launch_bounds__(kThreadsTC, 1)
    dq_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const Params p) {
  using L = Layout<DP>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sq = base, so = base + L::kO, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  int n_kt = (p.Sk + kN - 1) / kN;
  if (p.causal) n_kt = min(n_kt, (q0 + kM - 1) / kN + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp; one thread issues every load
    if (tid == kConsumers) {
      mbar_arrive_expect_tx(bar_q, 2 * L::kBoxes * L::kQBox);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(sq + c * L::kQBox, &tq, bar_q, 64 * c, h, q0, b);
        tma_load_4d(so + c * L::kQBox, &tdo, bar_q, 64 * c, h, q0, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(bar_empty + 8 * s, (j / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_arrive_expect_tx(full, 2 * L::kKV);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(sk + s * L::kKV + c * L::kKVBox, &tk, full, 64 * c, h, j * kN, b);
          tma_load_4d(sv + s * L::kKV + c * L::kKVBox, &tv, full, 64 * c, h, j * kN, b);
        }
      }
    }
    return;
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
  uint32_t rkey[2] = {0u, 0u};
  int rin[2] = {0, 0};
  const uint32_t head =
      kDropout ? head_key(static_cast<uint32_t>(*p.drop.seed), b, h) : 0u;
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

  constexpr int kO = DP / 2;  // dQ accumulator registers (m64 x DP)
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  const uint32_t qa = sq + wg * 64 * 128;  // this warpgroup's 64 rows of Q and dO
  const uint32_t oa = so + wg * 64 * 128;

  // FA3's order inside a warpgroup: while the products of tile j + 1's S
  // and dP and of tile j's dS.K run, dS of tile j + 1 is formed; acc and da
  // are touched only when no product is in flight
  float sc[32], dp[32];
  uint32_t da[4][4];
  auto issue_sdp = [&](int j) {
    const uint32_t kb = sk + (j % kStages) * L::kKV;
    const uint32_t vb = sv + (j % kStages) * L::kKV;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n64k16_ss<T>(sc, desc_sw128(qa + (kk / 4) * L::kQBox + (kk % 4) * 32, 16, 1024),
                         desc_sw128(kb + (kk / 4) * L::kKVBox + (kk % 4) * 32, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n64k16_ss<T>(dp, desc_sw128(oa + (kk / 4) * L::kQBox + (kk % 4) * 32, 16, 1024),
                         desc_sw128(vb + (kk / 4) * L::kKVBox + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
  };
  auto form_ds = [&](int j) {
    const int k0 = j * kN;
    // dS = P o (dP' - Delta) in place of S; P is masked only in a tile that
    // meets the ragged edge or the causal diagonal
    const bool edge = k0 + kN > p.Sk || (p.causal && k0 + kN - 1 > q0 + 64 * wg);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * i + 2 * hh + e;
          const int kp = k0 + 8 * i + col0 + e;
          float pj = ex2(fmaf(sc[idx], p.scale_log2, -lse2[hh]));
          if (edge && (kp >= p.Sk || (p.causal && row0 + 8 * hh < kp))) pj = 0.f;
          float dpj = dp[idx];
          if constexpr (kDropout) {
            const int ik = kp / p.drop.block_k;
            dpj = keep_bit(rkey[hh], ik, rin[hh], kp - ik * p.drop.block_k, p.drop.thresh)
                      ? dpj / p.drop.keep_prob
                      : 0.f;
          }
          sc[idx] = pj * (dpj - delta[hh]);
        }

  };

  mbar_wait(bar_full, 0);
  fence_operand(sc);
  fence_operand(dp);
  wgmma_fence();
  issue_sdp(0);
  wgmma_wait<0>();
  fence_operand(sc);
  fence_operand(dp);
  form_ds(0);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) pack_a<T>(da[ks], sc, ks);
  for (int j = 0; j < n_kt; ++j) {
    const bool more = j + 1 < n_kt;
    if (more) mbar_wait(bar_full + 8 * ((j + 1) % kStages), ((j + 1) / kStages) & 1);
    fence_operand(acc);
    fence_operand(sc);
    fence_operand(dp);
    wgmma_fence();
    if (more) issue_sdp(j + 1);
    const uint32_t kb = sk + (j % kStages) * L::kKV;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs<T>(acc, da[ks], desc_sw128(kb + ks * 2048, L::kKVBox, 1024));
    wgmma_commit();
    if (more) {
      wgmma_wait<1>();
      fence_operand(sc);
      fence_operand(dp);
      form_ds(j + 1);
    }
    wgmma_wait<0>();
    fence_operand(acc);
    mbar_arrive(bar_empty + 8 * (j % kStages));
    if (more) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) pack_a<T>(da[ks], sc, ks);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = row0 + 8 * hh;
    if (qp >= p.Sq) continue;
    T* row = static_cast<T*>(p.dq) + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * p.D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + col0;
      if (c < p.D)
        *reinterpret_cast<typename Elem<T>::T2*>(row + c) = Elem<T>::pack2(
            acc[4 * i + 2 * hh] * p.scale, acc[4 * i + 2 * hh + 1] * p.scale);
    }
  }
}

template <typename T, int DP, bool kDropout>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  constexpr int smem = Layout<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(dq_sm90_kernel<T, DP, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kM - 1) / kM, p.H, p.B);
  dq_sm90_kernel<T, DP, kDropout>
      <<<grid, kThreadsTC, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <typename T, bool kDropout>
cudaError_t launch_d(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  return p.D <= 64 ? launch<T, 64, kDropout>(maps, p, stream)
                   : launch<T, 128, kDropout>(maps, p, stream);
}

template <typename T>
cudaError_t launch_t(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  return p.drop.on ? launch_d<T, true>(maps, p, stream) : launch_d<T, false>(maps, p, stream);
}

}  // namespace

// The arguments of paddle_flash_attention_bwd_dkv_tf32
// (flash_attention_dkv_tf32.cu);
// dk and dv are not touched. dtype must be 1 (bfloat16) or 2 (float16),
// D one of 16, 32, 64, 128, and every stride of q, k, v, dO a multiple of 8 elements with a
// 16-byte aligned base (TMA). Returns the cudaError_t of the launch (0 on
// success), or sm90::kErrTensorMap when a tensor map cannot be encoded.
extern "C" int paddle_flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* seed, void* dq, void* dk, void* dv, int dtype, int B, int Sq,
    int Sk, int H, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, float scale, int dropout_on,
    float keep_prob, uint32_t thresh, int block_q, int block_k, void* stream) {
  (void)dk;
  (void)dv;
  if ((dtype != 1 && dtype != 2) || (D != 16 && D != 32 && D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (block_q < 1 || block_k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType ty = dtype == 2 ? Elem<__half>::kTma : Elem<__nv_bfloat16>::kTma;
  CUtensorMap maps[4];
  if (!encode_bshd(&maps[0], q, B, Sq, H, D, q_sb, q_ss, q_sh, kM, ty) ||
      !encode_bshd(&maps[1], k, B, Sk, H, D, k_sb, k_ss, k_sh, kN, ty) ||
      !encode_bshd(&maps[2], v, B, Sk, H, D, v_sb, v_ss, v_sh, kN, ty) ||
      !encode_bshd(&maps[3], dout, B, Sq, H, D, o_sb, o_ss, o_sh, kM, ty))
    return kErrTensorMap;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
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
  const cudaError_t err =
      dtype == 2 ? launch_t<__half>(maps, p, s) : launch_t<__nv_bfloat16>(maps, p, s);
  return static_cast<int>(err);
}
